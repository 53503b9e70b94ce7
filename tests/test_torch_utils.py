"""``enlsip_tpu_torch.utils`` against ``enlsip_tpu.utils`` (CPU).

* Checkpoints: round trips of a single solve (host ints come back as
  ints) and of a batch; the npz file as the interchange — a carry saved
  by ``enlsip_tpu`` (a short JAX batched run of HS65) loads into the port
  and resumes to the port's uninterrupted result (exit codes equal, f
  within 1e-10, x within 1e-8: the last line search runs on a merit flat
  to rounding, where the two packages' x differ by ~1e-9 also without a
  checkpoint, as in ``test_torch_batch.py``), and one saved by the port
  resumes in ``enlsip_tpu`` likewise; v1 migration,
  the wrong-leaf-count error, ``like=None``; a fused heterogeneous batch
  stopped, saved, loaded and resumed equals the uninterrupted run to the
  bit (the counterpart of ``tests/test_checkpoint.py``'s fused case,
  unsharded).
* ``guarded_functions`` names the function that returned a non-finite
  value, in a single solve and in a batch; ``first_nonfinite_report``.
* ``StageTimer`` counts; ``annotate`` and ``trace`` run on the CPU.
JAX compiles: the batched init and the batched chunk of HS65.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import enlsip_tpu_torch as et
from enlsip_tpu.core.types import Dims as JDims, Options as JOptions, \
    Tols as JTols
from enlsip_tpu.parallel.batch import _run_batch_chunk_jit
from enlsip_tpu.parallel.batch import finalize as j_finalize
from enlsip_tpu.parallel.batch import init_batch as j_init_batch
from enlsip_tpu.utils import load_carry as j_load, save_carry as j_save
from enlsip_tpu_torch.core.driver import init_carry, iterate_body
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.parallel import (finalize, fuse_families,
                                       hs_scenario_batch, init_batch,
                                       run_batch, solve_batched)
from enlsip_tpu_torch.problems.classic import HS65
from enlsip_tpu_torch.utils import (StageTimer, annotate, load_carry,
                                    save_carry, trace)
from enlsip_tpu_torch.utils.debug import (first_nonfinite_report,
                                          guarded_functions)

from torch_port_helpers import F64, hs65_batch_setup

B = 8
REL = float(np.sqrt(np.finfo(float).eps))
TOLS = Tols.for_dtype(F64)
DIMS = Dims(3, 3, 0, 7)


def _leaves(carry):
    return pytree.tree_leaves(carry)


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) == 34
    for u, v in zip(la, lb):
        assert type(u) is type(v)
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v)
        else:
            assert u == v


@pytest.fixture(scope="module")
def hs65():
    return hs65_batch_setup(B, seed=1)


# ------------------------------------------------------ round trips

def _single(tf, steps):
    c = init_carry(tf, HS65["starting_point"], DIMS, Options(), F64,
                   device="cpu")
    for _ in range(steps):
        c = iterate_body(c, tf, DIMS, Options(), TOLS)
    return c


def _finish_single(c, tf):
    while c.exit_code == 0:
        c = iterate_body(c, tf, DIMS, Options(), TOLS)
    return c


def test_single_solve_round_trip(hs65, tmp_path):
    tf = hs65[1]
    mid = _single(tf, 3)
    path = str(tmp_path / "single.npz")
    save_carry(path, mid)
    back = load_carry(path, like=mid)
    _assert_same(back, mid)
    assert isinstance(back.nb_iter, int) and back.nb_iter == 3
    assert isinstance(back.counters.nb_res, int)
    # like=None: the canonical structure, host ints as ints, int64 tensors
    canon = load_carry(path, device="cpu")
    assert isinstance(canon.exit_code, int) and canon.nb_iter == 3
    assert canon.prev.t.dtype == torch.int64
    _assert_same(canon, mid)
    # (a single solve writes its display rows in place, so finish last)
    a, b = _finish_single(mid, tf), _finish_single(back, tf)
    assert torch.equal(a.x, b.x) and a.exit_code == b.exit_code


def test_batch_round_trip(hs65, tmp_path):
    tf, starts = hs65[1], hs65[2]
    c = init_batch(tf, starts, DIMS, Options(), F64, device="cpu")
    mid = run_batch(c, tf, DIMS, Options(), TOLS, max_steps=3)
    path = str(tmp_path / "batch.npz")
    save_carry(path, mid)
    f = np.load(path)
    assert int(f["__format_version__"]) == 2
    assert f["leaf_33"].dtype == np.int32 and f["leaf_33"].shape == (B,)
    _assert_same(load_carry(path, like=mid), mid)
    _assert_same(load_carry(path, device="cpu"), mid)


def test_load_v1_format_migrates(hs65, tmp_path):
    mid = _single(hs65[1], 1)
    leaves = [np.asarray(l) for l in _leaves(mid)] + [np.asarray(False)]
    path = str(tmp_path / "v1.npz")
    np.savez(path, **{f"leaf_{i}": l for i, l in enumerate(leaves)})
    _assert_same(load_carry(path, like=mid), mid)


def test_load_wrong_leaf_count_errors(hs65, tmp_path):
    mid = _single(hs65[1], 1)
    leaves = [np.asarray(l) for l in _leaves(mid)][:-3]
    path = str(tmp_path / "bad.npz")
    np.savez(path, **{f"leaf_{i}": l for i, l in enumerate(leaves)})
    with pytest.raises(ValueError, match="incompatible"):
        load_carry(path, like=mid)


def test_load_without_like_needs_the_card_unless_asked(hs65, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    path = str(tmp_path / "s.npz")
    save_carry(path, _single(hs65[1], 0))
    with pytest.raises(RuntimeError, match="CUDA device"):
        load_carry(path)


# ---------------------------------------- interchange with enlsip_tpu

@pytest.fixture(scope="module")
def jax_batch(hs65):
    jf, _, starts, (n, m, q, l) = hs65
    jd, jo = JDims(n, m, q, l), JOptions()
    jt = JTols(*(jnp.float64(v) for v in (1e-10, REL, REL, REL, REL)))
    jc0 = j_init_batch(jf, jnp.asarray(starts), jd, jo, jnp.float64)
    run = lambda c, k: _run_batch_chunk_jit(c, jt, jnp.int32(k), (), None,
                                            jf, jd, jo)
    return jc0, run


def _port_uninterrupted(hs65):
    return solve_batched(hs65[1], hs65[2], DIMS, Options(), TOLS, dtype=F64,
                         device="cpu")


def test_jax_checkpoint_resumes_in_the_port(hs65, jax_batch, tmp_path):
    jc0, run = jax_batch
    path = str(tmp_path / "from_jax.npz")
    j_save(path, run(jc0, 3))
    tf, starts = hs65[1], hs65[2]
    like = init_batch(tf, starts, DIMS, Options(), F64, device="cpu")
    mid = load_carry(path, like=like)
    assert mid.nb_iter.dtype == torch.int64 and (mid.nb_iter == 3).all()
    out = finalize(run_batch(mid, tf, DIMS, Options(), TOLS))
    ref = _port_uninterrupted(hs65)
    assert torch.equal(out.exit_code, ref.exit_code)
    np.testing.assert_allclose(out.x.numpy(), ref.x.numpy(), rtol=1e-8)
    np.testing.assert_allclose(out.f.numpy(), ref.f.numpy(), rtol=1e-10)


def test_port_checkpoint_resumes_in_jax(hs65, jax_batch, tmp_path):
    jc0, run = jax_batch
    tf, starts = hs65[1], hs65[2]
    c = init_batch(tf, starts, DIMS, Options(), F64, device="cpu")
    path = str(tmp_path / "from_port.npz")
    save_carry(path, run_batch(c, tf, DIMS, Options(), TOLS, max_steps=3))
    mid = j_load(path, like=jc0)
    assert np.asarray(mid.nb_iter).dtype == np.int32
    out = j_finalize(run(mid, 100))
    ref = _port_uninterrupted(hs65)
    np.testing.assert_array_equal(np.asarray(out.exit_code),
                                  ref.exit_code.numpy())
    np.testing.assert_allclose(np.asarray(out.x), ref.x.numpy(), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(out.f), ref.f.numpy(), rtol=1e-10)


def test_fused_hetero_batch_resumes_to_the_bit(tmp_path):
    fams = hs_scenario_batch(["hs14", "hs65"], per_family=16, seed=0,
                             device="cpu")
    fs = fuse_families(fams, device="cpu")
    opts = Options(max_iter=40)
    c = init_batch(fs.fns, fs.x0, fs.dims, opts, F64, fs.data, fs.rdims,
                   device="cpu")
    mid = run_batch(c, fs.fns, fs.dims, opts, TOLS, max_steps=3,
                    data=fs.data, rdims=fs.rdims)
    path = str(tmp_path / "fused.npz")
    save_carry(path, mid)
    back = load_carry(path, like=mid)
    _assert_same(back, mid)
    go = lambda k: finalize(run_batch(k, fs.fns, fs.dims, opts, TOLS,
                                      data=fs.data, rdims=fs.rdims))
    a, b = go(mid), go(back)
    assert torch.equal(a.exit_code, b.exit_code) and (a.exit_code != 0).all()
    assert torch.equal(a.x, b.x) and torch.equal(a.f, b.f)
    assert torch.equal(a.n_iter, b.n_iter)
    for u, v in zip(a.counters, b.counters):
        assert torch.equal(u, v)


# ------------------------------------------------------------- debug

def _poisoned(tf, which):
    """``tf`` with one member returning NaN wherever x[0] > 0."""
    f = getattr(tf, which)

    def bad(x, *data):
        out = f(x, *data)
        return torch.where(x[0] > 0, torch.full_like(out, float("nan")), out)

    return tf._replace(**{which: bad})


@pytest.mark.parametrize("which,name", [("res", "residuals"),
                                        ("jac_cons", "jac_constraints")])
def test_guarded_functions_name_the_culprit(hs65, which, name):
    tf, starts = hs65[1], hs65[2]
    g = guarded_functions(_poisoned(tf, which))
    x0 = torch.tensor([1.0, 1.0, 0.0], dtype=F64)
    with pytest.raises(FloatingPointError, match=name):
        et.core_solve(g, x0, DIMS, Options(), TOLS, dtype=F64, device="cpu")
    starts = np.array(starts)
    starts[:, 0] = -1.0
    starts[3, 0] = 1.0     # one lane of eight
    with pytest.raises(FloatingPointError, match=name):
        solve_batched(g, starts, DIMS, Options(), TOLS, dtype=F64,
                      device="cpu")


def test_guarded_functions_change_nothing_when_finite(hs65):
    tf, starts = hs65[1], hs65[2]
    plain = solve_batched(tf, starts, DIMS, Options(), TOLS, dtype=F64,
                          device="cpu")
    guarded = solve_batched(guarded_functions(tf), starts, DIMS, Options(),
                            TOLS, dtype=F64, device="cpu")
    assert torch.equal(plain.x, guarded.x)
    assert torch.equal(plain.exit_code, guarded.exit_code)
    one = et.core_solve(guarded_functions(tf), starts[0], DIMS, Options(),
                        TOLS, dtype=F64, device="cpu")
    ref = et.core_solve(tf, starts[0], DIMS, Options(), TOLS, dtype=F64,
                        device="cpu")
    assert torch.equal(one.x, ref.x) and one.n_iter == ref.n_iter


def test_first_nonfinite_report():
    model = et.solve(et.CnlsModel(**HS65), device="cpu")
    assert first_nonfinite_report(model) is None
    model.obj_value = float("inf")
    assert "objective" in first_nonfinite_report(model)
    model.sol = np.array([1.0, np.nan, 2.0])
    assert "[1]" in first_nonfinite_report(model)


# --------------------------------------------------------- profiling

def test_stage_timer_annotate_and_trace(hs65, tmp_path):
    tf, starts = hs65[1], hs65[2]
    timer = StageTimer()
    with trace(str(tmp_path / "prof")) as prof:
        for _ in range(2):
            with timer.stage("solve"), annotate("enlsip_solve"):
                res = solve_batched(tf, starts, DIMS, Options(max_iter=3),
                                    TOLS, dtype=F64, device="cpu")
        with timer.stage("sum", result=res.f):
            float(res.f.sum())
    assert timer.counts == {"solve": 2, "sum": 1}
    assert timer.totals["solve"] > 0 and "solve" in timer.report()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert any(e.key == "enlsip_solve" for e in prof.key_averages())


@pytest.mark.gpu
def test_utils_on_the_card(tmp_path):
    """Needs the card and nvcc (run with ``pytest -m gpu``): a guarded
    fused batch on the card names the function that returned NaN, a
    finite one equals the unguarded solve; ``trace`` records the card's
    kernels and an ``annotate`` range; ``StageTimer`` waits for a result
    on the card; a batch carry round-trips on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batched kernel has no CPU mode")
    fams = hs_scenario_batch(["hs14", "hs65"], per_family=4, seed=0)
    fs = fuse_families(fams)
    opts, f32 = Options(max_iter=20), torch.float32
    tols = Tols.for_dtype(f32, "cuda")
    solve = lambda fns: solve_batched(fns, fs.x0, fs.dims, opts, tols,
                                      dtype=f32, data=fs.data,
                                      rdims=fs.rdims)
    timer = StageTimer()
    with trace(str(tmp_path / "prof")) as prof:
        with timer.stage("plain"), annotate("enlsip_fused"):
            plain = solve(fs.fns)
        guarded = solve(guarded_functions(fs.fns))
    assert torch.equal(plain.x, guarded.x)
    assert any(e.key == "enlsip_fused" for e in prof.key_averages())
    assert any("cpqr_batched_kernel" in e.key for e in prof.key_averages())
    with timer.stage("sum", result=plain.f):
        total = plain.f.sum()
    assert torch.isfinite(total) and timer.counts["sum"] == 1
    bad = _poisoned(fs.fns, "cons")
    with pytest.raises(FloatingPointError, match="constraints"):
        solve(guarded_functions(bad))
    c = init_batch(fs.fns, fs.x0, fs.dims, opts, f32, fs.data, fs.rdims)
    path = str(tmp_path / "card.npz")
    save_carry(path, c)
    _assert_same(load_carry(path, like=c), c)
    assert load_carry(path).x.is_cuda
