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
* ``annotate`` (a host span) and ``trace`` run on the CPU: the trace and
  its ``spans.json`` are written, the span is a ``record_function`` range.
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
import json

from enlsip_tpu_torch.utils import (annotate, load_carry, profiling,
                                   save_carry, trace)
from enlsip_tpu_torch.utils.debug import (first_nonfinite_report,
                                          guarded_functions)

from torch_port_helpers import F64, hs65_batch_setup
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

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
    while int(c.exit_code) == 0:
        c = iterate_body(c, tf, DIMS, Options(), TOLS)
    return c


def test_single_solve_round_trip(hs65, tmp_path):
    tf = hs65[1]
    mid = _single(tf, 3)
    path = str(tmp_path / "single.npz")
    save_carry(path, mid)
    back = load_carry(path, like=mid)
    _assert_same(back, mid)
    # one solve's counts are 0-d int64 tensors, like every other field
    assert back.nb_iter.ndim == 0 and int(back.nb_iter) == 3
    assert back.counters.nb_res.dtype == torch.int64
    # like=None: the canonical structure, int64 tensors
    canon = load_carry(path, device="cpu")
    assert canon.exit_code.ndim == 0 and int(canon.nb_iter) == 3
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
    """A host span (``annotate``) around two batches under ``trace``: a
    ``record_function`` range in the trace, two records in
    ``spans.json`` (tracing is on while the profiler is open), each
    holding its batch's rehearsed ``batch`` span."""
    tf, starts = hs65[1], hs65[2]
    with trace(str(tmp_path / "prof")) as prof:
        for _ in range(2):
            with annotate("enlsip_solve"):
                solve_batched(tf, starts, DIMS, Options(max_iter=3), TOLS,
                              dtype=F64, device="cpu")
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert any(e.key == "enlsip_solve" for e in prof.key_averages())
    got = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert got["align"] is None         # no card: no stamp to pair
    recs = got["spans"]
    outer = [i for i, r in enumerate(recs) if r["name"] == "enlsip_solve"]
    assert len(outer) == 2
    for i in outer:
        assert recs[i]["end_ns"] > recs[i]["start_ns"]
        batch = [r for r in recs if r["name"] == "batch"
                 and r["call"] == recs[i]["call"]]
        assert len(batch) == 1


@pytest.mark.gpu
def test_utils_on_the_card(tmp_path):
    """Needs the card and nvcc (run with ``pytest -m gpu``): a guarded
    fused batch on the card names the function that returned NaN, a
    finite one equals the unguarded solve; ``trace`` records the card's
    kernels and an ``annotate`` range, and ``spans.json`` the batches'
    spans stamped on the card, its clock put on the trace's by every
    stamp; a batch carry round-trips on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batched kernel has no CPU mode")
    fams = hs_scenario_batch(["hs14", "hs65"], per_family=4, seed=0)
    fs = fuse_families(fams)
    opts, f32 = Options(max_iter=20), torch.float32
    tols = Tols.for_dtype(f32, "cuda")
    solve = lambda fns: solve_batched(fns, fs.x0, fs.dims, opts, tols,
                                      dtype=f32, data=fs.data,
                                      rdims=fs.rdims)
    with trace(str(tmp_path / "prof")) as prof:
        with annotate("enlsip_fused"):
            plain = solve(fs.fns)
        guarded = solve(guarded_functions(fs.fns))
    assert torch.equal(plain.x, guarded.x)
    keys = [e.key for e in prof.key_averages()]
    assert "enlsip_fused" in keys
    assert any("cpqr_batched_kernel" in k for k in keys)
    assert any("enlsip_span_stamp" in k for k in keys)
    got = json.loads((tmp_path / "prof" / "spans.json").read_text())
    # every stamp of the trace paired with the card's.  The two clocks
    # drift apart (10-90 ppm measured on an H100), so the offset's spread
    # grows with the time traced, here two captures long; each pair
    # agrees with the one before it within 1 us + 200 ppm of the time
    # between them, which a stamp paired with the wrong one does not.
    kernels = [(e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() != torch.autograd.DeviceType.CPU]
    found = profiling.align(kernels)
    stamps = sum(profiling.STAMP_KERNEL in name for name, _, _ in kernels)
    assert got["align"] is not None and found is not None
    assert got["align"]["stamps"] == found.stamps == stamps > 0
    worst = max((abs((s1 - s0) - (t1 - t0)) - 2e-4 * (t1 - t0), t1 - t0, i)
                for i, ((t0, s0), (t1, s1))
                in enumerate(zip(found.pairs, found.pairs[1:])))
    assert worst[0] <= 1.0, (worst, got["align"])
    batches = [r for r in got["spans"] if r["name"] == "batch"]
    assert len(batches) == 2 and all(r["clock"] == "device"
                                     for r in batches)
    assert any(r["name"] == "cpqr" and r["attrs"]["route"] == "b2"
               for r in got["spans"])
    assert torch.isfinite(plain.f.sum())
    bad = _poisoned(fs.fns, "cons")
    with pytest.raises(FloatingPointError, match="constraints"):
        solve(guarded_functions(bad))
    c = init_batch(fs.fns, fs.x0, fs.dims, opts, f32, fs.data, fs.rdims)
    path = str(tmp_path / "card.npz")
    save_carry(path, c)
    _assert_same(load_carry(path, like=c), c)
    assert load_carry(path).x.is_cuda
