"""``solve_batched`` of the PyTorch port against the JAX package and
against the port's own single solve (HS65, B = 8, float64, CPU).

Against JAX: exit codes and iteration counts equal, x within 1e-8
relative, f within 1e-6 of the published optimum.  Against the port's
``core_solve`` per lane: exit code, iteration count and the Jacobian
counters (one per iteration) equal.  x agrees to 1e-8 and the
residual/constraint counters to a few evaluations, not to the bit: a
batched and a single matrix product round differently in the last place,
and the last line search of a solve runs on a merit that is flat to
rounding (tests/test_torch_batched_body.py holds every trip exactly
while the objective still moves).  One JAX compile (B = 8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enlsip_tpu_torch as et
from enlsip_tpu.core.types import Dims as JDims, Options as JOptions, \
    Tols as JTols
from enlsip_tpu.parallel import solve_batched as j_solve_batched
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.parallel import (finalize, init_batch, run_batch,
                                       solve_batched, solve_multistart)
from enlsip_tpu_torch.problems.classic import HS65_FSTAR
from enlsip_tpu_torch.testing import assert_tree_close

from torch_port_helpers import (F64, computed_once, hs65_batch_setup,
                                ref_tree, to_port)
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

B = 8
REL = float(np.sqrt(np.finfo(float).eps))
TOLS = Tols.for_dtype(F64)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jf, tf, starts, (n, m, q, l) = hs65_batch_setup(B, seed=1)

    def solve():
        jtols = JTols(*(jnp.float64(v) for v in (1e-10, REL, REL, REL, REL)))
        jres = j_solve_batched(jf, starts, JDims(n, m, q, l), JOptions(),
                               jtols)
        tres = solve_batched(tf, starts, Dims(n, m, q, l), Options(), TOLS,
                             dtype=F64, device="cpu")
        return jres, tres

    jres, tres = computed_once(tmp_path_factory, "batch_hs65_setup", solve)
    return jres, tres, tf, starts, Dims(n, m, q, l)


def test_solve_batched_hs65_matches_jax(setup):
    jres, tres, *_ = setup
    assert tres.x.shape == (B, 3) and tres.exit_code.dtype == torch.int64
    np.testing.assert_array_equal(tres.exit_code.numpy(),
                                  np.asarray(jres.exit_code))
    np.testing.assert_array_equal(tres.n_iter.numpy(), np.asarray(jres.n_iter))
    assert (tres.exit_code > 0).all()
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-8)
    np.testing.assert_allclose(tres.f.numpy(), HS65_FSTAR, atol=1e-6)
    np.testing.assert_allclose(tres.f.numpy(), np.asarray(jres.f), rtol=1e-8)
    # one Jacobian evaluation per iteration on both sides
    np.testing.assert_array_equal(tres.counters.nb_jacres.numpy(),
                                  np.asarray(jres.counters.nb_jacres))


def test_reference_batch_result_converts(setup):
    jres, tres, *_ = setup
    ported = to_port(jres)
    assert type(ported).__name__ == "BatchResult"
    assert ported.exit_code.shape == (B,) and ported.escalated is None
    assert_tree_close(tres, ref_tree(jres), atol=1e-7, rtol=1e-8,
                      skip=("counters",))


def test_init_batch_carry_matches_jax_and_converts():
    """The batched carry at the start: every field against the JAX
    package's (1e-12; masks, counters and codes exact), and the
    reference's batched carry converts into the port's structure with
    its per-lane integer fields as (B,) tensors."""
    from enlsip_tpu.parallel import init_batch as j_init_batch
    jf, tf, starts, (n, m, q, l) = hs65_batch_setup(B, seed=1)
    jcarry = j_init_batch(jf, starts, JDims(n, m, q, l), JOptions(),
                          jnp.float64)
    tcarry = init_batch(tf, starts, Dims(n, m, q, l), Options(), F64,
                        device="cpu")
    assert tcarry.exit_code.shape == (B,) and tcarry.nb_iter.dtype == torch.int64
    assert tcarry.counters.nb_res.tolist() == [1] * B
    assert_tree_close(tcarry, ref_tree(jcarry), atol=1e-12)
    ported = to_port(jcarry)
    assert type(ported).__name__ == "Carry"
    assert ported.exit_code.shape == (B,) and ported.x.shape == (B, 3)
    assert torch.equal(ported.active_mask, tcarry.active_mask)


@pytest.mark.parametrize("lane", range(4))
def test_solve_batched_matches_single(setup, lane):
    """Each batched lane against the unbatched solve from the same
    start."""
    _, tres, tf, starts, dims = setup
    one = et.core_solve(tf, torch.tensor(starts[lane]), dims, Options(), TOLS,
                        dtype=F64, device="cpu")
    assert int(tres.exit_code[lane]) == one.exit_code
    assert int(tres.n_iter[lane]) == one.n_iter
    np.testing.assert_allclose(tres.x[lane].numpy(), one.x.numpy(), atol=1e-8)
    assert abs(float(tres.f[lane]) - one.f) <= 1e-12
    cnt = [int(c[lane]) for c in tres.counters]
    assert cnt[1] == one.counters.nb_jacres
    assert cnt[3] == one.counters.nb_jaccons
    assert abs(cnt[0] - one.counters.nb_res) <= 4
    assert abs(cnt[2] - one.counters.nb_cons) <= 4


def test_time_limit_cases(setup):
    _, tres, tf, starts, dims = setup
    out = solve_batched(tf, starts, dims, Options(), TOLS, dtype=F64,
                        device="cpu", time_limit=-1.0)
    assert (out.exit_code == -11).all() and (out.n_iter == 0).all()
    out = solve_batched(tf, starts, dims, Options(), TOLS, dtype=F64,
                        device="cpu", time_limit=0.0)
    assert (out.exit_code == -11).all()
    # a generous limit changes nothing, to the bit
    out = solve_batched(tf, starts, dims, Options(), TOLS, dtype=F64,
                        device="cpu", time_limit=500.0)
    assert torch.equal(out.exit_code, tres.exit_code)
    assert torch.equal(out.x, tres.x) and torch.equal(out.n_iter, tres.n_iter)
    for a, b in zip(out.counters, tres.counters):
        assert torch.equal(a, b)
    inf = solve_batched(tf, starts, dims, Options(), TOLS, dtype=F64,
                        device="cpu", time_limit=float("inf"))
    assert torch.equal(inf.x, tres.x)


def test_check_every_and_trip_cap(setup):
    _, tres, tf, starts, dims = setup
    carry = init_batch(tf, starts, dims, Options(), F64, device="cpu")
    out = finalize(run_batch(carry, tf, dims, Options(), TOLS, check_every=3))
    assert torch.equal(out.x, tres.x) and torch.equal(out.exit_code,
                                                       tres.exit_code)
    assert run_batch.last_trips % 3 == 0
    # an explicit trip cap stops the loop with lanes still running
    carry = init_batch(tf, starts, dims, Options(), F64, device="cpu")
    part = run_batch(carry, tf, dims, Options(), TOLS, max_steps=2)
    assert run_batch.last_trips == 2 and (part.exit_code == 0).all()
    assert (part.nb_iter == 2).all()
    # max_iter reached: every lane exits -2 within max_iter + 2 trips
    short = solve_batched(tf, starts, dims, Options(max_iter=3), TOLS,
                          dtype=F64, device="cpu")
    assert (short.exit_code == -2).all() and run_batch.last_trips <= 5
    assert (short.n_iter <= 4).all()


def test_per_lane_rdims_equal_to_the_static_dims_change_nothing(setup):
    """Per-lane semantic dimensions are threaded through every decision;
    set to the buffer dimensions they must reproduce the plain batch to
    the bit (different per-lane values come with the fused suite)."""
    from enlsip_tpu_torch.core.types import RDims
    _, tres, tf, starts, dims = setup
    rd = RDims(*(np.full(B, v) for v in (dims.n, dims.m, dims.q, dims.l)))
    out = solve_batched(tf, starts, dims, Options(), TOLS, dtype=F64,
                        device="cpu", rdims=rd)
    assert torch.equal(out.x, tres.x)
    assert torch.equal(out.exit_code, tres.exit_code)
    for a, b in zip(out.counters, tres.counters):
        assert torch.equal(a, b)


def test_batched_entry_points_need_the_card_unless_asked_for_the_cpu(setup):
    _, _, tf, starts, dims = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA device"):
        solve_batched(tf, starts, dims, Options(), TOLS, dtype=F64)
    with pytest.raises(RuntimeError, match="CUDA device"):
        solve_multistart(tf, starts[0], dims, Options(), TOLS, K=2)
    with pytest.raises(ValueError, match="x0_batch"):
        solve_batched(tf, starts[0], dims, Options(), TOLS, dtype=F64,
                      device="cpu")
