"""Hybrid precision: a float32 batch whose flagged lanes are re-solved at
float64 from their original starts and merged (HS65, B = 8, CPU).

Against the JAX package's merged result: the same lanes are flagged; on
them x, f, exit code and iteration count are those of a float64 solve
(1e-8 relative; exact codes).  On the float32 lanes the outcome is
compared, not the bits: both sides converge to the optimum at float32
accuracy.  Within the port the merge is held exactly: counters on the
escalated lanes are the sum of both attempts, and their x/f equal the
float64 batch of those lanes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.core.types import Dims as JDims, Options as JOptions, \
    Tols as JTols
from enlsip_tpu.parallel import solve_batched as j_solve_batched
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.parallel import escalate_lanes_f64, solve_batched
from enlsip_tpu_torch.problems.classic import HS65_FSTAR

from torch_port_helpers import F64, hs65_batch_setup
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

B = 8
F32 = torch.float32
MASK = np.zeros(B, bool)
MASK[[1, 5]] = True


@pytest.fixture(scope="module")
def runs():
    jf, tf, starts, (n, m, q, l) = hs65_batch_setup(B, seed=2)
    r32 = float(np.sqrt(np.finfo(np.float32).eps))
    jtols = JTols(*(jnp.float32(v) for v in (1e-10, r32, r32, r32, r32)))
    jres = j_solve_batched(jf, starts, JDims(n, m, q, l), JOptions(), jtols,
                           dtype=jnp.float32, escalate_mask=MASK)
    dims = Dims(n, m, q, l)
    plain = solve_batched(tf, starts, dims, Options(), Tols.for_dtype(F32),
                          dtype=F32, device="cpu")
    merged = solve_batched(tf, starts, dims, Options(), Tols.for_dtype(F32),
                           dtype=F32, device="cpu", escalate_mask=MASK)
    only64 = solve_batched(tf, starts[MASK], dims, Options(),
                           Tols.for_dtype(F64), dtype=F64, device="cpu")
    return jres, plain, merged, only64, tf, starts, dims


def test_escalated_lanes_match_jax(runs):
    jres, _, merged, *_ = runs
    np.testing.assert_array_equal(merged.escalated.numpy(),
                                  np.asarray(jres.escalated))
    np.testing.assert_array_equal(merged.escalated.numpy(), MASK)
    assert merged.x.dtype == F64 and merged.f.dtype == F64
    np.testing.assert_array_equal(merged.exit_code.numpy()[MASK],
                                  np.asarray(jres.exit_code)[MASK])
    np.testing.assert_array_equal(merged.n_iter.numpy()[MASK],
                                  np.asarray(jres.n_iter)[MASK])
    np.testing.assert_allclose(merged.x.numpy()[MASK],
                               np.asarray(jres.x)[MASK], rtol=1e-8)
    np.testing.assert_allclose(merged.f.numpy()[MASK],
                               np.asarray(jres.f)[MASK], rtol=1e-8)


def test_float32_lanes_reach_the_same_outcome_as_jax(runs):
    jres, _, merged, *_ = runs
    keep = ~MASK
    assert (merged.exit_code.numpy()[keep] > 0).all()
    assert (np.asarray(jres.exit_code)[keep] > 0).all()
    np.testing.assert_allclose(merged.f.numpy()[keep], HS65_FSTAR, atol=1e-4)
    np.testing.assert_allclose(merged.f.numpy()[keep],
                               np.asarray(jres.f, float)[keep], atol=1e-4)
    np.testing.assert_allclose(merged.x.numpy()[keep],
                               np.asarray(jres.x, float)[keep], atol=5e-3)


def test_merge_is_exact_within_the_port(runs):
    _, plain, merged, only64, *_ = runs
    keep = torch.tensor(~MASK)
    esc = torch.tensor(MASK)
    # untouched lanes: the float32 solve's values, widened
    assert torch.equal(merged.x[keep], plain.x[keep].to(F64))
    assert torch.equal(merged.exit_code[keep], plain.exit_code[keep])
    for got, old in zip(merged.counters, plain.counters):
        assert torch.equal(got[keep], old[keep])
    # escalated lanes: the float64 solve's values, counters summed
    assert torch.equal(merged.x[esc], only64.x)
    assert torch.equal(merged.f[esc], only64.f)
    assert torch.equal(merged.n_iter[esc], only64.n_iter)
    for got, old, new in zip(merged.counters, plain.counters,
                             only64.counters):
        assert torch.equal(got[esc], old[esc] + new)


def test_default_rule_escalates_the_unconverged_lanes_only(runs):
    *_, tf, starts, dims = runs
    capped = solve_batched(tf, starts, dims, Options(max_iter=9),
                           Tols.for_dtype(F32), dtype=F32, device="cpu")
    failed = capped.exit_code <= 0
    out = escalate_lanes_f64(tf, starts, dims, Options(), capped,
                             device="cpu")
    assert torch.equal(out.escalated, failed)
    assert (out.exit_code[failed] > 0).all() if bool(failed.any()) else True
    assert torch.equal(out.exit_code[~failed], capped.exit_code[~failed])
    # nothing to escalate: the result comes back flagged all-False
    good = solve_batched(tf, starts, dims, Options(), Tols.for_dtype(F64),
                         dtype=F64, device="cpu", escalate_f64=True)
    assert good.escalated.dtype == torch.bool and not bool(good.escalated.any())
