"""``solve_multistart``: one problem from K perturbed starts in one
batch, the best converged lane kept (HS65, K = 8, float64, CPU).
``best_lane`` and ``n_converged`` equal the JAX package's, f to 1e-8
relative; the starts themselves are equal to the bit."""

import jax.numpy as jnp
import numpy as np
import torch

from enlsip_tpu.core.types import Dims as JDims, Options as JOptions, \
    Tols as JTols
from enlsip_tpu.parallel import perturbed_starts as j_perturbed_starts
from enlsip_tpu.parallel import solve_multistart as j_solve_multistart
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.parallel import (MultistartResult, perturbed_starts,
                                       solve_multistart)
from enlsip_tpu_torch.parallel import multistart as tms
from enlsip_tpu_torch.parallel.batch import BatchResult
from enlsip_tpu_torch.core.types import Counters
from enlsip_tpu_torch.problems.classic import HS65, HS65_FSTAR

from torch_port_helpers import F64, hs65_batch_setup
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

K = 8
REL = float(np.sqrt(np.finfo(float).eps))


def test_perturbed_starts_equal_the_reference():
    x0 = np.asarray(HS65["starting_point"])
    for kw in (dict(), dict(scale=0.2, seed=3), dict(include_x0=False)):
        np.testing.assert_array_equal(perturbed_starts(x0, K, **kw),
                                      j_perturbed_starts(x0, K, **kw))
    np.testing.assert_array_equal(perturbed_starts(x0, K)[0], x0)


def test_solve_multistart_matches_jax():
    jf, tf, _, (n, m, q, l) = hs65_batch_setup(K)
    x0 = np.asarray(HS65["starting_point"])
    jtols = JTols(*(jnp.float64(v) for v in (1e-10, REL, REL, REL, REL)))
    jres = j_solve_multistart(jf, x0, JDims(n, m, q, l), JOptions(), jtols,
                              K=K, scale=0.1, dtype=jnp.float64)
    tres = solve_multistart(tf, x0, Dims(n, m, q, l), Options(),
                            Tols.for_dtype(F64), K=K, scale=0.1, dtype=F64,
                            device="cpu")
    assert isinstance(tres, MultistartResult)
    assert tres.n_converged == jres.n_converged
    np.testing.assert_array_equal(tres.batch.exit_code.numpy(),
                                  np.asarray(jres.batch.exit_code))
    np.testing.assert_allclose(tres.batch.f.numpy(), np.asarray(jres.batch.f),
                               rtol=1e-8)
    # the lanes converge to one optimum; their f differ in the last
    # digits only, so the winner is compared by value
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-8)
    np.testing.assert_allclose(float(tres.f), HS65_FSTAR, atol=1e-6)
    assert int(tres.exit_code) == int(jres.exit_code) > 0
    assert int(tres.batch.exit_code[tres.best_lane]) > 0
    assert float(tres.f) == float(tres.batch.f.min())
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-7)


def _fake_batch(f, ec):
    z = torch.zeros(len(f), dtype=torch.int64)
    return BatchResult(exit_code=torch.tensor(ec), x=torch.tensor(f, dtype=F64)[:, None],
                       f=torch.tensor(f, dtype=F64), n_iter=z, counters=Counters(z, z, z, z))


def test_selection_rule(monkeypatch):
    """Lowest f among lanes with exit_code > 0; lane 0 when none
    converged (host-side selection only)."""
    cases = [([3.0, 1.0, 2.0, 0.5], [10300, -6, 300, -2], 2, 2),
             ([3.0, 1.0, 2.0, 0.5], [-4, -6, -2, -11], 0, 0),
             ([0.7, 0.7, 0.9, 0.7], [40, 10000, 300, 2000], 0, 4)]
    for f, ec, best, nconv in cases:
        monkeypatch.setattr(tms, "solve_batched",
                            lambda *a, **k: _fake_batch(f, ec))
        out = solve_multistart(None, np.zeros(1), None, None, None, K=len(f),
                               device="cpu")
        assert (out.best_lane, out.n_converged) == (best, nconv)
        assert float(out.f) == f[best] and int(out.exit_code) == ec[best]
