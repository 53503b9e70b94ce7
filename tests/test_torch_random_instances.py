"""Seeded differential run: about twenty small random CNLS instances
(mixed equalities, inequalities and bounds; a rank-deficient active set;
more constraints than parameters; bounds only; large residuals) solved by
the JAX package and by the PyTorch port and compared step by step
(float64, CPU), with the comparison of tests/test_torch_driver.py.  Two
of its limits are wider here, because the last iteration at a
stationary point takes a step p of order 1e-8 with a step length that is rounding noise on both
sides: x agrees within 1e-7 relative (f still within 1e-8), and the
residual/constraint counters are exact only while the objective moves.

The instances of a family share their shapes, so ONE jitted JAX step
serves them all: an instance's data enter it as traced arguments."""

import jax
import jax.numpy as jnp
import pytest

from enlsip_tpu.core import driver as jdrv
from enlsip_tpu.core import types as jtypes
from enlsip_tpu_torch.core import types as ttypes

from test_torch_driver import (DEFAULT_TOLS, compare_traces, jax_trace,
                               torch_trace)
from torch_port_helpers import (twin_data, twin_jax_functions,
                                twin_torch_functions)
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

FAMILIES = {
    # name: (n, m, q, n_ineq, lower, upper, dup_eq)
    "mixed": (4, 7, 1, 2, (0, 2), (1,), False),
    "rank_deficient_A": (5, 8, 3, 1, (), (4,), True),
    "l_greater_than_n": (3, 6, 1, 2, (0, 1, 2), (0, 1, 2), False),
    "bounds_only": (4, 6, 0, 0, (0, 1, 2, 3), (0, 1, 2, 3), False),
}
SCALES = (1.0, 1.0, 5.0, 20.0, 1.0)      # by seed: large residuals too
MAX_ITER = 40


@pytest.fixture(scope="module")
def family_steps():
    cache = {}

    def get(family):
        if family not in cache:
            n, m, q, ni, lo, up, _ = FAMILIES[family]
            l = q + ni + len(lo) + len(up)
            jd, jo = jtypes.Dims(n, m, q, l), jtypes.Options(max_iter=MAX_ITER)
            jt = jtypes.Tols(*(jnp.float64(v) for v in DEFAULT_TOLS))

            def fns(d):
                return jdrv.Functions(*twin_jax_functions(d, lo, up))

            init = jax.jit(lambda x0, d: jdrv.init_carry(fns(d), x0, jd, jo,
                                                         jnp.float64))
            step = jax.jit(lambda c, d: jdrv.iterate_body(c, fns(d), jd, jo,
                                                          jt))
            cache[family] = (init, step, (n, m, q, l))
        return cache[family]

    return get


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_random_instances_step_by_step(family_steps, family, seed):
    n, m, q, ni, lo, up, dup = FAMILIES[family]
    init, step, dims = family_steps(family)
    d, x0 = twin_data(1000 * sorted(FAMILIES).index(family) + seed, n, m, q,
                      ni, lo, up, dup_eq=dup, scale=SCALES[seed])
    jd_ = {k: jnp.asarray(v) for k, v in d.items()}
    jrows, jc = jax_trace(lambda c: step(c, jd_), init(jnp.asarray(x0), jd_),
                          max_steps=MAX_ITER + 5)
    trows, tres = torch_trace(twin_torch_functions(d, lo, up), x0,
                              ttypes.Dims(*dims),
                              ttypes.Options(max_iter=MAX_ITER), DEFAULT_TOLS)
    compare_traces(jrows, jc, trows, tres, f"{family}/{seed}",
                   final_counters_exact=False, x_rtol=1e-7)


def test_instances_reach_varied_outcomes(family_steps):
    """The run is not twenty copies of one easy case: it converges on
    some instances, and takes the rank-deficient path (t > rankA) on the
    family built for it."""
    n, m, q, ni, lo, up, dup = FAMILIES["rank_deficient_A"]
    d, x0 = twin_data(1000 * sorted(FAMILIES).index("rank_deficient_A"), n,
                      m, q, ni, lo, up, dup_eq=dup)
    trows, tres = torch_trace(twin_torch_functions(d, lo, up), x0,
                              ttypes.Dims(n, m, q, q + ni + len(lo) + len(up)),
                              ttypes.Options(max_iter=MAX_ITER), DEFAULT_TOLS)
    assert any(t > r for _, t, r, *_ in trows), trows
