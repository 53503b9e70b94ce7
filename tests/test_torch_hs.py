"""The Hock–Schittkowski suite of the PyTorch port (``problems/hs.py``)
against the JAX package's (float64, CPU).

* The closures: r, J, c and A of all 28 problems at the standard start
  and at one perturbed point agree with ``enlsip_tpu``'s closures
  (evaluated eagerly, no ``jit``) to 1e-12 relative; dims and bounds are
  equal.
* The port's single solves of all 28 from the standard starts reproduce
  ``tests/test_hs_suite.py``: 24 match f* within 1e-5 (1 + |f*|), and
  the four misses land where the oracle-adjudicated reference lands.
* Six problems (equalities, inequalities, bounds, the Newton path)
  against ``enlsip_tpu``'s own single solve: exit codes and iteration
  counts exact, f and x within 1e-8.  One JAX compile each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enlsip_tpu as ej
import enlsip_tpu_torch as et
from enlsip_tpu.core import driver as jdrv
from enlsip_tpu.core import types as jtypes
from enlsip_tpu.models.model import _model_functions as j_model_functions
from enlsip_tpu.models.model import build_constraint_functions as j_build
from enlsip_tpu.models.model import total_nb_constraints as j_total
from enlsip_tpu.problems import HS_PROBLEMS as J_HS
from enlsip_tpu_torch.models.model import (_ad_jac, _model_functions,
                                           build_constraint_functions,
                                           total_nb_constraints)
from enlsip_tpu_torch.problems import HS_PROBLEMS, get_problem, problem_names

from torch_port_helpers import CPU, F64

REL = float(np.sqrt(np.finfo(float).eps))
NAMES = sorted(HS_PROBLEMS)
# The f64 misses of the reference, adjudicated by the reference-derived
# oracle (tests/test_hs_suite.py): hs2 and hs13 converge elsewhere, hs16
# and hs27 fail through the abnormal exits.
MISSES = {"hs2", "hs13", "hs16", "hs27"}


def test_suite_registry_matches_the_reference():
    assert sorted(J_HS) == NAMES == problem_names()
    assert len(NAMES) == 28
    kw, fstar = get_problem("hs65")
    assert fstar == J_HS["hs65"]()[1] and kw["nb_parameters"] == 3


def _closures(kw, side):
    if side == "jax":
        model = ej.CnlsModel(**kw)
        cons, jac_cons = j_build(model)
        jac = model.jacobian_residuals or jax.jacfwd(model.residuals)
        call = lambda f: (lambda x: np.asarray(f(jnp.asarray(x))))
        return model, [call(f) for f in (model.residuals, jac, cons,
                                         jac_cons)]
    model = et.CnlsModel(**kw)
    cons, jac_cons = build_constraint_functions(model, CPU)
    jac = model.jacobian_residuals or _ad_jac(model.residuals)
    call = lambda f: (lambda x: f(torch.tensor(x, dtype=F64)).numpy())
    return model, [call(f) for f in (model.residuals, jac, cons, jac_cons)]


@pytest.mark.parametrize("name", NAMES)
def test_closures_match_the_jax_builders(name):
    jkw, jfstar = J_HS[name]()
    tkw, tfstar = HS_PROBLEMS[name]()
    assert tfstar == jfstar
    jm, jfns = _closures(jkw, "jax")
    tm, tfns = _closures(tkw, "torch")
    assert (tm.nb_parameters, tm.nb_residuals, tm.nb_eqcons,
            tm.nb_ineqcons, total_nb_constraints(tm)) == \
        (jm.nb_parameters, jm.nb_residuals, jm.nb_eqcons, jm.nb_ineqcons,
         j_total(jm))
    for a, b in ((tm.x_low, jm.x_low), (tm.x_upp, jm.x_upp),
                 (tm.starting_point, jm.starting_point)):
        np.testing.assert_array_equal(a, np.asarray(b))
    x0 = np.asarray(jm.starting_point, float)
    rng = np.random.default_rng(0)
    for x in (x0, x0 + 0.1 * rng.normal(size=x0.shape)):
        for what, jf, tf in zip(("r", "J", "c", "A"), jfns, tfns):
            want, got = jf(x), tf(x)
            assert got.shape == want.shape, (name, what)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name} {what}")


def _port_solve(name):
    kw, fstar = HS_PROBLEMS[name]()
    m = et.CnlsModel(**kw)
    dims = et.Dims(m.nb_parameters, m.nb_residuals, m.nb_eqcons,
                   total_nb_constraints(m))
    res = et.core_solve(et.Functions(*_model_functions(m, F64, CPU)),
                        m.starting_point, dims, et.Options(),
                        et.Tols.for_dtype(F64), dtype=F64, device="cpu")
    return res, fstar


@pytest.fixture(scope="module")
def port_suite():
    return {name: _port_solve(name) for name in NAMES}


def _matches(f, fstar):
    return abs(f - fstar) <= 1e-5 * (1 + abs(fstar))


@pytest.mark.parametrize("name", NAMES)
def test_port_single_solve_outcome(name, port_suite):
    res, fstar = port_suite[name]
    assert np.isfinite(res.f) and res.exit_code != 0
    if name in MISSES:
        assert not _matches(res.f, fstar), name
    else:
        assert _matches(res.f, fstar), (name, res.f, fstar)


def test_port_suite_match_count_and_adjudicated_misses(port_suite):
    matched = {n for n, (r, fs) in port_suite.items() if _matches(r.f, fs)}
    assert len(matched) == 24 and set(NAMES) - matched == MISSES
    hs2, hs13 = port_suite["hs2"][0], port_suite["hs13"][0]
    assert hs2.exit_code == 10000
    np.testing.assert_allclose(hs2.f, 4.9412293, rtol=1e-7)
    assert hs13.exit_code > 0
    np.testing.assert_allclose(hs13.f, 0.99696744, rtol=1e-7)
    for name in ("hs16", "hs27"):
        code = port_suite[name][0].exit_code
        assert et.convert_exit_code(code) == -1, (name, code)


@pytest.mark.parametrize("name", ["hs6", "hs14", "hs26", "hs42", "hs57",
                                  "hs65"])
def test_single_solve_matches_enlsip_tpu(name, port_suite):
    jkw, _ = J_HS[name]()
    jm = ej.CnlsModel(**jkw)
    dims = jtypes.Dims(jm.nb_parameters, jm.nb_residuals, jm.nb_eqcons,
                       j_total(jm))
    jres = jdrv.solve(jdrv.Functions(*j_model_functions(jm, jnp.float64)),
                      jnp.asarray(jm.starting_point), dims, jtypes.Options(),
                      jtypes.Tols(*(jnp.float64(v) for v in
                                    (1e-10, REL, REL, REL, REL))),
                      dtype=jnp.float64)
    tres, _ = port_suite[name]
    assert tres.exit_code == int(jres.exit_code), name
    assert tres.n_iter == int(jres.n_iter), name
    np.testing.assert_allclose(tres.f, float(jres.f), rtol=1e-8, atol=1e-14)
    jx = np.asarray(jres.x)
    np.testing.assert_allclose(tres.x.numpy(), jx, rtol=1e-8,
                               atol=1e-8 * max(1.0, float(np.abs(jx).max())))
