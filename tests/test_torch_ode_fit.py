"""The ODE-style parameter fit (problems/ode_fit.py) and its batched
solve with per-lane observations through ``data=`` (float64, CPU).

Constants equal the JAX module's; r and J of both ``residuals`` twins
agree to 1e-12; ``solve_batched`` with B = 8 and
``Options(second_derivatives=False)`` gives the JAX package's exit codes
class and f within 1e-8 relative.  At float64 this Gauss-Newton-only fit
mostly stalls with the objective flat to 1e-16 and walks on rounding
noise until it aborts (-4 / -6); the count of those noise steps, and
which of the two codes ends them, differ between any two
implementations — also between this package's own batched and single
solve — so exit code, iteration count and x are held exactly only on the
lanes that converge (under float32's tolerances at float64 arithmetic
three of eight do).  One JAX compile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enlsip_tpu as ej
import enlsip_tpu_torch as et
from enlsip_tpu.core.driver import Functions as JFunctions
from enlsip_tpu.core.types import Dims as JDims, Options as JOptions, \
    Tols as JTols
from enlsip_tpu.models.model import build_constraint_functions as j_build
from enlsip_tpu.parallel import solve_batched as j_solve_batched
from enlsip_tpu.problems import ode_fit as jode
from enlsip_tpu_torch.core.driver import Functions
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.models.model import (build_constraint_functions,
                                           total_nb_constraints)
from enlsip_tpu_torch.parallel import solve_batched
from enlsip_tpu_torch.problems import ode_fit as tode

from torch_port_helpers import F64, tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

B = 8
REL = float(np.sqrt(np.finfo(float).eps))


def test_constants_equal_the_reference_modules():
    for name in ("_T", "_TRUE", "_Y", "X0", "X_LOW", "X_UPP"):
        np.testing.assert_array_equal(getattr(tode, name), getattr(jode, name))
    assert (tode.N_PARAMS, tode.N_POINTS) == (jode.N_PARAMS, jode.N_POINTS)
    np.testing.assert_array_equal(tode.perturbed_starts(5, seed=3),
                                  jode.perturbed_starts(5, seed=3))
    np.testing.assert_array_equal(tode.scenario_observations(5),
                                  jode.scenario_observations(5))
    assert set(tode.model_kwargs()) == set(jode.model_kwargs())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_residual_twins_and_jacobians(seed):
    rng = np.random.default_rng(seed)
    x = jode.X0 * (1 + 0.1 * rng.normal(size=10))
    y = jode.scenario_observations(1, seed=seed)[0]
    np.testing.assert_allclose(tode.residuals(tt(x)).numpy(),
                               np.asarray(jode.residuals(jnp.asarray(x))),
                               atol=1e-12)
    np.testing.assert_allclose(
        tode.residuals_data(tt(x), tt(y)).numpy(),
        np.asarray(jode.residuals_data(jnp.asarray(x), jnp.asarray(y))),
        atol=1e-12)
    np.testing.assert_allclose(
        torch.func.jacfwd(tode.residuals)(tt(x)).numpy(),
        np.asarray(jax.jacfwd(jode.residuals)(jnp.asarray(x))), atol=1e-12)
    np.testing.assert_allclose(
        torch.func.jacfwd(tode.residuals_data)(tt(x), tt(y)).numpy(),
        np.asarray(jax.jacfwd(jode.residuals_data)(jnp.asarray(x),
                                                   jnp.asarray(y))),
        atol=1e-12)


def _torch_setup():
    model = et.CnlsModel(**tode.model_kwargs())
    cons, jac = build_constraint_functions(model, "cpu")
    fns = Functions(res=tode.residuals_data,
                    jac_res=torch.func.jacfwd(tode.residuals_data),
                    cons=lambda x, y: cons(x), jac_cons=lambda x, y: jac(x))
    return fns, Dims(n=10, m=40, q=0, l=total_nb_constraints(model))


_JCONS = {}


def _j_cons(x, y):
    return _JCONS["cons"](x)


def _j_jac_cons(x, y):
    return _JCONS["jac"](x)


def _j_jac(x, y):
    return jax.jacfwd(jode.residuals_data)(x, y)


def test_solve_batched_with_per_lane_observations_matches_jax():
    _JCONS["cons"], _JCONS["jac"] = j_build(ej.CnlsModel(**jode.model_kwargs()))
    jf = JFunctions(res=jode.residuals_data, jac_res=_j_jac, cons=_j_cons,
                    jac_cons=_j_jac_cons)
    tf, dims = _torch_setup()
    assert dims.l == 20
    starts = tode.perturbed_starts(B)
    ys = tode.scenario_observations(B)
    jtols = JTols(*(jnp.float64(v) for v in (1e-10, REL, REL, REL, REL)))
    jres = j_solve_batched(jf, starts, JDims(10, 40, 0, 20),
                           JOptions(second_derivatives=False), jtols, data=ys)
    tres = solve_batched(tf, starts, dims, Options(second_derivatives=False),
                         Tols.for_dtype(F64), dtype=F64, data=ys, device="cpu")
    _same_outcome(tres, jres, min_converged=0)
    assert np.all(np.isfinite(tres.x.numpy()))
    # every lane fits its own observations: lanes differ
    assert len({round(float(v), 12) for v in tres.f}) == B

    # float32's tolerances at float64 arithmetic: some lanes converge
    # while their objective still moves, and there the counts agree
    r32 = float(np.sqrt(np.finfo(np.float32).eps))
    loose = (1e-10, r32, r32, r32, r32)
    jres = j_solve_batched(jf, starts, JDims(10, 40, 0, 20),
                           JOptions(second_derivatives=False),
                           JTols(*(jnp.float64(v) for v in loose)), data=ys)
    tres = solve_batched(tf, starts, dims, Options(second_derivatives=False),
                         Tols(*(torch.tensor(v, dtype=F64) for v in loose)),
                         dtype=F64, data=ys, device="cpu")
    _same_outcome(tres, jres, min_converged=3)


def _same_outcome(tres, jres, min_converged):
    """f within 1e-8 relative on every lane; the same lanes converge;
    converged lanes agree in exit code, iteration count, Jacobian count
    and x (1e-6 relative); aborted lanes abort with one of the two
    Gauss-Newton stall codes (-4 Newton step disallowed, -6 no descent),
    which of the two and after how many noise steps being rounding."""
    tec, jec = tres.exit_code.numpy(), np.asarray(jres.exit_code)
    np.testing.assert_allclose(tres.f.numpy(), np.asarray(jres.f), rtol=1e-8)
    np.testing.assert_array_equal(tec > 0, jec > 0)
    assert set(tec[tec <= 0]) <= {-4, -6} and set(jec[jec <= 0]) <= {-4, -6}
    conv = tec > 0
    assert conv.sum() >= min_converged
    np.testing.assert_array_equal(tec[conv], jec[conv])
    np.testing.assert_array_equal(tres.n_iter.numpy()[conv],
                                  np.asarray(jres.n_iter)[conv])
    np.testing.assert_array_equal(tres.counters.nb_jacres.numpy()[conv],
                                  np.asarray(jres.counters.nb_jacres)[conv])
    # (atol: a parameter sitting on its bound is 0 up to rounding)
    np.testing.assert_allclose(tres.x.numpy()[conv], np.asarray(jres.x)[conv],
                               rtol=1e-6, atol=1e-12)


def test_data_accepts_a_dict_and_float32_reaches_the_noise_level():
    tf, dims = _torch_setup()
    fns = Functions(res=lambda x, d: tf.res(x, d["y"]),
                    jac_res=lambda x, d: tf.jac_res(x, d["y"]),
                    cons=lambda x, d: tf.cons(x, d["y"]),
                    jac_cons=lambda x, d: tf.jac_cons(x, d["y"]))
    starts = tode.perturbed_starts(B)
    ys = tode.scenario_observations(B)
    opts = Options(second_derivatives=False)
    tols = Tols.for_dtype(torch.float32)
    a = solve_batched(tf, starts, dims, opts, tols, dtype=torch.float32,
                      data=ys, device="cpu")
    b = solve_batched(fns, starts, dims, opts, tols, dtype=torch.float32,
                      data={"y": ys}, device="cpu")
    assert a.x.dtype == torch.float32
    assert torch.equal(a.x, b.x) and torch.equal(a.exit_code, b.exit_code)
    assert (a.f < 1e-3).all() and (a.exit_code > 0).all()
