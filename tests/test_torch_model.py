"""The PyTorch port's model layer (models/model.py, models/fd.py,
problems/classic.py, utils/convert.py) against the JAX package, and the
port's import hygiene.  float64 on the CPU."""

import ast
import io
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enlsip_tpu as ej
import enlsip_tpu_torch as et
from enlsip_tpu.models import fd as jfd
from enlsip_tpu.models.model import build_constraint_functions as j_build
from enlsip_tpu_torch.models import fd as tfd
from enlsip_tpu_torch.models.model import build_constraint_functions as t_build
from enlsip_tpu_torch.problems import classic as tprob
from enlsip_tpu_torch.utils.convert import from_reference, to_numpy

import problems as jprob
from torch_port_helpers import tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent

PAIRS = {
    "hs65": (lambda: jprob.HS65, lambda: tprob.HS65),
    "osborne2": (lambda: jprob.OSBORNE2, lambda: tprob.OSBORNE2),
    "chained_rosenbrock_12": (lambda: jprob.chained_rosenbrock(12),
                              lambda: tprob.chained_rosenbrock(12)),
    "chained_wood_20": (lambda: jprob.chained_wood(20),
                        lambda: tprob.chained_wood(20)),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_problem_twins_agree(name):
    """r, c and their Jacobians (user-supplied or AD) at a random point:
    1e-12 absolute."""
    jkw, tkw = PAIRS[name][0](), PAIRS[name][1]()
    jm, tm = ej.CnlsModel(**jkw), et.CnlsModel(**tkw)
    x = np.random.default_rng(0).normal(size=jm.nb_parameters)
    from enlsip_tpu.models.model import _model_functions as jmf
    from enlsip_tpu_torch.models.model import _model_functions as tmf
    for jf, tf in zip(jmf(jm, jnp.float64),
                      tmf(tm, torch.float64, torch.device("cpu"))):
        np.testing.assert_allclose(tf(tt(x)).numpy(), np.asarray(jf(jnp.asarray(x))),
                                   atol=1e-12)
    assert tm.obj_value == pytest.approx(jm.obj_value, rel=1e-14)


def test_constraint_stacking_order():
    """[eq; ineq; x - lb; ub - x], finite bounds only."""
    kw = dict(residuals=lambda x: x, nb_parameters=3, nb_residuals=3,
              eq_constraints=lambda x: x[:1] * 2.0, nb_eqcons=1,
              ineq_constraints=lambda x: x[1:] ** 2, nb_ineqcons=2,
              x_low=np.array([-1.0, -np.inf, -3.0]),
              x_upp=np.array([np.inf, 5.0, np.inf]))
    jm, tm = ej.CnlsModel(**kw), et.CnlsModel(**kw)
    x = np.array([0.5, -0.25, 2.0])
    jc, jA = j_build(jm)
    tc, tA = t_build(tm)
    want = np.array([1.0, 0.0625, 4.0, 1.5, 5.0, 5.25])
    np.testing.assert_allclose(tc(tt(x)).numpy(), want, atol=1e-15)
    np.testing.assert_allclose(np.asarray(jc(jnp.asarray(x))), want,
                               atol=1e-15)
    np.testing.assert_allclose(tA(tt(x)).numpy(), np.asarray(jA(jnp.asarray(x))),
                               atol=1e-15)
    assert et.total_nb_constraints(tm) == ej.total_nb_constraints(jm) == 6
    assert et.nb_lower_bounds(tm) == 2 and et.nb_upper_bounds(tm) == 1


def test_validation_errors():
    with pytest.raises(ValueError, match="at least one constraint"):
        et.CnlsModel(residuals=lambda x: x, nb_parameters=2, nb_residuals=2)
    with pytest.raises(ValueError, match="Incoherent definition of inequality"):
        et.CnlsModel(residuals=lambda x: x, nb_parameters=2, nb_residuals=2,
                     ineq_constraints=lambda x: x, nb_ineqcons=0)
    with pytest.raises(ValueError, match="Incoherent definition of equality"):
        et.CnlsModel(residuals=lambda x: x, nb_parameters=2, nb_residuals=2,
                     nb_eqcons=1, x_low=np.zeros(2))
    with pytest.raises(ValueError, match="strictly positive"):
        et.CnlsModel(residuals=lambda x: x, nb_parameters=0, nb_residuals=2)


@pytest.fixture(scope="module")
def solved_hs65():
    jm = ej.solve(ej.CnlsModel(**jprob.HS65))
    tm = et.solve(et.CnlsModel(**tprob.HS65), device="cpu")
    return jm, tm


def test_solve_hs65_matches_reference_and_optimum(solved_hs65):
    jm, tm = solved_hs65
    assert et.status(tm) == ej.status(jm) == "found_first_order_stationary_point"
    assert et.sum_sq_residuals(tm) == pytest.approx(tprob.HS65_FSTAR, abs=1e-7)
    np.testing.assert_allclose(et.sum_sq_residuals(tm),
                               ej.sum_sq_residuals(jm), rtol=1e-8)
    np.testing.assert_allclose(et.solution(tm), ej.solution(jm), rtol=1e-8)
    np.testing.assert_allclose(et.solution(tm), tprob.HS65_XSTAR, atol=1e-5)


def test_execution_info_matches_reference(solved_hs65):
    jm, tm = solved_hs65
    ji, ti = jm.model_info, tm.model_info
    assert ti.nb_function_evaluations == ji.nb_function_evaluations
    assert ti.nb_jacobian_evaluations == ji.nb_jacobian_evaluations
    assert ti.iterations_detail.shape == ji.iterations_detail.shape
    # objective, ||active c||^2 and ||p|| per iteration (alpha and the
    # reduction of the last, noise-limited step are left out)
    np.testing.assert_allclose(ti.iterations_detail[:-1, :4],
                               ji.iterations_detail[:-1, :4], rtol=1e-6,
                               atol=1e-12)


def test_accessors(solved_hs65):
    jm, tm = solved_hs65
    for name in ("constraints_values", "inequality_constraints_values",
                 "equality_constraints_values", "bounds_constraints_values"):
        np.testing.assert_allclose(getattr(et, name)(tm),
                                   np.asarray(getattr(ej, name)(jm)),
                                   atol=1e-7, err_msg=name)
    assert et.nb_inequality_constraints(tm) == 1
    assert et.nb_equality_constraints(tm) == 0


def test_ad_jacobians_give_the_same_solve():
    kw = dict(tprob.HS65)
    kw.pop("jacobian_residuals")
    kw.pop("jacobian_ineqcons")
    tm = et.solve(et.CnlsModel(**kw), device="cpu")
    assert et.status(tm) == "found_first_order_stationary_point"
    assert et.sum_sq_residuals(tm) == pytest.approx(tprob.HS65_FSTAR, abs=1e-7)


@pytest.mark.parametrize("kwargs,status", [
    (dict(time_limit=-1.0), "time_limit_exceeded"),
    (dict(max_iter=2), "maximum_iterations_exceeded"),
])
def test_status_lattice(kwargs, status):
    tm = et.solve(et.CnlsModel(**tprob.chained_rosenbrock(12)), device="cpu",
                  **kwargs)
    assert et.status(tm) == status
    assert et.convert_exit_code(10300) == 1
    assert et.convert_exit_code(-6) == -1
    assert et.dict_status_codes == ej.dict_status_codes


def test_float32_solve_reaches_the_optimum():
    tm = et.solve(et.CnlsModel(**tprob.HS65), device="cpu",
                  dtype=torch.float32)
    assert et.status(tm) == "found_first_order_stationary_point"
    assert et.sum_sq_residuals(tm) == pytest.approx(tprob.HS65_FSTAR, rel=1e-3)


def test_second_derivatives_off_for_large_problems_and_tolerances(monkeypatch):
    """n + m >= 1000 disables second derivatives; the internal eps_abs
    stays 1e-10 whatever abs_tol says."""
    seen = {}

    def fake_core_solve(fns, x0, dims, opts, tols, **kw):
        seen.update(opts=opts, tols=tols, dims=dims)
        raise KeyboardInterrupt

    import enlsip_tpu_torch.models.model as mm
    monkeypatch.setattr(mm, "core_solve", fake_core_solve)
    with pytest.raises(KeyboardInterrupt):
        et.solve(et.CnlsModel(**tprob.chained_rosenbrock(400)), device="cpu",
                 abs_tol=1e-8)
    assert seen["opts"].second_derivatives is False
    assert float(seen["tols"].eps_abs) == 1e-10
    assert float(seen["tols"].eps_rel) == pytest.approx(1e-4)
    assert float(seen["tols"].eps_rank) == pytest.approx(np.sqrt(2.0 ** -52))
    assert (seen["dims"].n, seen["dims"].m, seen["dims"].q, seen["dims"].l) \
        == (400, 798, 398, 398)
    with pytest.raises(KeyboardInterrupt):
        et.solve(et.CnlsModel(**tprob.chained_rosenbrock(12)), device="cpu")
    assert seen["opts"].second_derivatives is True


def test_printer_names_the_port(solved_hs65):
    _, tm = solved_hs65
    out = io.StringIO()
    et.print_cnls_model(tm, out)
    text = out.getvalue()
    assert "PyTorch" in text and "CUDA" in text and "TPU" not in text
    assert "Termination status" in text
    fresh = io.StringIO()
    et.print_cnls_model(et.CnlsModel(**tprob.HS65), fresh)
    assert "Model has been initialized" in fresh.getvalue()


def test_solve_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        et.solve(et.CnlsModel(**tprob.HS65))


@pytest.mark.parametrize("seed", range(3))
def test_forward_difference_jacobian(seed):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(5, 4))
    x = rng.normal(size=4) * 3.0
    jJ = jfd.jac_forward_diff(lambda z: jnp.sin(jnp.asarray(B) @ z))(
        jnp.asarray(x))
    tJ = tfd.jac_forward_diff(lambda z: torch.sin(tt(B) @ z))(tt(x))
    # a difference quotient with step ~1e-8 amplifies last-bit
    # differences of sin by 1e8: 1e-6 absolute
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=1e-6)


def test_convert_round_trip():
    from enlsip_tpu.core.types import Counters as JC
    tree = {"_type": "Counters", "nb_res": np.int32(3), "nb_jacres": 1,
            "nb_cons": 3, "nb_jaccons": 1}
    c = from_reference(tree, "cpu", torch.float64)
    assert tuple(c) == (3, 1, 3, 1) and JC._fields == type(c)._fields
    view = from_reference({"_type": "WorkingView",
                           "active_list": np.array([2, 0, 1], np.int32),
                           "t": np.int32(1)}, "cpu", torch.float32)
    assert view.active_list.dtype == torch.int64
    back = to_numpy(view)
    assert back["_type"] == "WorkingView" and int(back["t"]) == 1
    f = from_reference({"a": np.ones(2), "m": np.array([True, False])},
                       "cpu", torch.float32)
    assert f["a"].dtype == torch.float32 and f["m"].dtype == torch.bool


def test_package_exports_match_reference():
    assert sorted(et.__all__) == sorted(ej.__all__)
    for name in et.__all__:
        assert hasattr(et, name), name


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_sources():
    return sorted((ROOT / "enlsip_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
        assert top != "enlsip_tpu", (path, mod)
