"""The slice as a whole: the PyTorch port's single-solve loop against
the JAX package, step by step (float64, CPU).

Per iteration the method code, working-set size t and rankA compare
exactly, as do the exit code, the iteration count and the four
evaluation counters; x and f agree within 1e-8 relative.  The step
length alpha compares at 1e-6 relative while the objective still moves
(within 1e-6 relative of its final value the merit is flat to rounding
and the line search amplifies last-bit differences).  One JAX compile
per problem family."""

from functools import partial

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
from enlsip_tpu.models.model import total_nb_constraints
from enlsip_tpu_torch.core import driver as tdrv
from enlsip_tpu_torch.core import types as ttypes
from enlsip_tpu_torch.models.model import _model_functions as t_model_functions
from enlsip_tpu_torch.problems import classic as tprob
from enlsip_tpu_torch.testing import assert_tree_close

import problems as jprob
from torch_port_helpers import CPU, F64, ref_tree, to_port, tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

REL = float(np.sqrt(np.finfo(float).eps))
DEFAULT_TOLS = (1e-10, REL, REL, REL, REL)


def _row(carry):
    prev, cnt = carry.prev, carry.counters
    return (int(prev.code), int(prev.t), int(prev.rankA), float(prev.alpha),
            int(carry.exit_code), float(carry.rx @ carry.rx),
            tuple(int(c) for c in cnt))


def jax_trace(step, carry, max_steps=120):
    rows = []
    while int(carry.exit_code) == 0 and len(rows) < max_steps:
        carry = step(carry)
        rows.append(_row(carry))
    return rows, carry


def torch_trace(fns, x0, dims, opts, tols):
    rows = []
    res = tdrv.solve(
        tdrv.Functions(*fns), x0, dims, opts,
        ttypes.Tols(*(tt(v) for v in tols)), dtype=F64, device="cpu",
        on_iteration=lambda c: rows.append(_row(c)))
    return rows, res


def compare_traces(jrows, jcarry, trows, tres, what,
                   final_counters_exact=True, x_rtol=1e-8):
    """``final_counters_exact=False``: the residual/constraint counters
    are held exactly only while the objective still moves; past that the
    number of merit evaluations of a line search on a merit that is flat
    to rounding is noise on both sides.  The Jacobian counters (one per
    iteration) are exact always."""
    assert len(trows) == len(jrows), (what, len(trows), len(jrows))
    f_final = jrows[-1][5]
    for k, (jr, tr) in enumerate(zip(jrows, trows)):
        assert tr[:3] == jr[:3], (what, k, tr, jr)       # code, t, rankA
        assert tr[4] == jr[4], (what, k, tr, jr)         # exit code
        if abs(jr[5] - f_final) > 1e-6 * max(abs(f_final), 1e-300):
            np.testing.assert_allclose(tr[3], jr[3], rtol=1e-6,
                                       err_msg=f"{what} alpha at {k}")
            assert tr[6] == jr[6], (what, k, tr, jr)     # counters
        np.testing.assert_allclose(tr[5], jr[5], rtol=1e-8, atol=1e-14,
                                   err_msg=f"{what} f at {k}")
    assert tres.exit_code == int(jcarry.exit_code)
    assert tres.n_iter == int(jcarry.nb_iter)
    want = tuple(int(c) for c in jcarry.counters)
    if final_counters_exact:
        assert tuple(tres.counters) == want
    assert (tres.counters.nb_jacres, tres.counters.nb_jaccons) == \
        (want[1], want[3])
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jcarry.x),
                               rtol=x_rtol, atol=x_rtol * float(
                                   np.max(np.abs(np.asarray(jcarry.x)))))


# --------------------------------------------------- the four problems

PROBLEMS = {
    "hs65": (lambda: jprob.HS65, lambda: tprob.HS65, DEFAULT_TOLS),
    "osborne2": (lambda: jprob.OSBORNE2, lambda: tprob.OSBORNE2,
                 DEFAULT_TOLS),
    "chained_wood_20": (lambda: jprob.chained_wood(20),
                        lambda: tprob.chained_wood(20),
                        (1e-10, 1e-5, 1e-3, 1e-6, REL)),
    "chained_rosenbrock_50": (lambda: jprob.chained_rosenbrock(50),
                              lambda: tprob.chained_rosenbrock(50),
                              DEFAULT_TOLS),
}


@pytest.fixture(scope="module")
def traces():
    cache = {}

    def get(name):
        if name not in cache:
            jkw, tkw, tols = PROBLEMS[name]
            jm, tm = ej.CnlsModel(**jkw()), et.CnlsModel(**tkw())
            n, m, q = jm.nb_parameters, jm.nb_residuals, jm.nb_eqcons
            l = total_nb_constraints(jm)
            jf = jdrv.Functions(*j_model_functions(jm, jnp.float64))
            jd, jo = jtypes.Dims(n, m, q, l), jtypes.Options()
            jt = jtypes.Tols(*(jnp.float64(v) for v in tols))
            step = jax.jit(partial(jdrv.iterate_body, fns=jf, dims=jd,
                                   opts=jo, tols=jt))
            jc0 = jdrv.init_carry(jf, jnp.asarray(jm.starting_point), jd, jo,
                                  jnp.float64)
            jrows, jc = jax_trace(step, jc0)
            tfns = t_model_functions(tm, F64, CPU)
            trows, tres = torch_trace(tfns, tm.starting_point,
                                      ttypes.Dims(n, m, q, l),
                                      ttypes.Options(), tols)
            wsr = jax.jit(lambda c: jdrv._working_set_round(
                c.active_mask, c.A, c.cx, c.rx, c.J, c.gf, c.index_del, jd,
                jo, jt))
            cache[name] = dict(jrows=jrows, jc=jc, trows=trows, tres=tres,
                               step=step, jc0=jc0, tfns=tfns, jf=jf, wsr=wsr,
                               dims=(n, m, q, l), tols=tols)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_trajectory_matches_reference(traces, name):
    s = traces(name)
    compare_traces(s["jrows"], s["jc"], s["trows"], s["tres"], name)
    assert s["tres"].exit_code > 0


def test_problems_take_every_direction_branch(traces):
    """HS65 starts rank-deficient (t = 3 > rankA = 2); Chained Wood needs
    the Newton step; the subspace code appears somewhere."""
    assert traces("hs65")["trows"][0][:3] == (1, 3, 2)
    wood = [r[0] for r in traces("chained_wood_20")["trows"]]
    assert 2 in wood
    codes = {r[0] for name in PROBLEMS for r in traces(name)["trows"]}
    assert {1, 2} <= codes


@pytest.mark.parametrize("name,k", [("hs65", 0), ("hs65", 1), ("hs65", 5),
                                    ("osborne2", 3), ("chained_wood_20", 4),
                                    ("chained_rosenbrock_50", 1)])
def test_single_iteration_from_reference_state(traces, name, k):
    """init_carry, the working-set round and one whole iterate_body from
    the JAX package's state after k iterations, carried across by
    utils/convert.py; every field of the results at 1e-8 absolute."""
    s = traces(name)
    n, m, q, l = s["dims"]
    td, to = ttypes.Dims(n, m, q, l), ttypes.Options()
    ttol = ttypes.Tols(*(tt(v) for v in s["tols"]))
    jc = s["jc0"]
    if k == 0:
        tc0 = tdrv.init_carry(tdrv.Functions(*s["tfns"]),
                              np.asarray(jc.x), td, to, F64, device="cpu")
        assert_tree_close(tc0, ref_tree(jc), 1e-12, what="init_carry")
    for _ in range(k):
        jc = s["step"](jc)
    tc = to_port(jc)
    jw = s["wsr"](jc)
    tw = tdrv._working_set_round(tc.active_mask, tc.A, tc.cx, tc.rx, tc.J,
                                 tc.gf, tc.index_del, td, to, ttol)
    if name != "chained_rosenbrock_50":
        # (the banded constraint Jacobian of Chained Rosenbrock puts
        # entries that are zero up to rounding on the pivot position;
        # their sign, hence the sign of a row of R, is noise on both
        # sides — the step built from the factors below is not)
        assert_tree_close(tw, ref_tree(jw), 1e-8, what="wsr")
    else:
        assert_tree_close(tw.gn.p, np.asarray(jw.gn.p), 1e-8, what="p")
    jn = s["step"](jc)
    tn = tdrv.iterate_body(tc, tdrv.Functions(*s["tfns"]), td, to, ttol)
    assert_tree_close(tn, ref_tree(jn), 1e-8, what="carry")


def test_time_limit_gives_exit_code_minus_11(traces):
    s = traces("chained_rosenbrock_50")
    n, m, q, l = s["dims"]
    res = tdrv.solve(tdrv.Functions(*s["tfns"]), np.zeros(n),
                     ttypes.Dims(n, m, q, l), ttypes.Options(),
                     ttypes.Tols.for_dtype(F64), time_limit=-1.0, dtype=F64,
                     device="cpu")
    assert res.exit_code == -11 and res.n_iter == 0


def test_max_iter_gives_exit_code_minus_2(traces):
    s = traces("osborne2")
    n, m, q, l = s["dims"]
    res = tdrv.solve(tdrv.Functions(*s["tfns"]), tprob.OSBORNE2_X0,
                     ttypes.Dims(n, m, q, l), ttypes.Options(max_iter=3),
                     ttypes.Tols.for_dtype(F64), dtype=F64, device="cpu")
    assert res.exit_code == -2


def test_core_solve_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tdrv.solve(None, np.zeros(2), ttypes.Dims(2, 2, 0, 1),
                   ttypes.Options(), ttypes.Tols.for_dtype(F64))
