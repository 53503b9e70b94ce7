"""PyTorch port of core/subproblem.py (dense path) against the JAX
package (float64, CPU).  Each function gets the JAX side's inputs,
carried across as numpy, and its outputs are compared at 1e-9 absolute
(chains of triangular solves and matrix products on O(1) data; perm,
ranks and masks exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.core import subproblem as js
from enlsip_tpu.core import types as jtypes
from enlsip_tpu.ops.qr import pseudo_rank as jpseudo_rank
from enlsip_tpu_torch.core import subproblem as ts
from enlsip_tpu_torch.core import types as ttypes
from enlsip_tpu_torch.testing import assert_tree_close

from torch_port_helpers import ref_tree, to_port, tt, twin_functions

ATOL = 1e-9
N, M, Q, L = 6, 9, 2, 7
EPS_RANK = float(np.sqrt(np.finfo(float).eps))
CASES = ["full_rank", "rank_deficient", "empty", "saturated"]


def _state(case, scaling=False):
    """JAX-side factorization chain at a random point."""
    rng = np.random.default_rng({"full_rank": 0, "rank_deficient": 1,
                                 "empty": 2, "saturated": 3}[case])
    A, cx = rng.normal(size=(L, N)), rng.normal(size=L)
    J, rx = rng.normal(size=(M, N)), rng.normal(size=M)
    mask = np.zeros(L, bool)
    if case == "full_rank":
        mask[[0, 1, 4]] = True
    elif case == "rank_deficient":
        mask[[0, 1, 3, 5]] = True
        A[3] = 2.0 * A[0] - A[1]
    elif case == "saturated":
        mask[:] = True                      # t = 7 > n = 6
    dims = jtypes.Dims(N, M, Q, L)
    view = jtypes.working_view(jnp.asarray(mask))
    act = js.gather_active(jnp.asarray(A), jnp.asarray(cx), view, dims,
                           scaling)
    gf = jnp.asarray(J.T @ rx)
    F_A = js.factor_active(act, gf, view.t, dims)
    rankA = jpseudo_rank(F_A.diag, view.t, EPS_RANK)
    F_L11 = js.factor_l11(F_A, act, view.t)
    gn = js.gn_search_direction(jnp.asarray(J), jnp.asarray(rx), act, F_A,
                                F_L11, rankA, view.t, EPS_RANK, dims)
    return dict(A=A, cx=cx, J=J, rx=rx, mask=mask, dims=dims, view=view,
                act=act, gf=gf, F_A=F_A, rankA=rankA, F_L11=F_L11, gn=gn)


TDIMS = ttypes.Dims(N, M, Q, L)


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_gather_and_factor_active(case, scaling):
    s = _state(case, scaling)
    tview = ttypes.working_view(tt(s["mask"]))
    tact = ts.gather_active(tt(s["A"]), tt(s["cx"]), tview, TDIMS, scaling)
    assert_tree_close(tact, ref_tree(s["act"]), ATOL, what="act")
    tFA = ts.factor_active(to_port(s["act"]), tt(np.asarray(s["gf"])),
                           tview.t, TDIMS)
    if case == "rank_deficient":
        # The reflector past rankA is built from a column that is zero
        # up to rounding: its direction is noise on both sides, and with
        # row scaling all live columns tie at norm 1 for the first pivot.
        # What is well defined is the factorization's own contract.
        from enlsip_tpu_torch.ops.blocked_qr import q_apply
        R = torch.zeros((N, L), dtype=torch.float64)
        R[:tFA.R.shape[0]] = tFA.R
        np.testing.assert_allclose(
            q_apply(tFA.f, R).numpy(),
            tact.A_act.t()[:, tFA.perm].numpy(), atol=ATOL)
        np.testing.assert_allclose(
            np.sort(np.abs(tFA.diag.numpy()))[::-1][:3],
            np.sort(np.abs(np.asarray(s["F_A"].diag)))[::-1][:3],
            atol=ATOL) if not scaling else None
        assert abs(float(tFA.diag[3])) < 1e-12
        np.testing.assert_allclose(
            torch.linalg.norm(tFA.qt_gf).item(),
            float(jnp.linalg.norm(s["gf"])), atol=ATOL)
        return
    assert_tree_close(tFA, ref_tree(s["F_A"]), ATOL, what="F_A")
    tFL = ts.factor_l11(to_port(s["F_A"]), to_port(s["act"]), tview.t)
    assert_tree_close(tFL, ref_tree(s["F_L11"]), ATOL, what="F_L11")


def test_zeros_factor_l11_shapes():
    z = ts.zeros_factor_l11(TDIMS, torch.float64, "cpu")
    jz = js.zeros_factor_l11(jtypes.Dims(N, M, Q, L), jnp.float64)
    assert_tree_close(z, ref_tree(jz), 0.0)


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_multiplier_estimates(case, scaling):
    s = _state(case, scaling)
    jlam, jgr = js.first_mult_estimate(s["F_A"], s["act"], s["view"].t,
                                       s["dims"], scaling, EPS_RANK)
    tFA, tact, t = to_port(s["F_A"]), to_port(s["act"]), tt(int(s["view"].t))
    tlam, tgr = ts.first_mult_estimate(tFA, tact, t, TDIMS, scaling, EPS_RANK)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), atol=ATOL)
    np.testing.assert_allclose(float(tgr), float(jgr), atol=ATOL)
    gn = s["gn"]
    jl2 = js.second_mult_estimate(s["F_A"], gn.JQ1, jnp.asarray(s["rx"]),
                                  jnp.asarray(s["J"]), gn.p, s["view"].t,
                                  s["act"], s["dims"], scaling)
    tl2 = ts.second_mult_estimate(tFA, tt(np.asarray(gn.JQ1)), tt(s["rx"]),
                                  tt(s["J"]), tt(np.asarray(gn.p)), t, tact,
                                  TDIMS, scaling)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_gn_search_direction(case):
    s = _state(case)
    tgn = ts.gn_search_direction(
        tt(s["J"]), tt(s["rx"]), to_port(s["act"]), to_port(s["F_A"]),
        to_port(s["F_L11"]), tt(int(s["rankA"])), tt(int(s["view"].t)),
        EPS_RANK, TDIMS)
    assert int(tgn.rankA) == int(s["gn"].rankA)
    assert int(tgn.rankJ2) == int(s["gn"].rankJ2)
    np.testing.assert_array_equal(tgn.F_J2.perm.numpy(),
                                  np.asarray(s["gn"].F_J2.perm))
    assert_tree_close(tgn, ref_tree(s["gn"]), ATOL, what="gn")


@pytest.mark.parametrize("dimA,dimJ2", [(1, 1), (2, 3), (0, 0)])
@pytest.mark.parametrize("case", ["full_rank", "rank_deficient"])
def test_sub_search_direction_subspace_dims(case, dimA, dimJ2):
    s = _state(case)
    gn, t = s["gn"], s["view"].t
    jout = js.sub_search_direction(
        s["act"], jnp.asarray(s["rx"]), s["F_A"], s["F_L11"], gn.F_J2, gn.JQ1,
        t, s["rankA"], jnp.int32(dimA), jnp.int32(dimJ2), jnp.int32(-1),
        s["dims"])
    tout = ts.sub_search_direction(
        to_port(s["act"]), tt(s["rx"]), to_port(s["F_A"]),
        to_port(s["F_L11"]), to_port(gn.F_J2), tt(np.asarray(gn.JQ1)),
        tt(int(t)), tt(int(s["rankA"])), tt(dimA), tt(dimJ2), -1, TDIMS)
    for a, b, name in zip(tout, jout, "pbdy"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("seed,dup", [(0, False), (1, False), (2, True)])
def test_hessian_contractions_and_newton_direction(seed, dup):
    """Exact second-order terms (torch.func reverse over reverse) against
    jax.hessian, then the Newton KKT step built on them."""
    jf, tf, x0, (n, m, q, l) = twin_functions(seed, 5, 8, 3, 1, dup_eq=dup)
    rng = np.random.default_rng(seed)
    lam_full = rng.normal(size=l)
    jr, jc = js.hessian_contractions(jf[0], jf[2], jnp.asarray(x0),
                                     jf[0](jnp.asarray(x0)),
                                     jnp.asarray(lam_full))
    tr, tc = ts.hessian_contractions(tf[0], tf[2], tt(x0), tf[0](tt(x0)),
                                     tt(lam_full))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)

    jd, td = jtypes.Dims(n, m, q, l), ttypes.Dims(n, m, q, l)
    x = jnp.asarray(x0)
    rx, J, cx, A = jf[0](x), jf[1](x), jf[2](x), jf[3](x)
    mask = np.arange(l) < q
    view = jtypes.working_view(jnp.asarray(mask))
    act = js.gather_active(A, cx, view, jd, False)
    F_A = js.factor_active(act, J.T @ rx, view.t, jd)
    rankA = jpseudo_rank(F_A.diag, view.t, EPS_RANK)
    F_L11 = js.factor_l11(F_A, act, view.t)
    gn = js.gn_search_direction(J, rx, act, F_A, F_L11, rankA, view.t,
                                EPS_RANK, jd)
    lam = jnp.asarray(rng.normal(size=l)) * act.valid
    jp, jerr = js.newton_search_direction(jf[0], jf[2], x, rx, lam, view, act,
                                          F_A, F_L11, gn.JQ1, rankA, view.t,
                                          jd)
    tp, terr = ts.newton_search_direction(
        tf[0], tf[2], tt(x0), tt(np.asarray(rx)), tt(np.asarray(lam)),
        to_port(view), to_port(act), to_port(F_A), to_port(F_L11),
        tt(np.asarray(gn.JQ1)), tt(int(rankA)), tt(int(view.t)), td)
    assert int(rankA) == (q - 1 if dup else q)
    assert bool(terr) == bool(jerr)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-8)
