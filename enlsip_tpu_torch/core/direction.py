"""Direction-method selection: GNDCHK, PREGN/PRESUB/DIMUPP/SUBSPC, ANALYS.

Counterpart of ``enlsip_tpu/core/direction.py``.  All magic constants
are the reference's.  "Dimensions" here are 1-based counts (as in the
reference); array buffers are 0-indexed, so count k reads buffer index
k-1.

The decision functions and the three direction branches are free of
control flow and take one solve's tensors or a batch's (leading lane
axes).  :func:`search_direction_analysis` is the single solve's switch
on the method code (``_lanes.switch``), which evaluates that one branch;
a batch switches in ``core/batched.py``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .._dist import rows_sum
from .._lanes import const, ex, put, switch, take1
from ..ops.qr import prefix_norm, solve_upper
from .subproblem import (ActiveConstraint, FactorA, FactorJ2, FactorL11,
                         GNResult, _embed, factor_l11, j2_transform_d,
                         newton_search_direction, sub_search_direction)
from .types import Dims, PrevIter, WorkingView, rdims_or
from ..utils.profiling import span


def check_gn_direction(b1nrm, d1nrm, d1nrm_as_km1, dnrm, active_c_sum,
                       iter_number: int, rankA, dims: Dims, restart,
                       constraint_added, constraint_deleted, t, lam, valid,
                       inact_cx_min, prev: PrevIter, scaling: bool,
                       diag_scale, rdims=None):
    """GNDCHK.  Returns (method_code, beta_k) with method_code in
    {1 (GN), -1 (subspace), 2 (Newton)}.

    ``inact_cx_min``: min over inactive constraints of cx (+inf if none)
    — the only thing the reference reads from the inactive set here."""
    rd = rdims_or(rdims, dims)
    n, m, q, l = rd.n, rd.m, rd.q, rd.l
    dev = b1nrm.device
    eps_rel = torch.finfo(b1nrm.dtype).eps
    delta, c1, c2, c3, c4, c5 = 0.1, 0.5, 0.1, 4.0, 10.0, 0.05
    beta_k = torch.sqrt(d1nrm ** 2 + b1nrm ** 2)
    as_b = lambda v: const(v, dev, torch.bool)
    restart, constraint_added, constraint_deleted = (
        as_b(restart), as_b(constraint_added), as_b(constraint_deleted))

    newton_or_restart = (prev.code == 2) | restart
    first_iter = as_b(iter_number == 0)
    submin_prev = prev.code == -1
    add_or_del = constraint_added | constraint_deleted
    conv_lower_c1 = beta_k < c1 * prev.beta
    progress_not_close = (prev.progress > c2 * prev.predicted_reduction) & \
        (dnrm <= c3 * beta_k)
    take_branch = newton_or_restart | (
        ~first_iter & (submin_prev |
                       ~(add_or_del | conv_lower_c1 | progress_not_close)))

    # ---- subspace/Newton branch -------------------------------------
    nonlin_k = torch.sqrt(d1nrm ** 2 + active_c_sum)
    nonlin_km1 = torch.sqrt(d1nrm_as_km1 ** 2 + active_c_sum)

    slot = torch.arange(lam.shape[-1], device=dev)
    ineq = (slot >= ex(q)) & (slot < ex(t))
    rows = (1.0 / diag_scale) if scaling else diag_scale
    sqr_eps = math.sqrt(eps_rel)
    lagrange_mult_cond = (
        torch.any(ineq & (lam * rows >= -sqr_eps), dim=-1) &
        torch.any(ineq & (lam < 0), dim=-1))
    to_reduce = (t > q) & lagrange_mult_cond
    to_reduce = to_reduce | ((l - t > 0) & (inact_cx_min < delta))

    newton_previously = (prev.code == 2) & ~constraint_deleted
    cond4 = active_c_sum > c2
    cond5 = constraint_deleted | constraint_added | to_reduce | \
        ((t == n) & (t == rankA))
    eps6 = max(1e-2, 10.0 * eps_rel)
    cond6 = ~(as_b(l == q) | (rankA <= t)) & \
        ~((beta_k < eps6 * dnrm) | ((b1nrm < eps6) & (m == n - t)))
    inner = newton_previously | ~(cond4 | cond5 | cond6)
    cond7 = ((prev.alpha < c5) & (nonlin_km1 < c2 * nonlin_k)) | (m == n - t)
    cond8 = ~(dnrm <= c4 * beta_k)
    newton = inner & (newton_previously | cond7 | cond8)

    method_code = torch.where(take_branch, torch.where(newton, 2, -1), 1)
    return method_code, beta_k


def _pregn(sd, sd_nrm, mindim, rh, rh_nrm, rank) -> torch.Tensor:
    """PREGN.  sd/rh are cumulative-norm buffers (0-indexed: count k ->
    index k-1); all dims are counts."""
    tau_max, rho_min = 0.2, 0.5
    C = sd.shape[-1]
    pm1 = rank - 1
    counts = torch.arange(1, C + 1, device=sd.device)
    cond = (sd >= tau_max * ex(sd_nrm)) | (rh <= rho_min * ex(rh_nrm))
    window = (counts > ex(mindim)) & (counts <= ex(pm1))
    # Descending walk from pm1 while cond holds: final k = pm1 minus the
    # length of the trailing all-true run of cond within the window.
    flags = window & cond
    inwin_rev = torch.flip(counts <= ex(pm1), (-1,))
    run = torch.cumprod((torch.flip(flags, (-1,)) | ~inwin_rev).to(torch.int64),
                        dim=-1)
    trailing = torch.sum(run * inwin_rev.to(torch.int64), dim=-1)
    k = torch.maximum(pm1 - trailing, mindim)
    sugg = torch.where(k > mindim, k, torch.maximum(mindim, pm1))
    return torch.where(mindim > pm1, mindim, sugg)


def _presub(sd, rh, rh_nrm, c1, rank, previous_dim, progress,
            predicted_linear_progress, prelin_previous_dim, previous_alpha
            ) -> torch.Tensor:
    """PRESUB."""
    stepb, pgb1, pgb2, predb, rlenb, c2 = 0.2, 0.3, 0.1, 0.7, 2.0, 100.0
    C = sd.shape[-1]

    def at(buf, count):  # 1-based count -> value, clamped
        return take1(buf, torch.clamp(count - 1, 0, C - 1))

    bad_step = (previous_alpha < stepb) & \
               (progress <= pgb1 * predicted_linear_progress ** 2) & \
               (progress <= pgb2 * prelin_previous_dim ** 2)
    dim_b = torch.clamp(previous_dim - 1, min=1)
    early = bad_step & (previous_dim > 1) & (at(rh, dim_b) > c1 * rh_nrm)

    dim = previous_dim
    grow_ok = (previous_dim < rank) & (
        ((at(rh, dim) > predb * rh_nrm) &
         (rlenb * at(sd, dim) < at(sd, dim + 1))) |
        (c2 * at(sd, dim) < at(sd, dim + 1)))
    i1 = previous_dim - 1
    # buff = {i in [i1, previous_dim] : rh[i] > predb*rh_nrm}; min or rank
    c_a = at(rh, i1) > predb * rh_nrm
    c_b = at(rh, previous_dim) > predb * rh_nrm
    from_buff = torch.where(c_a, i1, torch.where(c_b, previous_dim, rank))
    sugg = torch.where(grow_ok, dim, torch.where(i1 <= 0, rank, from_buff))
    return torch.where(early, dim_b, sugg)


def determine_solving_dim(previous_dim, rank, predicted_linear_progress,
                          obj_progress, prelin_previous_dim, diagR, y,
                          previous_alpha, restart) -> torch.Tensor:
    """DIMUPP.  ``diagR``: diagonal buffer of the triangular factor;
    ``y``: rhs buffer.  Returns the new dimension (count)."""
    C = diagR.shape[-1]
    dev = diagR.device
    i = torch.arange(C, device=dev)
    previous_dim = const(previous_dim, dev)
    rank = const(rank, dev)
    restart = const(restart, dev, torch.bool)
    yC = y[..., :C]
    live = i < ex(rank)
    zero = torch.zeros_like(yC)
    sd = torch.sqrt(torch.cumsum(torch.where(live, yC * yC, zero), dim=-1))
    safe_diag = torch.where(diagR.abs() > 0, diagR, torch.ones_like(diagR))
    rhterm = torch.where(live, yC / safe_diag, zero)
    rh = torch.sqrt(torch.cumsum(rhterm * rhterm, dim=-1))
    last = torch.clamp(rank - 1, 0, C - 1)
    sd_nrm = take1(sd, last)
    rh_nrm = take1(rh, last)
    # mindim maximizes psi_i = sqrt(sum_{j<=i} sd_j^2) * |R_ii| — the
    # reference accumulates the SQUARED CUMULATIVE norms, reproduced
    # verbatim.
    dsum = torch.cumsum(torch.where(live, sd * sd, zero), dim=-1)
    psi = torch.where(live, torch.sqrt(dsum) * diagR.abs(),
                      torch.full_like(zero, -math.inf))
    mindim = torch.argmax(psi, dim=-1) + 1  # first max, count

    was_gn = (previous_dim == rank) | (previous_dim <= 0)
    sugg_gn = _pregn(sd, sd_nrm, mindim, rh, rh_nrm, rank)
    sugg_sub = _presub(sd, rh, rh_nrm, 0.1, rank, previous_dim, obj_progress,
                       predicted_linear_progress, prelin_previous_dim,
                       previous_alpha)
    newdim_live = torch.maximum(mindim, torch.where(was_gn, sugg_gn, sugg_sub))
    newdim_restart = torch.clamp(torch.minimum(rank, previous_dim), min=0)
    newdim = torch.where(restart, newdim_restart, newdim_live)
    return torch.where(rank > 0, newdim, rank)


def choose_subspace_dimensions(rx_sum, rx, active_cx_sum, t, rankJ2, rankA,
                               F_L11: FactorL11, F_J2: FactorJ2,
                               JQ1, prev: PrevIter, restart, dims: Dims):
    """SUBSPC.  Returns (dimA, dimJ2)."""
    n, m, l, ka = dims.n, dims.m, dims.l, dims.ka
    dev = rx.device
    alpha_low = 0.2
    b = F_L11.qt_b                     # (l,)
    restart = const(restart, dev, torch.bool)

    # rankA > 0 branch
    previous_dimA = prev.dimA.abs() + t - prev.t
    nrm_b_asprev = prefix_norm(b, torch.clamp(previous_dimA, 0, l))
    nrm_b = prefix_norm(b, t)
    constraint_progress = prev.cx_sum - active_cx_sum
    dimA_pos = determine_solving_dim(previous_dimA, rankA, nrm_b,
                                     constraint_progress, nrm_b_asprev,
                                     F_L11.diag, b, prev.alpha, restart)
    dimA = torch.where(rankA > 0, dimA_pos, 0)
    previous_dimA = torch.where(rankA > 0, previous_dimA, 0)

    # d = -(rx + J1 p1), transformed by Q3^T.  When rankJ2 == 0, DIMUPP
    # returns 0 without reading d, so the transformed vector can be used
    # unconditionally.
    dp1 = solve_upper(F_L11.R[..., :ka, :ka], b[..., :ka], dimA)
    p1_full = put(torch.zeros_like(dp1), F_L11.perm, dp1)
    p1 = torch.where(torch.arange(ka, device=dev) < ex(rankA), p1_full,
                     torch.zeros_like(p1_full))
    d = j2_transform_d(F_J2, JQ1, _embed(p1, n), rx)

    previous_dimJ2 = prev.dimJ2.abs() + prev.t - t
    nrm_d_asprev = prefix_norm(d, torch.clamp(previous_dimJ2, 0, m))
    nrm_d = torch.sqrt(torch.sum(d * d, dim=-1))
    residual_progress = prev.rx_sum - rx_sum
    kk = min(m, n)
    dimJ2 = determine_solving_dim(previous_dimJ2, rankJ2, nrm_d,
                                  residual_progress, nrm_d_asprev,
                                  F_J2.diag, d[..., :kk], prev.alpha, restart)

    keep = (~restart) & (prev.alpha >= alpha_low)
    dimA = torch.where(keep, torch.maximum(dimA, previous_dimA), dimA)
    dimJ2 = torch.where(keep, torch.maximum(dimJ2, previous_dimJ2), dimJ2)
    return dimA, dimJ2


def analysis_decide(cx, act: ActiveConstraint, active_cx_sum, gn: GNResult,
                    view: WorkingView, t, lam, iter_number: int,
                    prev: PrevIter, restart, constraint_added,
                    constraint_deleted, dims: Dims, scaling: bool,
                    rdims=None):
    """The cheap front of ANALYS: direction norms + GNDCHK decision.
    Returns (method_code, beta)."""
    m, tmax = dims.m, dims.tmax
    rankA, rankJ2 = gn.rankA, gn.rankJ2
    nrm_b1 = prefix_norm(gn.b, rankA)         # dimA == rankA here
    nrm_d = torch.sqrt(torch.sum(gn.d * gn.d, dim=-1))
    nrm_d1 = prefix_norm(gn.d, rankJ2)
    prev_dimJ2m1 = prev.dimJ2 + prev.t - t - 1
    nrm_d1_asprev = prefix_norm(gn.d, torch.clamp(prev_dimJ2m1, 0, m))

    # min over inactive constraints of cx (GNDCHK's any(< delta))
    active = put(torch.zeros(dims.l, dtype=torch.bool, device=cx.device),
                 view.active_list[..., :tmax], act.valid)
    inact_cx_min = torch.min(torch.where(active,
                                         torch.full_like(cx, math.inf), cx),
                             dim=-1).values

    return check_gn_direction(
        nrm_b1, nrm_d1, nrm_d1_asprev, nrm_d, active_cx_sum, iter_number,
        rankA, dims, restart, constraint_added, constraint_deleted, t, lam,
        act.valid, inact_cx_min, prev, scaling, act.diag_scale, rdims)


def subspace_direction(rx, rx_sum, act: ActiveConstraint, active_cx_sum,
                       gn: GNResult, F_A: FactorA, t, prev: PrevIter,
                       restart, dims: Dims):
    """ANALYS's subspace-minimization branch.  F_L11 is needed here even
    when rankA == t (the host loop only computes it for the rank-deficient
    case), so it is refactored locally."""
    rankA, rankJ2 = gn.rankA, gn.rankJ2
    F_L11_b = factor_l11(F_A, act, t)
    dimA, dimJ2 = choose_subspace_dimensions(
        rx_sum, rx, active_cx_sum, t, rankJ2, rankA, F_L11_b, gn.F_J2,
        gn.JQ1, prev, restart, dims)
    p, b, d, _ = sub_search_direction(act, rx, F_A, F_L11_b, gn.F_J2,
                                      gn.JQ1, t, rankA, dimA, dimJ2, -1, dims)
    code = torch.where((dimA == rankA) & (dimJ2 == rankJ2), 1, -1)
    return p, b, d, dimA, dimJ2, code, torch.zeros_like(code)


def newton_direction(res_fn: Callable, cons_fn: Callable, x, rx, lam,
                     view: WorkingView, act: ActiveConstraint, F_A: FactorA,
                     F_L11: FactorL11, gn: GNResult, t, dims: Dims,
                     rdims=None, hess=None):
    """ANALYS's Newton branch when second derivatives are allowed."""
    n = rdims_or(rdims, dims).n
    p, err = newton_search_direction(res_fn, cons_fn, x, rx, lam, view, act,
                                     F_A, F_L11, gn.JQ1, gn.rankA, t, dims,
                                     rdims, hess)
    ec = torch.where(err, -3, 0)
    return p, gn.b, gn.d, -t, t - n, torch.full_like(ec, 2), ec


class AnalysResult(NamedTuple):
    p: torch.Tensor
    b: torch.Tensor          # (tmax,)
    d: torch.Tensor          # (m,)
    dimA: torch.Tensor
    dimJ2: torch.Tensor
    code: torch.Tensor
    beta: torch.Tensor
    speed: torch.Tensor
    error_code: torch.Tensor
    newton_taken: torch.Tensor   # bool, 0-d or per lane


def search_direction_analysis(res_fn: Callable, cons_fn: Callable,
                              x, rx, cx, act: ActiveConstraint,
                              active_cx_sum, gn: GNResult,
                              F_A: FactorA, F_L11: FactorL11,
                              view: WorkingView, t, lam, iter_number: int,
                              prev: PrevIter, restart, constraint_added,
                              constraint_deleted, dims: Dims,
                              scaling: bool, second_derivatives: bool,
                              rdims=None) -> AnalysResult:
    """ANALYS.  ONE of the three branches (GN, subspace, Newton) is
    evaluated, chosen by the method code through ``_lanes.switch`` (JAX:
    ``lax.switch``): a conditional node of the solve's graph, or one
    read-back in an eager loop.  Traced, the subspace and Newton branches
    are spans (``subspace``, ``newton``)."""
    rx_sum = rows_sum(torch.sum(rx * rx, dim=-1))
    rankA, rankJ2 = gn.rankA, gn.rankJ2

    method_code, beta = analysis_decide(
        cx, act, active_cx_sum, gn, view, t, lam, iter_number, prev, restart,
        constraint_added, constraint_deleted, dims, scaling, rdims)
    branch = torch.where(method_code == 1, 0,
                         torch.where(method_code == -1, 1, 2))
    const_ = lambda v: torch.full_like(method_code, v)

    def gn_branch():
        return (gn.p, gn.b, gn.d, rankA, rankJ2, const_(1), const_(0))

    def subspace_branch():
        with span("subspace", x.device):
            return subspace_direction(rx, rx_sum, act, active_cx_sum, gn,
                                      F_A, t, prev, restart, dims)

    def newton_branch():
        if second_derivatives:
            with span("newton", x.device):
                return newton_direction(res_fn, cons_fn, x, rx, lam, view,
                                        act, F_A, F_L11, gn, t, dims, rdims)
        return (gn.p, gn.b, gn.d, rankA, rankJ2, const_(2), const_(-4))

    p, b, d, dimA, dimJ2, code, error_code = switch(
        branch, [gn_branch, subspace_branch, newton_branch])

    return AnalysResult(p=p, b=b, d=d, dimA=dimA, dimJ2=dimJ2, code=code,
                        beta=beta, speed=beta / prev.beta,
                        error_code=error_code,
                        newton_taken=(method_code == 2) & second_derivatives)
