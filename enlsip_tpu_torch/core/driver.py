"""One solver iteration and the host loop around it.

Counterpart of ``enlsip_tpu/core/driver.py`` (reference routines WRKSET,
orchestrated in :func:`_working_set_round`, and the ``enlsip`` main
loop).

Design notes:

* The reference unrolls the first iteration; here the loop body is
  uniform and the first-iteration special cases are encoded in the
  initial carry (see :func:`init_carry`).
* The reference's WRKSET deletes a constraint suggested by the
  first-order multipliers, recomputes the GN direction on the reduced
  set, applies a feasible-direction test that is constant-false in the
  reference source, re-adds the constraint and recomputes on the
  original set.  The only lasting effects are ``del = false`` and
  ``index_del = 0``; those are applied directly and the dead
  factorizations skipped.  Actual deletions flow through the
  second-order multiplier estimate, which is fully implemented.
* The loop runs on the host and takes a Python branch wherever the
  algorithm branches, evaluating one branch only; every such branch
  reads a scalar back from the device (``_device.to_host`` counts
  them).
* What is and is not free of control flow: the multiplier estimates,
  SIGNCH, GNDCHK/DIMUPP, TERCRI, UPBND and the three direction branches
  are pure tensor functions.  The factorization stage (F_L11 only where
  A is rank-deficient), WRKSET's second round, EUCMOD, EVADD and the
  whole line search DO branch and loop on data.  They do so through
  ``_lanes.cond`` / ``_lanes.while_loop``, which read a 0-d predicate
  back and evaluate one side for one solve, and run a batch in lockstep
  (skip the side no live lane takes, else compute both and select per
  lane).  So every function of this module takes either one solve's
  tensors or a batch's with a leading lane axis; ``lanes`` is the
  batch's live-lane mask.  The per-solve switch on the method code and
  the host-int bookkeeping live in :func:`iterate_body` /
  :func:`solve`; their batched counterparts are in ``core/batched.py``
  and ``parallel/batch.py``.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from .._device import resolve_device, to_host
from .._lanes import cond, dot, ex, mtv, norm, take, take1
from ..ops.qr import pseudo_rank
from .direction import search_direction_analysis
from .linesearch import compute_steplength
from .subproblem import (ActiveConstraint, FactorA, FactorL11, GNResult,
                         factor_active, factor_l11, first_mult_estimate,
                         gather_active, gn_search_direction,
                         second_mult_estimate, zeros_factor_l11)
from .termination import check_termination
from .types import (Carry, Counters, Dims, Options, PrevIter, Tols,
                    WorkingView, matmul_precision_scope, rdims_or,
                    working_view)
from .working_set import (check_constraint_deletion,
                          evaluate_violated_constraints, init_working_set,
                          minmax_lagrangian_mult)


class Functions(NamedTuple):
    """User callables on tensors (Jacobians resolved by the models
    layer): r(x) (m,), its Jacobian (m, n), c(x) (l,), its Jacobian
    (l, n).

    ``res_trial`` (optional): a directional-evaluation factory
    ``res_trial(x, p) -> (alpha -> r(x + alpha*p))`` for problems whose
    residual is cheap along a ray — e.g. r(x) = phi(W@x) with a giant
    (m, n) W: the factory computes W@x and W@p ONCE per step-length
    computation and every line-search trial costs O(m) instead of an
    O(m n) stream of W.  The default (None) is the black-box form
    ``lambda a: res(x + a*p)``.  Trial evaluations bump the residual
    counter exactly like the black box (it counts semantic evaluations
    of r).

    ``jac_rowscale`` / ``jac_base`` (optional, set together): a FACTORED
    residual Jacobian ``J(x) = diag(jac_rowscale(x)) @ jac_base()`` — the
    shape of every phi(W@x)-style fit, where J is a row-scaled constant
    matrix.  The solver then never materializes J: the carry's J slot
    holds the (m, 1) scale, the WY right-apply streams the base with the
    scale fused in the kernel (``ops/wy_hopper.py``), and J@v / J^T u
    become base products with O(m) scaling.  Single solves only
    (``init_carry`` / ``iterate_body`` / ``solve``); ``solve_batched``
    rejects it.  When set, ``jac_res`` may be None (it is not called)."""

    res: Callable
    jac_res: Optional[Callable]
    cons: Callable
    jac_cons: Callable
    res_trial: Optional[Callable] = None
    jac_rowscale: Optional[Callable] = None
    jac_base: Optional[Callable] = None


def new_point(fns: Functions, x, counters: Counters):
    """new_point!: evaluate r, J, c, A (4 evaluations).  The solve dtype
    (x's) is authoritative: user closures are cast at this boundary.  In
    factored mode the J slot holds the (m, 1) row scale."""
    dt = x.dtype
    rx = fns.res(x).to(dt)
    if fns.jac_rowscale is not None:
        J = fns.jac_rowscale(x).to(dt)[..., None]
    else:
        J = fns.jac_res(x).to(dt)
    cx = fns.cons(x).to(dt)
    A = fns.jac_cons(x).to(dt)
    return rx, J, cx, A, counters.bump(res=1, jacres=1, cons=1, jaccons=1)


def _jac_base(fns: Functions):
    return fns.jac_base() if fns.jac_base is not None else None


def _grad_f(fns: Functions, J, rx):
    """gf = J^T rx; factored mode: base^T (s * rx)."""
    if fns.jac_base is not None:
        return mtv(fns.jac_base(), J[..., 0] * rx)
    return mtv(J, rx)


class WorkingSetRound(NamedTuple):
    mask: torch.Tensor
    view: WorkingView
    t: torch.Tensor
    act: ActiveConstraint
    F_A: FactorA
    F_L11: FactorL11
    gn: GNResult
    lam: torch.Tensor
    grad_res: torch.Tensor
    deleted: object          # host bool, or a per-lane bool tensor
    index_del: torch.Tensor


def _factor_stage1(mask, A, cx, gf, dims: Dims, scaling: bool, eps_rank,
                   lanes=None):
    """Gather/scale the active set and factor A_act^T (F_A + rank), then
    F_L11 — only consumed on the rank-deficient (stabilized) path, so a
    branch computes it there (for a batch: when some live lane is
    rank-deficient) and hands the full-rank GN path a zeros placeholder
    whose downstream products are masked away.  (ANALYS's subspace
    branch, which needs F_L11 when rankA == t, recomputes it itself.)"""
    view = working_view(mask)
    t = view.t
    act = gather_active(A, cx, view, dims, scaling)
    F_A = factor_active(act, gf, t, dims)
    rankA = pseudo_rank(F_A.diag, t, eps_rank)
    F_L11 = cond(rankA < t,
                 lambda: factor_l11(F_A, act, t),
                 lambda: zeros_factor_l11(dims, F_A.R.dtype, F_A.R.device,
                                          mask.shape[:-1]),
                 lanes)
    return view, t, act, F_A, rankA, F_L11


class _Tall(NamedTuple):
    """How GNSRCH treats the residual Jacobian: the tall factorization
    (``Options.tall_qr``), the constant base of a factored Jacobian, and
    whether the JQ1 write is elided (see ``gn_search_direction``)."""

    tall_qr: str = "cholqr"
    jac_base: Optional[torch.Tensor] = None
    elide_jq1: bool = False


def _factor_and_gn(mask, A, cx, rx, J, gf, dims: Dims, scaling: bool,
                   eps_rank, rdims=None, lanes=None, tall=_Tall()):
    """One full factorization round: gather/scale -> F_A -> (F_L11) -> GN."""
    view, t, act, F_A, rankA, F_L11 = _factor_stage1(mask, A, cx, gf, dims,
                                                     scaling, eps_rank, lanes)
    gn = gn_search_direction(J, rx, act, F_A, F_L11, rankA, t, eps_rank, dims,
                             rdims, **tall._asdict())
    return view, t, act, F_A, F_L11, gn


class WSRound1(NamedTuple):
    """Everything the first WRKSET round produces, plus the decision
    inputs for the (rare) second-order deletion round."""

    view: WorkingView
    t: torch.Tensor
    act: ActiveConstraint
    F_A: FactorA
    F_L11: FactorL11
    gn: GNResult
    lam: torch.Tensor        # first estimate
    lam_sel: torch.Tensor    # lam2 on the full-rank path, else lam
    lam2: torch.Tensor
    grad_res: torch.Tensor
    s2: torch.Tensor
    do2: torch.Tensor
    index_del: torch.Tensor


def _ws_round1(mask, A, cx, rx, J, gf, index_del_in, dims: Dims,
               scaling: bool, tols: Tols, view, t, act, F_A, rankA,
               F_L11, rdims=None, stall_hint=True,
               rank_deficient_deletion: bool = True,
               tall=_Tall()) -> WSRound1:
    """WRKSET round 1 given stage-1 factorization results: GN direction,
    both multiplier estimates, and the round-2 decision.  Control-flow
    free apart from the dtype-static D13 block."""
    rd = rdims_or(rdims, dims)
    eps_rank = tols.eps_rank
    gn = gn_search_direction(J, rx, act, F_A, F_L11, rankA, t, eps_rank, dims,
                             rdims, **tall._asdict())
    lam, grad_res = first_mult_estimate(F_A, act, t, dims, scaling, eps_rank)
    s = check_constraint_deletion(rd.q, lam, act.valid, t, scaling,
                                  act.diag_scale, grad_res)
    # Lasting effect of the (always rolled back) first-order deletion
    # detour: del := false, index_del := none.
    index_del = torch.where(s >= 0, -1, index_del_in)

    # Second-order estimate round: only when the factorizations are
    # full-rank.
    full_rank = (t == gn.rankA) & \
        (gn.rankJ2 == torch.minimum(
            rd.n - gn.rankA, torch.as_tensor(rd.m, device=t.device)))
    lam2 = second_mult_estimate(F_A, gn.JQ1, rx, J, gn.p, t, act, dims,
                                scaling, F_J2=gn.F_J2, y_gn=gn.y,
                                jac_base=tall.jac_base)
    lam_sel = torch.where(ex(full_rank), lam2, lam)
    s2 = check_constraint_deletion(rd.q, lam2, act.valid, t, scaling,
                                   act.diag_scale,
                                   torch.zeros((), dtype=rx.dtype,
                                               device=rx.device))
    do2 = full_rank & (s2 >= 0)
    if rank_deficient_deletion and \
            torch.finfo(rx.dtype).eps > torch.finfo(torch.float64).eps:
        # D13 (float32 robustness): rank-deficient second-order deletion.
        # The reference's deletion gate requires FULL-RANK factorizations
        # (the ``full_rank`` condition above).  At float64 that gate
        # opens at every stationary point reached; at float32 a
        # pseudo-rank can drop AT the optimum, and an iterate holding a
        # genuinely negative inequality multiplier there is deadlocked:
        # TERCRI's necessary conditions fail on sigma_min forever (the
        # multiplier can only leave through this gate).  When the iterate
        # already satisfies EVERY OTHER necessary first-order condition
        # (feasible active + inactive sets, small projected gradient),
        # the second estimate still flags a negative multiplier, AND the
        # solve shows stall evidence (``stall_hint``: the last two steps
        # moved x by < eps_x relative), the deletion is performed despite
        # the deficient rank.  Far from stationarity nothing changes;
        # float64 is untouched (dtype-static branch).
        zero_s = torch.zeros_like(act.cx_act)
        act_cx_nrm = torch.sqrt(torch.sum(torch.where(
            act.valid, act.cx_act * act.cx_act, zero_s), dim=-1))
        stationary = (act_cx_nrm < tols.eps_c) & \
            (grad_res < torch.sqrt(tols.eps_rel) * (1 + norm(gf)))
        inact = ~mask
        inact_ok = torch.all(torch.where(inact, cx > 0.0,
                                         torch.ones_like(inact)), dim=-1)
        stationary = stationary & ((torch.sum(inact, dim=-1) == 0) | inact_ok)
        sigma_min, lam_abs_max = minmax_lagrangian_mult(
            lam, act.valid, t, rd.q, scaling, act.diag_scale)
        factor = torch.where(t == 1, 1.0 + dot(rx, rx), lam_abs_max)
        neg_block = (t > rd.q) & (sigma_min < tols.eps_rel * factor)
        deadlock = (stationary & neg_block & ~full_rank & (s2 >= 0) &
                    stall_hint)
        do2 = do2 | deadlock
    return WSRound1(view=view, t=t, act=act, F_A=F_A, F_L11=F_L11, gn=gn,
                    lam=lam, lam_sel=lam_sel, lam2=lam2, grad_res=grad_res,
                    s2=s2, do2=do2, index_del=index_del)


def _ws_round2(r1: WSRound1, mask, A, cx, rx, J, gf, dims: Dims,
               scaling: bool, eps_rank, rdims=None, lanes=None,
               tall=_Tall()):
    """WRKSET second-order deletion round: drop the suggested constraint
    and re-run the full factorization chain."""
    s2c = torch.clamp(r1.s2, min=0)
    gidx = take1(r1.view.active_list, s2c)
    mask2 = mask & (torch.arange(dims.l, device=mask.device) != ex(gidx))
    view2, t2, act2, F_A2, F_L11_2, gn2 = _factor_and_gn(
        mask2, A, cx, rx, J, gf, dims, scaling, eps_rank, rdims, lanes, tall)
    # Compact lam2: new slot j maps to old slot j (+1 past s2).
    tmax = dims.tmax
    j = torch.arange(tmax, device=mask.device)
    lam_c = torch.where(j < ex(s2c), r1.lam2,
                        r1.lam2[..., torch.clamp(j + 1, max=tmax - 1)])
    lam_c = torch.where(act2.valid, lam_c, torch.zeros_like(lam_c))
    return WorkingSetRound(mask=mask2, view=view2, t=t2, act=act2, F_A=F_A2,
                           F_L11=F_L11_2, gn=gn2, lam=lam_c,
                           grad_res=r1.grad_res, deleted=True,
                           index_del=gidx)


def _ws_keep(r1: WSRound1, mask) -> WorkingSetRound:
    """WRKSET's result when the second round does not run."""
    return WorkingSetRound(mask=mask, view=r1.view, t=r1.t, act=r1.act,
                           F_A=r1.F_A, F_L11=r1.F_L11, gn=r1.gn,
                           lam=r1.lam_sel, grad_res=r1.grad_res,
                           deleted=False, index_del=r1.index_del)


def _working_set_round(mask, A, cx, rx, J, gf, index_del_in, dims: Dims,
                       opts: Options, tols: Tols, rdims=None,
                       stall_hint=True, lanes=None, jac_base=None,
                       elide_jq1: bool = False) -> WorkingSetRound:
    """WRKSET, see the module docstring for the branch analysis.  For a
    batch, round 1 always runs; F_L11 and the second-order deletion
    round run only when some live lane (``lanes``) needs them, and the
    other lanes keep their round-1 values.  ``jac_base`` / ``elide_jq1``:
    factored-Jacobian mode, see ``gn_search_direction``."""
    scaling = opts.scaling
    eps_rank = tols.eps_rank
    tall = _Tall(opts.tall_qr, jac_base, elide_jq1)
    view, t, act, F_A, rankA, F_L11 = _factor_stage1(mask, A, cx, gf, dims,
                                                     scaling, eps_rank, lanes)
    r1 = _ws_round1(mask, A, cx, rx, J, gf, index_del_in, dims, scaling,
                    tols, view, t, act, F_A, rankA, F_L11, rdims, stall_hint,
                    opts.rank_deficient_deletion, tall)
    return cond(r1.do2,
                lambda: _ws_round2(r1, mask, A, cx, rx, J, gf, dims, scaling,
                                   eps_rank, rdims,
                                   None if lanes is None else lanes & r1.do2,
                                   tall),
                lambda: _ws_keep(r1, mask), lanes)


def _cx_sq_sum(cx, dims: Dims, rdims):
    """||cx||^2 over each lane's true l constraints (the reference's
    dot(cx, cx)); the padding rows of a heterogeneous fused batch, which
    hold ``PAD_CX``, are left out.  Without ``rdims`` it is dot(cx, cx)."""
    if rdims is None:
        return dot(cx, cx)
    real = torch.arange(dims.l, device=cx.device) < \
        ex(torch.as_tensor(rdims.l, device=cx.device))
    return torch.sum(torch.where(real, cx * cx, torch.zeros_like(cx)),
                     dim=-1)


def _count(flag):
    """A host bool or a per-lane bool tensor as an increment."""
    return flag.to(torch.int64) if isinstance(flag, torch.Tensor) \
        else int(flag)


def init_carry(fns: Functions, x0, dims: Dims, opts: Options, dtype,
               rdims=None, device=None) -> Carry:
    """Seed the carry so the uniform loop body reproduces the reference's
    unrolled first iteration.  The previous-iteration snapshot fields
    only need the values the first body actually reads: alpha = 1.0,
    beta = 0, code = 1, w = INIALC weights,
    progress = predicted_reduction = 0, x = x0.

    ``x0`` (n,) seeds one solve; ``x0`` (B, n) with lane-mapped ``fns``
    seeds a batch (the host-int fields become (B,) tensors)."""
    dev = resolve_device(device)
    x0 = torch.as_tensor(x0).to(device=dev, dtype=dtype)
    lead = tuple(x0.shape[:-1])
    rx, J, cx, A, counters = new_point(fns, x0, Counters.zeros(lead, dev))
    mask, w0, K = init_working_set(cx, A, x0, dims, rdims)
    f = lambda v: torch.full(lead, v, dtype=dtype, device=dev)
    i = lambda v: torch.full(lead, v, dtype=torch.int64, device=dev)
    host = (lambda v: i(v)) if lead else (lambda v: v)
    prev = PrevIter(
        x=x0, rx_sum=dot(rx, rx), cx_sum=_cx_sq_sum(cx, dims, rdims),
        t=torch.sum(mask, dim=-1), alpha=f(1.0), beta=f(0.0), code=i(1), w=w0,
        progress=f(0.0), predicted_reduction=f(0.0),
        rankA=i(0), rankJ2=i(0), dimA=i(0), dimJ2=i(0))
    return Carry(
        x=x0, rx=rx, cx=cx, J=J, A=A, gf=_grad_f(fns, J, rx),
        active_mask=mask, w=w0, K=K, prev=prev,
        restart=torch.zeros(lead, dtype=torch.bool, device=dev),
        index_del=i(-1), nb_newton_steps=host(0), nb_iter=host(0),
        exit_code=host(0), counters=counters,
        display=torch.zeros((*lead, opts.max_iter + 1, 5), dtype=dtype,
                            device=dev),
        n_display=host(0))


def _stall_hint(carry: Carry, tols: Tols):
    """D13 stall evidence (float32 only; see _ws_round1): the last two
    steps moved x by less than eps_x relative — prev.x spans two steps,
    same as TERCRI's x_diff."""
    x_diff_prev = norm(carry.prev.x - carry.x)
    return (x_diff_prev < tols.eps_x * (1.0 + norm(carry.x))) \
        & (carry.nb_iter >= 2)


def _active_cx_sum(wsr: WorkingSetRound, cx, dims: Dims):
    act_idx = wsr.view.active_list[..., :dims.tmax]
    return torch.sum(torch.where(wsr.act.valid, take(cx, act_idx) ** 2,
                                 torch.zeros((), dtype=cx.dtype,
                                             device=cx.device)), dim=-1)


def iterate_body(carry: Carry, fns: Functions, dims: Dims, opts: Options,
                 tols: Tols, rdims=None) -> Carry:
    """One full ENLSIP iteration of ONE solve (the reference loop body,
    which is also its unrolled first iteration)."""
    x, rx, cx, J, A, gf = (carry.x, carry.rx, carry.cx, carry.J, carry.A,
                           carry.gf)
    rx_sum_start = dot(rx, rx)
    cx_sum_start = _cx_sq_sum(cx, dims, rdims)

    # --- EVSCAL + WRKSET ------------------------------------------------
    jb = _jac_base(fns)
    # JQ1-write elision: safe exactly when the Newton branch (the only
    # true JQ1 reader) is off by option — see gn_search_direction.
    elide = jb is not None and not opts.second_derivatives
    wsr = _working_set_round(carry.active_mask, A, cx, rx, J, gf,
                             carry.index_del, dims, opts, tols, rdims,
                             _stall_hint(carry, tols), jac_base=jb,
                             elide_jq1=elide)
    active_cx_sum = _active_cx_sum(wsr, cx, dims)

    # --- ANALYS ----------------------------------------------------------
    ana = search_direction_analysis(
        fns.res, fns.cons, x, rx, cx, wsr.act, active_cx_sum, wsr.gn,
        wsr.F_A, wsr.F_L11, wsr.view, wsr.t, wsr.lam, carry.nb_iter,
        carry.prev, carry.restart, False, wsr.deleted, dims, opts.scaling,
        opts.second_derivatives, rdims)
    return _post_direction(carry, fns, dims, opts, tols, wsr, ana,
                           active_cx_sum, rx_sum_start, cx_sum_start, rdims)


def _post_direction(carry: Carry, fns: Functions, dims: Dims, opts: Options,
                    tols: Tols, wsr: WorkingSetRound, ana, active_cx_sum,
                    rx_sum_start, cx_sum_start, rdims=None,
                    lanes=None) -> Carry:
    """Everything after ANALYS: STPLNG, the step, new_point, TERCRI and
    the bookkeeping (the reference's loop tail).  One solve keeps its
    codes and counts as host ints and does the bookkeeping under a host
    branch; a batch (``carry.x`` (B, n), lane-mapped ``fns``, ``lanes``
    the live lanes) keeps them as (B,) tensors and selects per lane."""
    x, rx, cx, J, A = carry.x, carry.rx, carry.cx, carry.J, carry.A
    batched = x.ndim > 1
    t = wsr.t
    act_idx = wsr.view.active_list[..., :dims.tmax]
    # The reference bumps the residual/constraint counters through its
    # finite-difference Hessians; the AD Hessians count as one each.
    n_newton = _count(ana.newton_taken)
    counters = carry.counters.bump(res=n_newton, cons=n_newton)
    nb_newton = carry.nb_newton_steps + n_newton

    # --- STPLNG ----------------------------------------------------------
    if fns.res_trial is not None:
        res_trial = fns.res_trial
    else:       # black-box default: res at the trial point
        res_trial = lambda xx, pp: (
            lambda a: fns.res(xx + ex(a.to(xx.dtype)) * pp))
    code = ana.code if batched else int(to_host(ana.code))
    sl = compute_steplength(
        res_trial, fns.cons, x, rx, J, cx, A, wsr.act, wsr.view, t,
        ana.p, ana.dimA, wsr.gn.rankJ2, code, wsr.index_del,
        carry.prev, carry.K, wsr.mask, dims, opts.weight_code, counters,
        opts.linesearch_max_refine, opts.gac_max_halvings,
        opts.eucmod_max_passes, opts.scaling, lanes,
        jac_base=_jac_base(fns))
    counters = sl.counters

    # --- step + new point --------------------------------------------
    x_new = x + ex(sl.alpha) * ana.p
    rx_new, J_new, cx_new, A_new, counters = new_point(fns, x_new, counters)
    gf_new = _grad_f(fns, J_new, rx_new)
    rx_sum_new = dot(rx_new, rx_new)
    restart_new = ana.error_code < 0

    sigma_min, lam_abs_max = minmax_lagrangian_mult(
        wsr.lam, wsr.act.valid, t, rdims_or(rdims, dims).q, opts.scaling,
        wsr.act.diag_scale)

    # NOTE: the reference copies previous_iter BEFORE refreshing iter.x,
    # so the prev_iter.x TERCRI reads in body k is the PREVIOUS body's
    # starting point: x_diff spans TWO steps.  carry.prev.x holds exactly
    # that point (and x0 in the first body).
    exit_code = check_termination(
        ana.p, ana.code, restart_new, wsr.deleted, ana.d, ana.dimJ2,
        wsr.grad_res, wsr.act.cx_act, wsr.act.A_act, wsr.act.valid, t,
        x_new, carry.prev.x, cx_new, wsr.mask, rx_sum_new, gf_new,
        carry.nb_iter, opts.max_iter, tols, ana.error_code, sigma_min,
        lam_abs_max, sl.psi_error, nb_newton, sl.w, act_idx, dims, rdims)
    if not batched:
        exit_code = int(to_host(exit_code))

    # --- bookkeeping: display, EVADD, prev snapshot -------------------
    first = carry.nb_iter == 0
    record = first | (exit_code == 0)
    upd = torch.as_tensor(sl.updated_progress, device=x.device)
    progress_out = torch.where(upd, sl.progress, carry.prev.progress)
    predred_out = torch.where(upd, sl.predicted_reduction,
                              carry.prev.predicted_reduction)
    display, mask_final = carry.display, wsr.mask
    if batched or record:
        objective = torch.where(first, rx_sum_start, rx_sum_new) if batched \
            else (rx_sum_start if first else rx_sum_new)
        row = torch.stack([objective, active_cx_sum, norm(ana.p), sl.alpha,
                           progress_out], dim=-1)
        mask_add, _added = evaluate_violated_constraints(
            cx_new, wsr.mask, sl.index_alpha_upp, dims, rdims)
        if batched:
            slot = torch.arange(display.shape[-2], device=x.device)
            here = ex(record) & (slot == ex(carry.nb_iter))
            display = torch.where(here[..., None], row[..., None, :], display)
            mask_final = torch.where(ex(record), mask_add, wsr.mask)
        else:
            # in-place row assignment: the display buffer belongs to the
            # carry
            display[carry.nb_iter] = row
            mask_final = mask_add

    prev_new = PrevIter(
        x=x, rx_sum=rx_sum_start, cx_sum=cx_sum_start, t=t, alpha=sl.alpha,
        beta=ana.beta, code=ana.code, w=sl.w, progress=progress_out,
        predicted_reduction=predred_out, rankA=wsr.gn.rankA,
        rankJ2=wsr.gn.rankJ2, dimA=ana.dimA, dimJ2=ana.dimJ2)

    return Carry(
        x=x_new, rx=rx_new, cx=cx_new, J=J_new, A=A_new, gf=gf_new,
        active_mask=mask_final, w=sl.w, K=sl.K, prev=prev_new,
        restart=restart_new, index_del=wsr.index_del,
        nb_newton_steps=nb_newton,
        nb_iter=carry.nb_iter + _count(record),
        exit_code=exit_code, counters=counters, display=display,
        n_display=carry.n_display + _count(record))


class SolveResult(NamedTuple):
    exit_code: int
    x: torch.Tensor
    f: float
    n_iter: int
    display: torch.Tensor
    n_display: int
    counters: Counters
    solving_time: float


def solve(fns: Functions, x0, dims: Dims, opts: Options, tols: Tols,
          time_limit: Optional[float] = None, dtype=None, device=None,
          on_iteration: Optional[Callable[[Carry], None]] = None
          ) -> SolveResult:
    """Host-level solve: the iteration loop with a wall-clock limit.

    Runs on ``device`` (default: the card; raises if there is none).
    Like the reference, the loop reads the clock every iteration;
    ``time_limit`` (seconds; ``None`` = unlimited) that has run out
    before an iteration starts ends the solve with exit code -11.
    ``on_iteration(carry)`` is called after every iteration (tracing and
    tests)."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = x0.dtype if isinstance(x0, torch.Tensor) else torch.float64
    start_time = time.time()
    limit = float("inf") if time_limit is None else time_limit
    tols = Tols(*(torch.as_tensor(v).to(device=dev, dtype=dtype)
                  for v in tols))
    with matmul_precision_scope(opts):
        carry = init_carry(fns, x0, dims, opts, dtype, device=dev)
        while carry.exit_code == 0:
            if time.time() - start_time >= limit:
                carry = carry._replace(exit_code=-11)
                break
            carry = iterate_body(carry, fns, dims, opts, tols)
            if on_iteration is not None:
                on_iteration(carry)
        f = float(dot(carry.rx, carry.rx))
    return SolveResult(exit_code=carry.exit_code, x=carry.x, f=f,
                       n_iter=carry.nb_iter, display=carry.display,
                       n_display=carry.n_display, counters=carry.counters,
                       solving_time=time.time() - start_time)
