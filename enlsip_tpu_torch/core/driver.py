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
* The solve is device-resident, as the JAX package's jitted loop is:
  on a CUDA device :func:`solve` runs init, the loop over iterations
  (:func:`run_chunk`) and the packed result (:func:`_pack_result`) as
  ONE captured CUDA graph (``_graph``), replayed once and read back
  once; a finite time limit runs the same loop in chunks of a captured
  chunk graph (:func:`_run_chunk_graph`).  Every count and code of the
  carry is a device tensor.
* What is and is not free of control flow: the multiplier estimates,
  SIGNCH, GNDCHK/DIMUPP, TERCRI, UPBND and the three direction branches
  are pure tensor functions.  The factorization stage (F_L11 only where
  A is rank-deficient), WRKSET's second round, ANALYS's choice of
  direction, EUCMOD, EVADD and the whole line search DO branch and loop
  on data.  They do so through ``_lanes.cond`` / ``switch`` /
  ``while_loop``: for one solve ONE side runs, taken by a conditional
  node of the graph (or, in an eager loop, on one read-back); a batch
  runs in lockstep (skip the side no live lane takes, else compute both
  and select per lane).  So every function of this module takes either
  one solve's tensors or a batch's with a leading lane axis; ``lanes``
  is the batch's live-lane mask.  The batched counterparts of
  :func:`iterate_body` and :func:`solve` are in ``core/batched.py`` and
  ``parallel/batch.py``.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from .. import _graph
from .._device import resolve_device, to_host_list
from .._dist import row_mesh_in_scope, rows_dot, rows_sum, scope_key
from .._dist import warm as warm_collectives
from .._lanes import (cond, const, dot, ex, mtv, norm, take, take1,
                      tree_where, while_loop)
from ..ops.qr import pseudo_rank
from ..utils.profiling import span
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
    """gf = J^T rx; factored mode: base^T (s * rx).  (Row-sharded: this
    rank's rows' part summed over the ranks.)"""
    if fns.jac_base is not None:
        return rows_sum(mtv(fns.jac_base(), J[..., 0] * rx))
    return rows_sum(mtv(J, rx))


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
    tsqr_axis: Optional[str] = None


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
            rd.n - gn.rankA, const(rd.m, t.device)))
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
        factor = torch.where(t == 1, 1.0 + rows_dot(rx, rx), lam_abs_max)
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
    tall = _Tall(opts.tall_qr, jac_base, elide_jq1, opts.tsqr_axis)
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
        ex(const(rdims.l, cx.device))
    return torch.sum(torch.where(real, cx * cx, torch.zeros_like(cx)),
                     dim=-1)


def _count(flag):
    """A host bool or a bool tensor (0-d or per lane) as an increment."""
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
    seeds a batch (the count fields are then (B,) tensors, else 0-d)."""
    dev = resolve_device(device)
    with span("init", dev):
        x0 = torch.as_tensor(x0).to(device=dev, dtype=dtype)
        lead = tuple(x0.shape[:-1])
        rx, J, cx, A, counters = new_point(fns, x0, Counters.zeros(lead, dev))
        mask, w0, K = init_working_set(cx, A, x0, dims, rdims)
        f = lambda v: torch.full(lead, v, dtype=dtype, device=dev)
        i = lambda v: torch.full(lead, v, dtype=torch.int64, device=dev)
        prev = PrevIter(
            x=x0, rx_sum=rows_dot(rx, rx), cx_sum=_cx_sq_sum(cx, dims, rdims),
            t=torch.sum(mask, dim=-1), alpha=f(1.0), beta=f(0.0), code=i(1),
            w=w0, progress=f(0.0), predicted_reduction=f(0.0),
            rankA=i(0), rankJ2=i(0), dimA=i(0), dimJ2=i(0))
        return Carry(
            x=x0, rx=rx, cx=cx, J=J, A=A, gf=_grad_f(fns, J, rx),
            active_mask=mask, w=w0, K=K, prev=prev,
            restart=torch.zeros(lead, dtype=torch.bool, device=dev),
            index_del=i(-1), nb_newton_steps=i(0), nb_iter=i(0),
            exit_code=i(0), counters=counters,
            display=torch.zeros((*lead, opts.max_iter + 1, 5), dtype=dtype,
                                device=dev),
            n_display=i(0))


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
    rx_sum_start = rows_dot(rx, rx)
    cx_sum_start = _cx_sq_sum(cx, dims, rdims)

    # --- EVSCAL + WRKSET ------------------------------------------------
    jb = _jac_base(fns)
    # JQ1-write elision: safe exactly when the Newton branch (the only
    # true JQ1 reader) is off by option — see gn_search_direction.
    elide = jb is not None and not opts.second_derivatives
    with span("wrkset", x.device):
        wsr = _working_set_round(carry.active_mask, A, cx, rx, J, gf,
                                 carry.index_del, dims, opts, tols, rdims,
                                 _stall_hint(carry, tols), jac_base=jb,
                                 elide_jq1=elide)
    active_cx_sum = _active_cx_sum(wsr, cx, dims)

    # --- ANALYS ----------------------------------------------------------
    with span("analys", x.device):
        ana = search_direction_analysis(
            fns.res, fns.cons, x, rx, cx, wsr.act, active_cx_sum, wsr.gn,
            wsr.F_A, wsr.F_L11, wsr.view, wsr.t, wsr.lam, carry.nb_iter,
            carry.prev, carry.restart, False, wsr.deleted, dims,
            opts.scaling, opts.second_derivatives, rdims)
    return _post_direction(carry, fns, dims, opts, tols, wsr, ana,
                           active_cx_sum, rx_sum_start, cx_sum_start, rdims)


def _post_direction(carry: Carry, fns: Functions, dims: Dims, opts: Options,
                    tols: Tols, wsr: WorkingSetRound, ana, active_cx_sum,
                    rx_sum_start, cx_sum_start, rdims=None,
                    lanes=None) -> Carry:
    """Everything after ANALYS: STPLNG, the step, new_point, TERCRI and
    the bookkeeping (the reference's loop tail), with its codes and
    counts as device tensors and the bookkeeping by select (0-d for one
    solve; for a batch, ``carry.x`` (B, n), lane-mapped ``fns`` and
    ``lanes`` the live lanes, (B,))."""
    x, rx, cx, J, A = carry.x, carry.rx, carry.cx, carry.J, carry.A
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
    code = ana.code
    with span("stplng", x.device):
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
    rx_sum_new = rows_dot(rx_new, rx_new)

    # --- TERCRI and the bookkeeping ----------------------------------
    with span("tercri", x.device):
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

        # --- bookkeeping: display, EVADD, prev snapshot -------------------
        first = const(carry.nb_iter == 0, x.device)
        record = first | (exit_code == 0)
        upd = const(sl.updated_progress, x.device)
        progress_out = torch.where(upd, sl.progress, carry.prev.progress)
        predred_out = torch.where(upd, sl.predicted_reduction,
                                  carry.prev.predicted_reduction)
        objective = torch.where(first, rx_sum_start, rx_sum_new)
        row = torch.stack([objective, active_cx_sum, norm(ana.p), sl.alpha,
                           progress_out], dim=-1)
        mask_add, _added = evaluate_violated_constraints(
            cx_new, wsr.mask, sl.index_alpha_upp, dims, rdims)
        display = carry.display
        slot = torch.arange(display.shape[-2], device=x.device)
        here = ex(record) & (slot == ex(carry.nb_iter))
        display = torch.where(here[..., None], row[..., None, :], display)
        mask_final = torch.where(ex(record), mask_add, wsr.mask)

        prev_new = PrevIter(
            x=x, rx_sum=rx_sum_start, cx_sum=cx_sum_start, t=t,
            alpha=sl.alpha, beta=ana.beta, code=ana.code, w=sl.w,
            progress=progress_out, predicted_reduction=predred_out,
            rankA=wsr.gn.rankA, rankJ2=wsr.gn.rankJ2, dimA=ana.dimA,
            dimJ2=ana.dimJ2)

        return Carry(
            x=x_new, rx=rx_new, cx=cx_new, J=J_new, A=A_new, gf=gf_new,
            active_mask=mask_final, w=sl.w, K=sl.K, prev=prev_new,
            restart=restart_new, index_del=wsr.index_del,
            nb_newton_steps=nb_newton,
            nb_iter=carry.nb_iter + _count(record),
            exit_code=exit_code, counters=counters, display=display,
            n_display=carry.n_display + _count(record))


def guarded_body(carry: Carry, fns: Functions, dims: Dims, opts: Options,
                 tols: Tols, rdims=None) -> Carry:
    """Run one iteration unless the solve has already terminated (the
    freeze rule)."""
    new = iterate_body(carry, fns, dims, opts, tols, rdims)
    return tree_where(carry.exit_code != 0, carry, new)


def run_chunk(carry: Carry, fns: Functions, dims: Dims, opts: Options,
              tols: Tols, chunk, rdims=None) -> Carry:
    """Up to ``chunk`` iterations (an int or a 0-d device tensor) while
    the solve has not terminated: one WHILE node when captured, a loop
    with one read-back a trip when run eagerly."""
    start = carry.nb_iter

    def go(c):
        return (c.exit_code == 0) & (c.nb_iter - start < chunk)

    def body(c):
        with span("iteration", c.x.device):
            return iterate_body(c, fns, dims, opts, tols, rdims)

    return while_loop(go, body, carry)


# Layout of the packed result: [exit_code, f, nb_iter, n_display, the
# four counters, x (n), display ((max_iter + 1) * 5)], in the solve
# dtype (the integer fields are small and exact in float32).
_HEAD = 8


def _pack_result(carry: Carry, f) -> torch.Tensor:
    """Every field :func:`solve` reports in ONE buffer, so the result
    crosses to the host in one transfer."""
    dt = f.dtype
    cnt = carry.counters
    with span("pack", f.device):
        head = torch.stack([
            carry.exit_code.to(dt), f, carry.nb_iter.to(dt),
            carry.n_display.to(dt), cnt.nb_res.to(dt), cnt.nb_jacres.to(dt),
            cnt.nb_cons.to(dt), cnt.nb_jaccons.to(dt)])
        return torch.cat([head, carry.x, carry.display.reshape(-1)])


class SolveResult(NamedTuple):
    exit_code: int
    x: torch.Tensor
    f: float
    n_iter: int
    display: torch.Tensor
    n_display: int
    counters: Counters
    solving_time: float


def _unpack_result(flat: torch.Tensor, n: int,
                   start_time: float) -> SolveResult:
    """The result from a packed buffer: the host fields from ONE counted
    read-back of the buffer, x and the display as device tensors."""
    with span("readback"):
        head = to_host_list(flat[:_HEAD])
    with span("result"):
        exit_code, f, n_iter, n_display = (int(head[0]), float(head[1]),
                                           int(head[2]), int(head[3]))
        counters = Counters(*(int(v) for v in head[4:8]))
        return SolveResult(exit_code=exit_code,
                           x=flat[_HEAD:_HEAD + n].clone(), f=f,
                           n_iter=n_iter,
                           display=flat[_HEAD + n:].reshape(-1, 5).clone(),
                           n_display=n_display, counters=counters,
                           solving_time=time.time() - start_time)


def _warm(fns: Functions, x) -> None:
    """Every closure once at ``x``, eagerly (before a capture), and one
    collective of the row scope's mesh (NCCL's communicator)."""
    warm_collectives(row_mesh_in_scope(), x.device)
    new_point(fns, x, Counters.zeros())
    if fns.res_trial is not None:
        fns.res_trial(x, torch.zeros_like(x))(
            torch.zeros((), dtype=x.dtype, device=x.device))


def _static_key(fns: Functions, dims: Dims, opts: Options, dtype):
    """The static part of a solve graph's key, with the row scope's mesh
    (a graph captured inside one row scope holds its collectives)."""
    return (fns, dims, opts, dtype) + scope_key()


def _solve_full_graph(x0, tols: Tols, fns: Functions, dims: Dims,
                      opts: Options, dtype) -> torch.Tensor:
    """Init, the whole loop and the packed result as ONE device program
    (JAX ``_solve_full_jit``): the returned buffer is the graph's."""
    def full(x0, tols):
        with span("solve", x0.device):
            carry = init_carry(fns, x0, dims, opts, dtype, device=x0.device)
            carry = run_chunk(carry, fns, dims, opts, tols, opts.max_iter + 1)
            return _pack_result(carry, rows_dot(carry.rx, carry.rx))

    key = ("solve",) + _static_key(fns, dims, opts, dtype) + \
        _graph.shapes_key(x0)
    return _graph.run(key, full, (x0, tols), x0.device,
                      warm=lambda: _warm(fns, x0))


def _solve_carry_graph(x0, tols: Tols, fns: Functions, dims: Dims,
                       opts: Options, dtype):
    """Init and the whole loop as ONE device program returning the final
    carry and [exit code, iterations] (the row-sharded solve's: inside a
    row scope the capture holds every collective of the contractions
    over the rows).  The returned buffers are the graph's."""
    def full(x0, tols):
        with span("solve", x0.device):
            carry = init_carry(fns, x0, dims, opts, dtype, device=x0.device)
            carry = run_chunk(carry, fns, dims, opts, tols, opts.max_iter + 1)
            return carry, torch.stack([carry.exit_code, carry.nb_iter])

    key = ("solve_carry",) + _static_key(fns, dims, opts, dtype) + \
        _graph.shapes_key(x0)
    return _graph.run(key, full, (x0, tols), x0.device,
                      warm=lambda: _warm(fns, x0))


def _run_chunk_graph(carry: Carry, tols: Tols, chunk: torch.Tensor,
                     fns: Functions, dims: Dims, opts: Options) -> Carry:
    """Up to ``chunk`` iterations as a captured graph (JAX
    ``_run_chunk_jit``): ``chunk`` is a device scalar, so one graph
    serves every chunk size.  Returns the graph's carry buffers."""
    def step(carry, tols, chunk):
        with span("solve", carry.x.device):
            return run_chunk(carry, fns, dims, opts, tols, chunk)

    key = ("chunk",) + _static_key(fns, dims, opts, carry.x.dtype) + \
        _graph.shapes_key(carry)
    return _graph.run(key, step, (carry, tols, chunk), carry.x.device,
                      warm=lambda: _warm(fns, carry.x))


def _run_chunk_eager(carry: Carry, tols: Tols, chunk: torch.Tensor,
                     fns: Functions, dims: Dims, opts: Options) -> Carry:
    return run_chunk(carry, fns, dims, opts, tols, chunk)


def solve(fns: Functions, x0, dims: Dims, opts: Options, tols: Tols,
          time_limit: Optional[float] = None, dtype=None, device=None,
          on_iteration: Optional[Callable[[Carry], None]] = None,
          graph: bool = True) -> SolveResult:
    """Host-level solve: the device-resident loop and a wall-clock limit.

    Runs on ``device`` (default: the card; raises if there is none).
    With the default unlimited ``time_limit`` (``None`` / ``inf``) the
    whole solve is ONE replay of a captured graph (init, the loop, the
    packed result) and ONE read-back.  A finite limit, which a device
    loop cannot check against the clock, follows the JAX package's
    schedule: one measured iteration, then chunks of half the remaining
    budget at the measured time an iteration (one replay of the chunk
    graph and one read-back each); a limit that has run out before a
    chunk starts ends the solve with exit code -11.
    ``on_iteration(carry)`` is called after every iteration (chunks of
    one; tracing and tests).  On the CPU the same device-resident code
    runs eagerly with every read-back outside the control-flow helpers
    forbidden.  ``graph=False`` runs :func:`run_chunk` as an eager loop
    instead (one read-back a branch; the comparison for the graph)."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = x0.dtype if isinstance(x0, torch.Tensor) else torch.float64
    start_time = time.time()
    with span("prepare"):
        x0 = torch.as_tensor(x0).to(device=dev, dtype=dtype)
        tols = Tols(*(torch.as_tensor(v).to(device=dev, dtype=dtype)
                      for v in tols))
    unlimited = time_limit is None or time_limit == float("inf")
    with matmul_precision_scope(opts), _graph.linalg_scope(dev):
        if unlimited and on_iteration is None:
            with span("replay"):
                if graph:
                    flat = _solve_full_graph(x0, tols, fns, dims, opts, dtype)
                else:
                    carry = init_carry(fns, x0, dims, opts, dtype, device=dev)
                    carry = run_chunk(carry, fns, dims, opts, tols,
                                      opts.max_iter + 1)
                    flat = _pack_result(carry, rows_dot(carry.rx, carry.rx))
            return _unpack_result(flat, dims.n, start_time)
        runner = _run_chunk_graph if graph else _run_chunk_eager
        limit = float("inf") if unlimited else time_limit
        carry = init_carry(fns, x0, dims, opts, dtype, device=dev)
        per_iter, done = None, 0
        while True:
            remaining = limit - (time.time() - start_time)
            if remaining <= 0:
                carry = carry._replace(
                    exit_code=torch.full_like(carry.exit_code, -11))
                break
            if per_iter is None or on_iteration is not None:
                chunk = 1      # the measured chunk
            else:
                chunk = max(1, min(opts.max_iter + 1,
                                   int(0.5 * remaining / per_iter)))
            t0 = time.time()
            with span("replay"):
                carry = runner(carry, tols,
                               torch.full((), chunk, dtype=torch.int64,
                                          device=dev), fns, dims, opts)
            with span("readback"):
                exit_code, nb_iter = to_host_list(
                    torch.stack([carry.exit_code, carry.nb_iter]))
            measured = (time.time() - t0) / max(nb_iter - done, 1)
            done = nb_iter
            per_iter = measured if per_iter is None else max(
                0.5 * per_iter, measured)
            if on_iteration is not None:
                on_iteration(carry)
            if exit_code != 0:
                break
        flat = _pack_result(carry, rows_dot(carry.rx, carry.rx))
        return _unpack_result(flat, dims.n, start_time)
