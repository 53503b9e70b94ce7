"""The iteration body of a batch of solves in lockstep.

Counterpart of ``enlsip_tpu/core/batched.py``.  The JAX package gets a
batch from ``vmap`` over its per-lane body and adds batch-level gates
around the rare expensive sections.  PyTorch has no ``vmap`` that traces
data-dependent branches and loops, so here the per-lane math itself is
written over a leading lane axis (``_lanes.py``), and this module is
what remains: lifting the user's per-lane closures onto the batch, the
batch-level switch on the direction method, and the freeze rule.

Semantics: per lane, every value — x, exit code, iteration count,
evaluation counters — equals what :func:`driver.iterate_body` gives one
solve from the same carry.  A section that no LIVE lane needs (F_L11,
the second working-set round, the subspace and Newton directions, every
branch of the line search) is skipped for the whole batch; when some
lane needs it, it runs for the batch and a per-lane select keeps the
other lanes on their own values.  Lanes that have terminated are frozen
by :func:`batched_guarded_body`.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .._device import to_host_list
from .._lanes import dot, tree_where
from .direction import (AnalysResult, analysis_decide, newton_direction,
                        subspace_direction)
from .driver import (Functions, WorkingSetRound, _active_cx_sum,
                     _cx_sq_sum, _post_direction, _stall_hint,
                     _working_set_round)
from .subproblem import hessian_contractions
from .types import Carry, Dims, Options, Tols


def has_data(data) -> bool:
    return data is not None and len(pytree.tree_leaves(data)) > 0


def bind_data(fns: Functions, d) -> Functions:
    """Bind one lane's data into the user closures.

    With per-lane data, the ``Functions`` members take ``(x, data)``;
    binding turns them back into the ``(x)``-only closures the core
    solver calls (``res_trial(x, p, data)`` likewise).  No data returns
    ``fns`` unchanged."""
    if not has_data(d):
        return fns
    return Functions(res=lambda x: fns.res(x, d),
                     jac_res=lambda x: fns.jac_res(x, d),
                     cons=lambda x: fns.cons(x, d),
                     jac_cons=lambda x: fns.jac_cons(x, d),
                     res_trial=(None if fns.res_trial is None else
                                (lambda x, p: fns.res_trial(x, p, d))))


def lane_functions(fns: Functions, data=None) -> Functions:
    """The user's per-lane closures mapped over the lane axis
    (``torch.func.vmap``): each takes ``x`` (B, n) and evaluates lane i
    at ``x[i]`` with ``data`` sliced at i.  A ``res_trial`` factory is
    mapped as a whole: the lifted ``res_trial(x, p)(alpha)`` evaluates
    lane i's factory at ``(x[i], p[i])`` and its closure at ``alpha[i]``
    (the factory's ray set-up is therefore redone per trial; the hook's
    saving is a single solve's).  The factored-Jacobian members are not
    carried: a batch rejects them (``parallel.batch.init_batch``)."""
    if has_data(data):
        lift = lambda f: (lambda x: torch.func.vmap(f)(x, data))
    else:
        lift = lambda f: torch.func.vmap(f)
    res_trial = None
    if fns.res_trial is not None:
        if has_data(data):
            one = lambda x, p, a, d: fns.res_trial(x, p, d)(a)
            res_trial = lambda x, p: (
                lambda a: torch.func.vmap(one)(x, p, a, data))
        else:
            one = lambda x, p, a: fns.res_trial(x, p)(a)
            res_trial = lambda x, p: (lambda a: torch.func.vmap(one)(x, p, a))
    return Functions(lift(fns.res), lift(fns.jac_res), lift(fns.cons),
                     lift(fns.jac_cons), res_trial)


def lane_hessians(fns: Functions, data=None):
    """``hess(x, rx, lam_full) -> (r_mat, c_mat)`` for the batch: the
    exact Hessian contractions of every lane's own closures."""
    if has_data(data):
        def one(x, rx, lam_full, d):
            lf = bind_data(fns, d)
            return hessian_contractions(lf.res, lf.cons, x, rx, lam_full)
        return lambda x, rx, lam_full: torch.func.vmap(one)(x, rx, lam_full,
                                                            data)

    def one(x, rx, lam_full):
        return hessian_contractions(fns.res, fns.cons, x, rx, lam_full)
    return torch.func.vmap(one)


def batched_direction_analysis(x, rx, cx, active_cx_sum,
                               wsr: WorkingSetRound, alive, nb_iter, prev,
                               restart, dims: Dims, opts: Options,
                               rdims=None, hess=None) -> AnalysResult:
    """Batched ANALYS: GNDCHK per lane (cheap); the subspace and Newton
    directions only when some live lane selects them (one read-back for
    both gates)."""
    gn = wsr.gn
    rx_sum = dot(rx, rx)
    mc, beta = analysis_decide(cx, wsr.act, active_cx_sum, gn, wsr.view,
                               wsr.t, wsr.lam, nb_iter, prev, restart, False,
                               wsr.deleted, dims, opts.scaling, rdims)
    out = (gn.p, gn.b, gn.d, gn.rankA, gn.rankJ2, torch.ones_like(gn.rankA),
           torch.zeros_like(gn.rankA))

    sub_pred = (mc == -1) & alive
    newton_pred = (mc == 2) & alive
    any_sub, any_newton = to_host_list(torch.stack([torch.any(sub_pred),
                                                    torch.any(newton_pred)]))
    if any_sub:
        out = tree_where(sub_pred,
                         subspace_direction(rx, rx_sum, wsr.act,
                                            active_cx_sum, gn, wsr.F_A, wsr.t,
                                            prev, restart, dims),
                         out)
    if opts.second_derivatives:
        if any_newton:
            out = tree_where(newton_pred,
                             newton_direction(None, None, x, rx, wsr.lam,
                                              wsr.view, wsr.act, wsr.F_A,
                                              wsr.F_L11, gn, wsr.t, dims,
                                              rdims, hess=hess),
                             out)
    else:
        p, b, d, dimA, dimJ2, code, ec = out
        out = (p, b, d, dimA, dimJ2, torch.where(mc == 2, 2, code),
               torch.where(mc == 2, -4, ec))

    p, b, d, dimA, dimJ2, code, error_code = out
    newton_taken = (mc == 2) if opts.second_derivatives \
        else torch.zeros_like(alive)
    return AnalysResult(p=p, b=b, d=d, dimA=dimA, dimJ2=dimJ2, code=code,
                        beta=beta, speed=beta / prev.beta,
                        error_code=error_code, newton_taken=newton_taken)


def batched_iterate_body(carry: Carry, lfns: Functions, dims: Dims,
                         opts: Options, tols: Tols, rdims=None,
                         hess=None) -> Carry:
    """One batched ENLSIP iteration over a (B,)-leading carry; values
    per lane are identical to :func:`driver.iterate_body`.  ``lfns`` are
    the lane-mapped closures (:func:`lane_functions`), ``hess`` the
    lane-mapped Hessian contractions (:func:`lane_hessians`)."""
    alive = carry.exit_code == 0
    x, rx, cx, J, A, gf = (carry.x, carry.rx, carry.cx, carry.J, carry.A,
                           carry.gf)
    rx_sum_start = dot(rx, rx)
    cx_sum_start = _cx_sq_sum(cx, dims, rdims)

    # WRKSET: round 1 always; F_L11 and the second-order deletion round
    # only when some live lane needs them
    wsr = _working_set_round(carry.active_mask, A, cx, rx, J, gf,
                             carry.index_del, dims, opts, tols, rdims,
                             _stall_hint(carry, tols), lanes=alive)
    active_cx_sum = _active_cx_sum(wsr, cx, dims)

    ana = batched_direction_analysis(
        x, rx, cx, active_cx_sum, wsr, alive, carry.nb_iter, carry.prev,
        carry.restart, dims, opts, rdims, hess)

    return _post_direction(carry, lfns, dims, opts, tols, wsr, ana,
                           active_cx_sum, rx_sum_start, cx_sum_start, rdims,
                           lanes=alive)


def batched_guarded_body(carry: Carry, lfns: Functions, dims: Dims,
                         opts: Options, tols: Tols, rdims=None,
                         hess=None) -> Carry:
    """Freeze rule over the batched body: terminated lanes keep their
    carry unchanged."""
    new = batched_iterate_body(carry, lfns, dims, opts, tols, rdims, hess)
    return tree_where(carry.exit_code != 0, carry, new)
