"""Penalty-weight updates for the merit function.

Counterpart of ``enlsip_tpu/core/weights.py``.  Reference routines:
ASSORT, EUCMOD (min_norm_w!), EUCNRM, MAXNRM, WEIGHT.

Weights live in a global (l,) vector; the top-4 history K is a (4, l)
array (the reference's 4 separate vectors).  Active-slot quantities are
(tmax,) buffers aligned with the sorted active list.  All of them may
carry leading lane axes (a batch); per-lane scalars are 0-d or ``(B,)``.
"""

from __future__ import annotations

import math

import torch

from .._dist import rows_sums
from .._lanes import cond, dot, ex, put, take, take1, while_loop
from .types import Dims, acc as _acc


def assort(K: torch.Tensor, w: torch.Tensor, active_global: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """ASSORT: insert w[k] into each active constraint's descending
    top-4 history.  Equivalent to appending and keeping the largest 4
    (ties resolve identically because insertion requires strict >)."""
    upd = put(torch.zeros_like(valid), active_global, valid)
    stacked = torch.cat([K, w[..., None, :]], dim=-2)            # (5, l)
    top4 = torch.sort(stacked, dim=-2, descending=True).values[..., :4, :]
    return torch.where(upd[..., None, :], top4, K)


def _eucmod_pass(state, yn, y_norm, w_old_slots, ctrl: int, eps: float):
    """One clipping pass of EUCMOD (control-flow free)."""
    w_slots, running, tau_new, s, y_sum = state
    tau_new = tau_new - s
    neg_inf = torch.full_like(yn, -math.inf)
    yinf = torch.max(torch.where(running, yn.abs(), neg_inf), dim=-1).values
    one = torch.ones_like(y_sum)
    c = torch.where(yinf <= eps, one,
                    tau_new / torch.where(y_sum != 0, y_sum, one))
    buff = ex(c) * yn * ex(y_norm)
    ok = running & (buff >= w_old_slots)
    zero = torch.zeros_like(yn)
    w_slots = torch.where(ok, buff, w_slots)
    s_new = torch.sum(torch.where(running & ~ok,
                                  w_old_slots * yn * ex(y_norm), zero),
                      dim=-1)
    y_sum_new = torch.sum(torch.where(ok, yn * yn, zero), dim=-1) \
        * y_norm * y_norm
    n_before = torch.sum(running, dim=-1)
    n_after = torch.sum(ok, dim=-1)
    stop = (n_after <= 0) | (n_after == n_before)
    if ctrl == 2:
        stop = torch.ones_like(stop)
    return (w_slots, ok, tau_new, s_new, y_sum_new), stop


def min_norm_w(ctrl: int, w_old_global: torch.Tensor, y_slots: torch.Tensor,
               tau: torch.Tensor, pos: torch.Tensor,
               active_global: torch.Tensor, max_passes: int,
               lanes=None) -> torch.Tensor:
    """EUCMOD: min ||w|| s.t. w >= w_old and <y, w> {=,>=} tau.

    Operates on slot-aligned buffers: ``y_slots`` (tmax,), ``pos`` the
    candidate mask, ``active_global`` the slot -> constraint-index map.
    Returns the new global weight vector (= w_old everywhere except the
    clipped candidates).

    ctrl == 2 performs a single clipping pass and takes no host branch
    (with no candidate the pass changes nothing that survives the final
    mask); ctrl == 1 iterates on the host until no candidate is removed,
    at most ``max_passes`` passes in all.  ``lanes`` (batch only): the
    lanes whose result is taken; the others do not keep the loop going."""
    dtype = w_old_global.dtype
    eps = torch.finfo(dtype).eps
    w_old_slots = take(w_old_global, active_global)
    zero = torch.zeros_like(y_slots)
    y_sum0 = torch.sum(torch.where(pos, y_slots * y_slots, zero), dim=-1)
    y_norm = torch.sqrt(y_sum0)
    yn = torch.where(ex(y_norm != 0),
                     y_slots / ex(torch.where(y_norm != 0, y_norm,
                                              torch.ones_like(y_norm))),
                     y_slots)
    state = (w_old_slots, pos, tau, torch.zeros_like(y_sum0), y_sum0)
    state, stop = _eucmod_pass(state, yn, y_norm, w_old_slots, ctrl, eps)
    if ctrl != 2:
        # (with no candidate every pass is a no-op on the masked result,
        # so the reference's nb_pos > 0 entry test needs no branch)
        go = (lambda s: ~s[1]) if lanes is None else \
            (lambda s: ~s[1] & lanes)
        state, stop = while_loop(
            go, lambda s: _eucmod_pass(s[0], yn, y_norm, w_old_slots, ctrl,
                                       eps),
            (state, stop), max_trips=max_passes - 1)
    w_slots = state[0]
    return put(w_old_global, active_global,
               torch.where(pos, w_slots, w_old_slots))


def euclidean_norm_weight_update(vA: torch.Tensor, cx: torch.Tensor,
                                 active_global: torch.Tensor,
                                 valid: torch.Tensor, t, mu: torch.Tensor,
                                 dimA, previous_w: torch.Tensor,
                                 K: torch.Tensor, dims: Dims, max_passes: int):
    """EUCNRM.  vA = active_Ap (slot buffer), cx = full constraint
    values.  Returns (w, K_updated)."""
    zero = torch.zeros_like(vA)
    z = torch.where(valid, vA * vA, zero)
    w_old = K[..., 3, :]  # 4th-largest history, per constraint
    w_old_act = take(w_old, active_global)
    cx_act = take(cx, active_global)
    ztw = torch.sum(torch.where(valid, z * w_old_act, zero), dim=-1)
    ge = ztw >= mu
    lt_t = dimA < t

    # Branch 1: ztw >= mu, dimA < t
    y1 = torch.where(valid, vA * (vA + cx_act), zero)
    pos1 = valid & (y1 > 0)
    gamma = -torch.sum(torch.where(valid & ~pos1, y1 * w_old_act, zero),
                       dim=-1)
    w_b1 = min_norm_w(2, w_old, y1, gamma, pos1, active_global, max_passes)

    # Branch 2: ztw < mu, dimA < t
    e2 = torch.where(valid, -vA * cx_act, zero)
    pos2 = valid & (e2 > 0)
    tau2 = mu - torch.sum(torch.where(valid & ~pos2, e2 * w_old_act, zero),
                          dim=-1)
    w_b2 = min_norm_w(2, w_old, e2, tau2, pos2, active_global, max_passes)

    # Branch 3: ztw < mu, dimA == t (ctrl = 1, y = z, all active slots).
    # The only looping EUCMOD call — a branch runs it only when some
    # lane takes its result.
    b3 = ~ge & ~lt_t
    w_b3 = cond(b3,
                lambda: min_norm_w(1, w_old, z, mu, valid, active_global,
                                   max_passes, lanes=b3 if b3.ndim else None),
                lambda: previous_w)
    w = torch.where(ex(ge & lt_t), w_b1,
                    torch.where(ex(~ge & lt_t), w_b2,
                                torch.where(ex(b3), w_b3, previous_w)))
    hit = (lt_t | ~ge) & (t > 0)
    w = torch.where(ex(hit), w, previous_w)
    K_new = assort(K, w, active_global, valid)
    K_out = torch.where(ex(t > 0, 2), K_new, K)
    return w, K_out


def max_norm_weight_update(nrm_Ap, rmy, alpha_w, delta: float,
                           w: torch.Tensor, active_global: torch.Tensor,
                           valid: torch.Tensor, t, K: torch.Tensor):
    """MAXNRM: uniform weight over the working set; the history lives in
    K[:, 0]."""
    one = torch.ones_like(nrm_Ap)
    mu = torch.where((alpha_w - 1.0).abs() <= delta, torch.zeros_like(rmy),
                     rmy / torch.where(nrm_Ap != 0, nrm_Ap, one))
    first = active_global[..., 0]
    i1 = torch.where(t > 0, first, torch.zeros_like(first))
    previous_w = take1(w, i1)
    nu = torch.maximum(mu, K[..., 3, 0])
    w_act = take(w, active_global)
    w_new = put(w, active_global, torch.where(valid, ex(nu), w_act))
    # Insert mu into the descending K[:, 0] history when mu > previous_w.
    newcol = torch.sort(torch.cat([K[..., :, 0], mu[..., None]], dim=-1),
                        descending=True).values[..., :4]
    K_ins = K.clone()
    K_ins[..., :, 0] = newcol
    K_new = torch.where(ex(mu > previous_w, 2), K_ins, K)
    return w_new, K_new


def penalty_weight_update(w_old: torch.Tensor, Jp: torch.Tensor,
                          active_Ap: torch.Tensor, K: torch.Tensor,
                          rx: torch.Tensor, cx: torch.Tensor,
                          active_global: torch.Tensor, valid: torch.Tensor,
                          t, dimA, norm_code: int, dims: Dims,
                          max_passes: int):
    """WEIGHT.  Returns (w, dpsi0, dpsi_scale, K_updated).

    The reference normalizes Jp/Ap/rx/cx and rescales every product; the
    net quantities are the plain inner products computed here.

    ``dpsi_scale`` is the sum of the magnitudes of dpsi0's own summands
    (pre-cancellation), including the same fcx zeroing applied to the
    constraint term — the roundoff scale for the descent test's noise
    floor (see compute_steplength, deviation D10).
    """
    delta = 0.25
    tmax = active_Ap.shape[-1]
    slot = torch.arange(tmax, device=active_Ap.device)
    in_dimA = (slot < ex(dimA)) & valid
    zero = torch.zeros_like(active_Ap)

    Jp_rx, nrm_Jp2 = rows_sums(dot(Jp, rx), dot(Jp, Jp))
    nrm_Ap = torch.sqrt(torch.sum(torch.where(valid, active_Ap * active_Ap,
                                              zero), dim=-1))
    cx_act = take(cx, active_global)
    w_old_act = take(w_old, active_global)

    # The reference normalizes cx by nrm_cx = max |cx[active[1:dimA]]|
    # and re-multiplies products by nrm_cx; when nrm_cx == 0 that
    # *zeroes* every cx-carrying product even if active entries beyond
    # dimA are nonzero.  fcx reproduces that exactly.
    nrm_cx = torch.max(torch.where(in_dimA, cx_act.abs(), zero),
                       dim=-1).values \
        if tmax > 0 else torch.zeros_like(Jp_rx)
    fcx = (nrm_cx != 0.0).to(rx.dtype)

    AtwA = torch.sum(torch.where(in_dimA, w_old_act * active_Ap ** 2, zero),
                     dim=-1)
    BtwA = fcx * torch.sum(torch.where(in_dimA,
                                       w_old_act * active_Ap * cx_act, zero),
                           dim=-1)
    eps = torch.finfo(rx.dtype).eps
    big = (AtwA + nrm_Jp2).abs() > eps
    one = torch.ones_like(AtwA)
    alpha_w = torch.where(big, (-BtwA - Jp_rx) /
                          torch.where(big, AtwA + nrm_Jp2, one), one)
    rmy = ((Jp_rx + nrm_Jp2).abs() / delta) - nrm_Jp2

    if norm_code == 0:
        w, K_new = max_norm_weight_update(nrm_Ap, rmy, alpha_w, delta,
                                          w_old, active_global, valid, t, K)
    elif norm_code == 2:
        w, K_new = euclidean_norm_weight_update(
            active_Ap, cx * ex(fcx), active_global, valid, t, rmy, dimA,
            w_old, K, dims, max_passes)
    else:  # pragma: no cover - reference supports only 0 and 2
        raise ValueError(f"unsupported weight_code {norm_code}")

    # dpsi0 decides descent vs -6 abort; accumulate at decision precision.
    w_act = _acc(take(w, active_global))
    cons_terms = torch.where(valid, w_act * _acc(active_Ap) * _acc(cx_act),
                             _acc(zero))
    BtwA2 = _acc(fcx) * torch.sum(cons_terms, dim=-1)
    Jp_a, rx_a = _acc(Jp), _acc(rx)
    Jp_rx_a, Jp_rx_abs = rows_sums(dot(Jp_a, rx_a),
                                   torch.sum((Jp_a * rx_a).abs(), dim=-1))
    dpsi0 = BtwA2 + Jp_rx_a
    # Roundoff scale of dpsi0: summand magnitudes BEFORE cancellation,
    # constraint term gated by the same fcx that gates dpsi0's.
    dpsi_scale = (Jp_rx_abs +
                  _acc(fcx) * torch.sum(cons_terms.abs(), dim=-1))
    return w, dpsi0, dpsi_scale, K_new
