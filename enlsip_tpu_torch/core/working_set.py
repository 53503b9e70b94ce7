"""Working-set management as masked, fixed-shape operations.

Counterpart of ``enlsip_tpu/core/working_set.py``.  Reference routines
reproduced: INIALC, SIGNCH, EVADD (including the capacity bound
t <= min(l, n) with swap-out of the least-violated active inequality)
and minmax_lagrangian_mult.

The working set is a boolean mask of length l; sorted active/inactive
lists are derived on demand (types.working_view).
"""

from __future__ import annotations

import math

import torch

from .._device import to_host
from .types import Dims, rdims_or


def init_working_set(cx: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
                     dims: Dims, rdims=None):
    """INIALC: initial mask (equalities + non-positive inequalities),
    initial penalty weights w_i = min(|cx_i| + 0.01, 0.1), and the
    penalty history K = 0.1 * ones(4, l).

    Deviation D7 (float32 robustness): the activity test is
    cx <= eps*(1 + |grad c_j|*|x|) — the constraint's evaluation-noise
    scale — instead of the reference's cx <= 0.  Together with the same
    window in UPBND (linesearch.upper_bound_steplength) it leaves no
    gap: every inactive constraint either caps the step (cx > noise) or
    starts active (cx <= noise).  At float64 the window is ~1e-14*scale."""
    l, q = dims.l, rdims_or(rdims, dims).q
    idx = torch.arange(l, device=cx.device)
    row_norm = torch.sqrt(torch.sum(A * A, dim=1))
    noise = torch.finfo(cx.dtype).eps * (1.0 + row_norm * torch.linalg.norm(x))
    mask = (idx < q) | ((idx >= q) & (cx <= noise))
    w = torch.clamp(cx.abs() + 0.01, max=0.1)
    K = torch.full((4, l), 0.1, dtype=cx.dtype, device=cx.device)
    return mask, w, K


def _row_scale(scaling: bool, diag_scale: torch.Tensor) -> torch.Tensor:
    return (1.0 / diag_scale) if scaling else diag_scale


def check_constraint_deletion(q: int, lam: torch.Tensor, valid: torch.Tensor,
                              t, scaling: bool, diag_scale: torch.Tensor,
                              grad_res) -> torch.Tensor:
    """SIGNCH: slot index (0-d int64) of the inequality with the most
    negative row-scaled multiplier, or -1 if none shall be deleted.

    Ties resolve to the *last* qualifying slot (the reference updates on
    ``<=``).  Deletion is suppressed while far from stationarity on the
    current working set: ``grad_res > -e * 10``."""
    tmax = lam.shape[0]
    sqrt_eps = math.sqrt(torch.finfo(lam.dtype).eps)
    inf = torch.full_like(lam, math.inf)
    one = torch.ones((), dtype=lam.dtype, device=lam.device)
    lam_max = torch.where(t == 0, one,
                          torch.max(torch.where(valid, lam.abs(), -inf)))
    sq_rel = sqrt_eps * lam_max
    vals = _row_scale(scaling, diag_scale) * lam
    slot = torch.arange(tmax, device=lam.device)
    cand = (slot >= q) & (slot < t)
    masked = torch.where(cand, vals, inf)
    vmin = torch.min(masked)
    found = vmin <= sq_rel
    # last index achieving the min (reference's <= update keeps the last)
    s = torch.max(torch.where(cand & (masked == vmin), slot, -1))
    e = torch.where(found, vmin, sq_rel)
    s = torch.where(found & (t > q), s, -1)
    return torch.where(grad_res > -e * 10.0, -1, s)


def minmax_lagrangian_mult(lam: torch.Tensor, valid: torch.Tensor, t, q: int,
                           scaling: bool, diag_scale: torch.Tensor):
    """sigma_min = most-negative inequality multiplier whose row-scaled
    value is <= -sqrt(eps) (Inf if none); lam_abs_max = max |lam| over
    the whole working set (0 if t <= q)."""
    tmax = lam.shape[0]
    sq_rel = math.sqrt(torch.finfo(lam.dtype).eps)
    inf = torch.full_like(lam, math.inf)
    slot = torch.arange(tmax, device=lam.device)
    lam_abs_max = torch.where(t > q,
                              torch.max(torch.where(valid, lam.abs(), -inf)),
                              torch.zeros((), dtype=lam.dtype,
                                          device=lam.device))
    rows = _row_scale(scaling, diag_scale)
    cand = (slot >= q) & (slot < t) & (lam * rows <= -sq_rel)
    sigmin = torch.min(torch.where(cand, lam, inf))
    return sigmin, lam_abs_max


def evaluate_violated_constraints(cx: torch.Tensor, mask: torch.Tensor,
                                  index_alpha_upp, dims: Dims, rdims=None):
    """EVADD: add every inactive constraint with cx < sqrt(eps) (or
    cx < 0.1 for the steplength-capping constraint) to the working set,
    respecting the capacity bound t <= min(l, n) by swapping out the
    least-violated active inequality when it is less violated than the
    candidate.

    Returns (new_mask, added_flag).  ``index_alpha_upp`` is a global
    constraint index (-1 = none).

    The scan order is the reference's: the inactive constraints of the
    incoming mask in ascending index.  Whether a candidate WANTS in
    depends only on cx and ``index_alpha_upp``, never on the evolving
    mask, so the host walks just the wanting candidates (usually none,
    read back as one count) instead of every inactive slot; the result
    is the same as the full scan.

    Parity note (as in the reference port): constraints swapped *out*
    within the pass are not rescanned."""
    l = dims.l
    rd = rdims_or(rdims, dims)
    q = rd.q
    eps_s = math.sqrt(torch.finfo(cx.dtype).eps)
    delta = 0.1
    bnd = min(rd.l, rd.n)
    idxg = torch.arange(l, device=cx.device)
    want = (~mask) & ((cx < eps_s) | ((idxg == index_alpha_upp) & (cx < delta)))
    wanting = torch.nonzero(want)[:, 0]
    added = False
    if wanting.shape[0] == 0:      # the shape read is the host read-back
        return mask, added
    m = mask.clone()
    neg_inf = torch.full_like(cx, -math.inf)
    for k in wanting.tolist():
        t = int(to_host(torch.sum(m)))
        if t < bnd:
            m[k] = True            # in-place index assignment
            added = True
            continue
        # Least-violated (max cx) active inequality; first argmax like
        # the reference's strict-> scan over ascending slots.
        act_ineq = m & (idxg >= q)
        vals = torch.where(act_ineq, cx, neg_inf)
        worst = torch.argmax(vals)
        if bool(to_host(torch.any(act_ineq) & (vals[worst] > cx[k]))):
            m[worst] = False
            m[k] = True
            added = True
    return m, added
