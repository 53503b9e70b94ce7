"""Working-set management as masked, fixed-shape operations.

Counterpart of ``enlsip_tpu/core/working_set.py``.  Reference routines
reproduced: INIALC, SIGNCH, EVADD (including the capacity bound
t <= min(l, n) with swap-out of the least-violated active inequality)
and minmax_lagrangian_mult.

The working set is a boolean mask of length l; sorted active/inactive
lists are derived on demand (types.working_view).  Every function takes
one solve's vectors or a batch's (leading lane axes; per-lane scalars
0-d or ``(B,)``).
"""

from __future__ import annotations

import math

import torch

from .._lanes import const, ex, norm, take1, while_loop
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
    l, q = dims.l, ex(rdims_or(rdims, dims).q)
    idx = torch.arange(l, device=cx.device)
    row_norm = torch.sqrt(torch.sum(A * A, dim=-1))
    noise = torch.finfo(cx.dtype).eps * (1.0 + row_norm * ex(norm(x)))
    mask = (idx < q) | ((idx >= q) & (cx <= noise))
    w = torch.clamp(cx.abs() + 0.01, max=0.1)
    K = torch.full((*cx.shape[:-1], 4, l), 0.1, dtype=cx.dtype,
                   device=cx.device)
    return mask, w, K


def _row_scale(scaling: bool, diag_scale: torch.Tensor) -> torch.Tensor:
    return (1.0 / diag_scale) if scaling else diag_scale


def check_constraint_deletion(q, lam: torch.Tensor, valid: torch.Tensor,
                              t, scaling: bool, diag_scale: torch.Tensor,
                              grad_res) -> torch.Tensor:
    """SIGNCH: slot index (per-lane int64) of the inequality with the
    most negative row-scaled multiplier, or -1 if none shall be deleted.

    Ties resolve to the *last* qualifying slot (the reference updates on
    ``<=``).  Deletion is suppressed while far from stationarity on the
    current working set: ``grad_res > -e * 10``."""
    tmax = lam.shape[-1]
    sqrt_eps = math.sqrt(torch.finfo(lam.dtype).eps)
    inf = torch.full_like(lam, math.inf)
    one = torch.ones((), dtype=lam.dtype, device=lam.device)
    lam_max = torch.where(
        t == 0, one, torch.max(torch.where(valid, lam.abs(), -inf),
                               dim=-1).values)
    sq_rel = sqrt_eps * lam_max
    vals = _row_scale(scaling, diag_scale) * lam
    slot = torch.arange(tmax, device=lam.device)
    cand = (slot >= ex(q)) & (slot < ex(t))
    masked = torch.where(cand, vals, inf)
    vmin = torch.min(masked, dim=-1).values
    found = vmin <= sq_rel
    # last index achieving the min (reference's <= update keeps the last)
    s = torch.max(torch.where(cand & (masked == ex(vmin)), slot, -1),
                  dim=-1).values
    e = torch.where(found, vmin, sq_rel)
    s = torch.where(found & (t > q), s, -1)
    return torch.where(grad_res > -e * 10.0, -1, s)


def minmax_lagrangian_mult(lam: torch.Tensor, valid: torch.Tensor, t, q,
                           scaling: bool, diag_scale: torch.Tensor):
    """sigma_min = most-negative inequality multiplier whose row-scaled
    value is <= -sqrt(eps) (Inf if none); lam_abs_max = max |lam| over
    the whole working set (0 if t <= q)."""
    tmax = lam.shape[-1]
    sq_rel = math.sqrt(torch.finfo(lam.dtype).eps)
    inf = torch.full_like(lam, math.inf)
    slot = torch.arange(tmax, device=lam.device)
    lam_abs_max = torch.where(
        t > q, torch.max(torch.where(valid, lam.abs(), -inf), dim=-1).values,
        torch.zeros((), dtype=lam.dtype, device=lam.device))
    rows = _row_scale(scaling, diag_scale)
    cand = (slot >= ex(q)) & (slot < ex(t)) & (lam * rows <= -sq_rel)
    sigmin = torch.min(torch.where(cand, lam, inf), dim=-1).values
    return sigmin, lam_abs_max


def evaluate_violated_constraints(cx: torch.Tensor, mask: torch.Tensor,
                                  index_alpha_upp, dims: Dims, rdims=None):
    """EVADD: add every inactive constraint with cx < sqrt(eps) (or
    cx < 0.1 for the steplength-capping constraint) to the working set,
    respecting the capacity bound t <= min(l, n) by swapping out the
    least-violated active inequality when it is less violated than the
    candidate.

    Returns (new_mask, added): ``added`` is a per-lane bool tensor.
    ``index_alpha_upp`` is a global constraint index (-1 = none).

    The scan order is the reference's: the inactive constraints of the
    incoming mask in ascending index.  Whether a candidate WANTS in
    depends only on cx and ``index_alpha_upp``, never on the evolving
    mask.  A lane whose wanting candidates all fit under the capacity
    bound takes them at once (the scan would add each one plainly); the
    scan itself is a device loop (``_lanes.while_loop``, JAX:
    ``lax.fori_loop`` over the inactive slots) whose trips are the
    constraint indices that some over-capacity lane wants, in ascending
    order (none, usually: the loop then takes no trip).

    Parity note (as in the reference port): constraints swapped *out*
    within the pass are not rescanned."""
    l = dims.l
    rd = rdims_or(rdims, dims)
    q = rd.q
    dev = cx.device
    eps_s = math.sqrt(torch.finfo(cx.dtype).eps)
    delta = 0.1
    bnd = torch.minimum(const(rd.l, dev), const(rd.n, dev))
    idxg = torch.arange(l, device=dev)
    want = (~mask) & ((cx < eps_s) |
                      ((idxg == ex(index_alpha_upp)) & (cx < delta)))
    n_want = torch.sum(want, dim=-1)
    fits = torch.sum(mask, dim=-1) + n_want <= bnd
    scan = want & ex(~fits)
    scanned = scan.reshape(-1, l).any(dim=0)       # (l,): some lane scans k
    m = mask | (want & ex(fits))
    added = fits & (n_want > 0)
    neg_inf = torch.full_like(cx, -math.inf)

    def next_k(after):
        """The first scanned index past ``after`` (l when none is left)."""
        later = (scanned & (idxg > after)).to(torch.int32)
        return torch.where(torch.any(later > 0), torch.argmax(later),
                           torch.full_like(after, l))

    def more(st):
        return st[2] < l

    def scan_one(st):
        m, added, k = st
        wk = take1(scan, k)
        ck = take1(cx, k)
        at_cap = torch.sum(m, dim=-1) >= bnd
        # Least-violated (max cx) active inequality; first argmax like
        # the reference's strict-> scan over ascending slots.
        act_ineq = m & (idxg >= ex(q))
        vals = torch.where(act_ineq, cx, neg_inf)
        worst = torch.argmax(vals, dim=-1)
        can_swap = torch.any(act_ineq, dim=-1) & (take1(vals, worst) > ck)
        do_plain = wk & ~at_cap
        do_swap = wk & at_cap & can_swap
        m = m & ~(ex(do_swap) & (idxg == ex(worst)))
        m = m | (ex(do_plain | do_swap) & (idxg == k))
        added = added | do_plain | do_swap
        return m, added, next_k(k)

    first = next_k(torch.full((), -1, dtype=torch.int64, device=dev))
    m, added, _ = while_loop(more, scan_one, (m, added, first))
    return m, added
