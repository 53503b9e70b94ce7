"""Merit function and the Lindström–Wedin line search.

Counterpart of ``enlsip_tpu/core/linesearch.py``.  Reference routines:
psi, CONCAT/LINC2, QUAMIN/MINRN, the MINRM machinery, REDC, GAC, LINEC,
UPBND, STPLNG, check_derivatives.

The merit is
  psi(x + a p, w) = 1/2 (||r||^2 + sum_{i in W} w_i c_i^2
                         + sum_{j not in W, c_j < 0} w_j c_j^2).

Every psi evaluation re-evaluates the user residual and constraint
functions (exactly like the reference), so evaluation counters are
threaded through all routines.  The search itself is a host loop.  For
one solve each decision reads one scalar back from the device and ONE
branch is evaluated, so the counters agree with the reference's.  For a
batch (leading lane axes on every tensor, ``(B,)`` counters) the lanes
search in lockstep through ``_lanes.cond`` / ``_lanes.while_loop``: a
branch no searching lane takes is skipped, a loop runs while any
searching lane needs it, and every lane keeps exactly the values,
trial points and counters its own single search would produce.

Accumulation dtype: the DECISIONS hinge on small differences of large
merit values and on the quartic-model coefficient
v2 = ((v(a)-v0)/a - v1)/a, which cancels catastrophically in float32.
All merit / model scalars therefore accumulate in float64 (a no-op for
float64 solves, a few (m+l)-vector promotions per line search for
float32 ones).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .._dist import rows_dot, rows_sums, split_dots
from .._lanes import cond, dot, ex, mv, norm, take, while_loop
from .types import Counters, Dims, PrevIter, acc as _acc


# ----------------------------------------------------------------- psi

def _both(lanes, pred):
    """``lanes & pred`` for a batch; ``None`` (one solve) stays ``None``."""
    return None if lanes is None else lanes & pred


def psi(x, alpha, p, w, mask, res_at, cons_fn, counters: Counters):
    """Merit function at x + alpha*p.  ``res_at(alpha)`` evaluates
    r(x + alpha*p)."""
    x_new = x + ex(alpha.to(x.dtype)) * p
    rxn = _acc(res_at(alpha))
    cxn = _acc(cons_fn(x_new))
    w = _acc(w)
    counters = counters.bump(res=1, cons=1)
    pen = torch.where(mask | (cxn < 0.0), w * cxn * cxn, torch.zeros_like(cxn))
    return 0.5 * (rows_dot(rxn, rxn) + torch.sum(pen, dim=-1)), counters


def _min_part(mask, cx, scaled):
    """Active rows keep ``scaled``; inactive rows keep it only where the
    constraint is violated (c <= 0)."""
    return torch.where(mask | ~(cx > 0.0), scaled, torch.zeros_like(scaled))


def concat_v(rx, cx, w, mask, dims: Dims):
    """CONCAT: v = [rx ; sqrt(w_k) c_k (active) ; min-part (inactive:
    0 if c_k > 0 else sqrt(w_k) c_k)], indexed by global constraint id
    at offset m."""
    rx, cx, w = _acc(rx), _acc(cx), _acc(w)
    return torch.cat([rx, _min_part(mask, cx, torch.sqrt(w) * cx)], dim=-1)


def linesearch_v1(JpAp, cx, w, mask, dims: Dims):
    """LINC2's v1 scaling: constraint rows of [Jp; Ap] get sqrt(w)
    (active) or the min-part rule (inactive).  (The residual rows are
    the buffer's own: a row-sharded solve holds m / D of them.)"""
    m = JpAp.shape[-1] - cx.shape[-1]
    JpAp, cx, w = _acc(JpAp), _acc(cx), _acc(w)
    return torch.cat([JpAp[..., :m],
                      _min_part(mask, cx, torch.sqrt(w) * JpAp[..., m:])],
                     dim=-1)


# -------------------------------------------------------------- minrn

def _tiny(v):
    return torch.finfo(v.dtype).tiny


def minimize_quadratic(x1, y1, x2, y2, x3, y3):
    """QUAMIN."""
    d1, d2 = y2 - y1, y3 - y1
    s = (x3 - x1) ** 2 * d1 - (x2 - x1) ** 2 * d2
    q = 2.0 * ((x2 - x1) * d2 - (x3 - x1) * d1)
    return x1 - s / torch.where(q != 0, q, torch.full_like(q, _tiny(q)))


def minrn(x1, y1, x2, y2, x3, y3, alpha_min, alpha_max, p_max):
    """MINRN: 3-point quadratic interpolation, clamped."""
    eps = math.sqrt(torch.finfo(x1.dtype).eps) / p_max
    degenerate = ((x1 - x2).abs() < eps) | ((x3 - x1).abs() < eps) | \
                 ((x3 - x2).abs() < eps)
    u = minimize_quadratic(x1, y1, x2, y2, x3, y3)
    a = torch.minimum(torch.maximum(u, alpha_min), alpha_max)
    safe = lambda v: torch.where(v.abs() > 0, v, torch.full_like(v, _tiny(v)))
    t1 = (a - x1) * (a - x2) * y3 / safe((x3 - x1) * (x3 - x2))
    t2 = (a - x3) * (a - x2) * y1 / safe((x1 - x3) * (x1 - x2))
    t3 = (a - x3) * (a - x2) * y2 / safe((x2 - x1) * (x2 - x3))
    pa = t1 + t2 + t3
    zero = torch.zeros_like(a)
    return torch.where(degenerate, zero, a), torch.where(degenerate, zero, pa)


# -------------------------------------------------------------- minrm

def _poly_eval(c, x):
    """Evaluate sum c_k x^k (c ascending) via Horner."""
    acc = torch.zeros_like(x)
    for ck in reversed(c):
        acc = acc * x + ck
    return acc


def _newton_raphson(x_min, Dm, dsc, ddsc, lanes=None):
    """Safeguarded NR on s'(a) = 0, <= 50 iterations (host loop)."""
    eps = torch.finfo(x_min.dtype).eps

    def go(st):
        a, err, done, it = st
        g = ~done & ((it < 3) | (err > 1e-4))
        return g if lanes is None else g & lanes

    def step(st):
        a, err, done, it = st
        c = _poly_eval(ddsc, a)
        stop = c.abs() < eps
        csafe = torch.where(stop, torch.ones_like(c), c)
        h = -_poly_eval(dsc, a) / csafe
        err = torch.where(stop, err, (2.0 * Dm * h * h) / csafe.abs())
        a = torch.where(stop, a, a + h)
        return a, err, done | stop, it + 1

    st = (x_min, torch.ones_like(x_min),
          torch.zeros_like(x_min, dtype=torch.bool),
          torch.zeros_like(x_min, dtype=torch.int64))
    return while_loop(go, step, st, max_trips=50)[0]


def _cbrt(v):
    return torch.sign(v) * v.abs() ** (1.0 / 3.0)


def _one_root(c, d, a):
    """ONER."""
    sq = torch.sqrt(torch.clamp(d, min=0.0))
    return _cbrt(-c / 2 + sq) + _cbrt(-c / 2 - sq) - a / 3


def _two_roots(b, c, d, a, x_min):
    """TWOR.  Valid when d < 0 (then b < 0)."""
    bsafe = torch.clamp(b, max=-_tiny(b))
    arg = torch.clamp((c / 2).abs() / (-bsafe / 3) ** 1.5, -1.0, 1.0)
    phi = torch.arccos(arg)
    t = torch.where(c <= 0, 2.0, -2.0) * torch.sqrt(-bsafe / 3)
    pi = math.pi
    roots = torch.stack([t * torch.cos(phi / 3) - a / 3,
                         t * torch.cos((phi + 2 * pi) / 3) - a / 3,
                         t * torch.cos((phi + 4 * pi) / 3) - a / 3], dim=-1)
    r = torch.sort(roots, dim=-1).values
    lo, mid, hi = r[..., 0], r[..., 1], r[..., 2]
    alpha = torch.where(x_min <= mid, lo, hi)
    beta = torch.where(x_min <= mid, hi, lo)
    return alpha, beta


def minrm(v0, v1, v2, x_min, alpha_min, alpha_max, lanes=None, rows=None):
    """MINRM: minimize the quartic s(a) = 1/2 ||v0 + v1 a + v2 a^2||^2
    analytically (Cardano) or, where the model is flat, by safeguarded
    Newton–Raphson; returns the best two local minimizers clamped to
    [alpha_min, alpha_max] with values.  ``rows``: the v's leading
    residual rows (row-sharded inside a row scope; see
    ``_dist.split_dots``)."""
    tiny = _tiny(v0)
    d00, d01, d02, d11, d12, d22 = split_dots(
        [(v0, v0), (v0, v1), (v0, v2), (v1, v1), (v1, v2), (v2, v2)], rows)
    c0 = 0.5 * d00
    c1 = d01
    c2 = d02 + 0.5 * d11
    c3 = d12
    normv2 = d22
    c4 = 0.5 * normv2
    sc = (c0, c1, c2, c3, c4)
    dsc = (c1, 2 * c2, 3 * c3, 4 * c4)
    ddsc = (2 * c2, 6 * c3, 12 * c4)

    nv2 = torch.where(normv2 != 0, normv2, torch.full_like(normv2, tiny))
    dds_best = _poly_eval(ddsc, x_min)
    h0 = (_poly_eval(dsc, x_min) /
          torch.where(dds_best != 0, dds_best,
                      torch.full_like(dds_best, tiny))).abs()
    Dm = (6 * c3 + 12 * x_min * normv2).abs() + 24 * h0 * normv2
    hm = torch.clamp(h0, min=1.0)
    analytic = dds_best * 0.1 < 2 * Dm * hm

    def cardano():
        a1 = 3 * c3 / (2 * nv2)
        a2 = 2 * c2 / (2 * nv2)
        a3 = c1 / (2 * nv2)
        b = a2 - (a1 ** 2) / 3
        c = a3 - a1 * a2 / 3 + 2 * (a1 / 3) ** 3
        d = (c / 2) ** 2 + (b / 3) ** 3
        ar_two, br_two = _two_roots(b, c, d, a1, x_min)
        alpha_hat = torch.where(d < 0, ar_two, _one_root(c, d, a1))
        return alpha_hat, torch.where(d < 0, br_two, alpha_hat)

    def raphson():
        # the NR branch leaves d = 1.0: one minimizer
        a = _newton_raphson(x_min, Dm, dsc, ddsc, _both(lanes, ~analytic))
        return a, a

    alpha_hat, beta_hat = cond(analytic, cardano, raphson, lanes)

    clip = lambda v: torch.minimum(torch.maximum(v, alpha_min), alpha_max)
    alpha_c = clip(alpha_hat)
    s_alpha = _poly_eval(sc, alpha_c)
    same = alpha_hat == beta_hat
    beta_c = torch.where(same, alpha_c, clip(beta_hat))
    s_beta = torch.where(same, s_alpha, _poly_eval(sc, beta_c))
    return alpha_c, s_alpha, beta_c, s_beta


# ------------------------------------------------------------- checks

def check_reduction(psi_alpha, psi_k, approx_k, eta, diff_psi):
    """REDC."""
    delta = 0.2
    likely = ~((psi_alpha - psi_k < eta * diff_psi) &
               (psi_k > delta * psi_alpha))
    return (psi_alpha - approx_k >= eta * diff_psi) & likely


def goldstein_armijo_step(psi0, dpsi0, alpha_min, tau, p_max, x, alpha0, p,
                          w, mask, res_at, cons_fn, counters: Counters,
                          max_halvings: int, lanes=None):
    """GAC: halve until psi(u) <= psi0 + tau u dpsi0 (host loop, at most
    ``max_halvings`` halvings).  Returns (u, exit_flag tensor, counters)."""
    sqr_eps = math.sqrt(torch.finfo(x.dtype).eps)
    u = _acc(alpha0)
    ext = (p_max * u < sqr_eps) | (u <= alpha_min)
    psiu, counters = psi(x, u, p, w, mask, res_at, cons_fn, counters)

    def go(st):
        u, psiu, ext, _ = st
        g = (~ext) & (psiu > psi0 + tau * u * dpsi0)
        return g if lanes is None else g & lanes

    def halve(st):
        u, _, _, cnt = st
        u = u * 0.5
        psiu, cnt = psi(x, u, p, w, mask, res_at, cons_fn, cnt)
        return u, psiu, (p_max * u < sqr_eps) | (u <= alpha_min), cnt

    u, _, ext, counters = while_loop(go, halve, (u, psiu, ext, counters),
                                     max_trips=max_halvings)
    return u, ext, counters


# -------------------------------------------------------------- LINEC

class LinesearchResult(NamedTuple):
    alpha: torch.Tensor
    gac_error: object    # per-lane bool tensor, or False where GAC never ran
    counters: Counters


def linesearch_constrained(x, alpha0, p, rx, cx, JpAp, w, mask, psi0, dpsi0,
                           alpha_low, alpha_upp, res_at, cons_fn,
                           counters: Counters, dims: Dims,
                           max_refine: int, gac_max: int,
                           lanes=None) -> LinesearchResult:
    """LINEC.  ``lanes`` (batch only): the lanes that are searching; the
    others are computed along and their values ignored by the caller."""
    eta, tau, gamma = 0.3, 0.25, 0.4
    psi0, dpsi0 = _acc(psi0), _acc(dpsi0)
    alpha_min, alpha_max = _acc(alpha_low), _acc(alpha_upp)
    alpha_k = torch.minimum(_acc(alpha0), alpha_max)
    p_max = _acc(torch.max(p.abs(), dim=-1).values)
    zero = torch.zeros_like(alpha_k)

    def merit(a, cnt):
        return psi(x, a, p, w, mask, res_at, cons_fn, cnt)

    def quartic_v2(a, cnt):
        """v2 of the quartic model through the trial point ``a`` (one
        residual and one constraint evaluation)."""
        vb = concat_v(res_at(a), cons_fn(x + ex(a.to(x.dtype)) * p), w, mask,
                      dims)
        return ((vb - v0) / ex(a) - v1) / ex(a), cnt.bump(res=1, cons=1)

    def take_beta(a, pa, bta, pbta, ak):
        better = (a != bta) & (pbta < pa) & (bta <= ak)
        return torch.where(better, bta, a), torch.where(better, pbta, pa)

    v1 = linesearch_v1(JpAp, cx, w, mask, dims)
    psi_k, counters = merit(alpha_k, counters)
    diff_psi0 = psi0 - psi_k
    v0 = concat_v(rx, cx, w, mask, dims)
    v2, counters = quartic_v2(alpha_k, counters)

    x_min = torch.where(diff_psi0 >= 0, alpha_k, zero)
    a_kp1, pk = take_beta(*minrm(v0, v1, v2, x_min, alpha_min, alpha_max,
                                 lanes, rx.shape[-1]), alpha_k)

    # UPDATE
    alpha_km2, psi_km2 = zero, psi0
    alpha_km1, psi_km1 = alpha_k, psi_k
    alpha_k = a_kp1
    psi_k, counters = merit(alpha_k, counters)

    def refine(st, fixed_diff: bool, cnt, on):
        """The reduction-likely 3-point refinement loop.  With
        ``fixed_diff`` the loop keeps the stale diff_psi (the reference's
        second branch never updates it)."""
        def go(s):
            return s[8] if on is None else s[8] & on

        def step(s):
            ak2, pk2, ak1, pk1, ak, pkk, approx, dpsi, likely, c = s
            a_new, approx = minrn(ak, pkk, ak1, pk1, ak2, pk2,
                                  alpha_min, alpha_max, p_max)
            ak2, pk2 = ak1, pk1
            ak1, pk1 = ak, pkk
            ak = a_new
            pkk, c = merit(ak, c)
            if not fixed_diff:
                dpsi = psi0 - pkk
            likely = check_reduction(pk1, pkk, approx, eta, dpsi)
            return ak2, pk2, ak1, pk1, ak, pkk, approx, dpsi, likely, c

        (_, _, ak1, pk1, ak, pkk, approx, dpsi, _, cnt) = while_loop(
            go, step, (*st, cnt), max_trips=max_refine)
        best = (pk1 - approx >= eta * dpsi) & (pkk < pk1)
        return torch.where(best, ak, ak1), cnt

    term_a0 = (-diff_psi0 <= tau * dpsi0 * alpha_km1) | \
        (psi_km1 < gamma * psi0)
    diff_psi = psi0 - psi_k

    def at_alpha0():
        # ---- branch 1: termination satisfied at alpha0 ----------------
        likely0 = check_reduction(psi_km1, psi_k, pk, eta, diff_psi)
        st = (alpha_km2, psi_km2, alpha_km1, psi_km1, alpha_k, psi_k, pk,
              diff_psi, likely0)
        alpha, cnt = refine(st, False, counters, _both(lanes, term_a0))
        return alpha, False, cnt

    def past_alpha0():
        # ---- branch 2 -------------------------------------------------
        on2 = _both(lanes, ~term_a0)
        term_a1 = (-diff_psi <= tau * dpsi0 * alpha_k) | \
            (psi_k < gamma * psi0)

        def armijo():
            return goldstein_armijo_step(
                psi0, dpsi0, alpha_min, tau, p_max, x, alpha_k, p, w, mask,
                res_at, cons_fn, counters, gac_max, _both(on2, ~term_a1))

        def interpolate():
            on3 = _both(on2, term_a1)
            redo = psi0 <= psi_km1

            def remodel():
                # alpha0 not useful: redo the quartic model at alpha_k
                v2k, cnt = quartic_v2(alpha_k, counters)
                a_n, pk_n = take_beta(
                    *minrm(v0, v1, v2k, alpha_k, alpha_min, alpha_max,
                           _both(on3, redo), rx.shape[-1]), alpha_k)
                return a_n, pk_n, zero, psi0, cnt

            def three_point():
                a_n, pk_n = minrn(alpha_k, psi_k, alpha_km1, psi_km1,
                                  alpha_km2, psi_km2, alpha_min, alpha_max,
                                  p_max)
                return a_n, pk_n, alpha_km1, psi_km1, counters

            a_n, pk_n, akm1b, pkm1b, cnt = cond(redo, remodel, three_point,
                                                on3)
            # UPDATE
            pkk, cnt = merit(a_n, cnt)
            likely0 = check_reduction(psi_k, pkk, pk_n, eta, diff_psi)
            st = (akm1b, pkm1b, alpha_k, psi_k, a_n, pkk, pk_n, diff_psi,
                  likely0)
            alpha, cnt = refine(st, True, cnt, on3)
            return alpha, False, cnt

        return cond(term_a1, interpolate, armijo, on2)

    return LinesearchResult(*cond(term_a0, at_alpha0, past_alpha0, lanes))


# -------------------------------------------------------------- UPBND

def upper_bound_steplength(A, cx, p, x, mask, index_del, dims: Dims):
    """UPBND: alpha_upp = min(3, min over inactive j with cx_j > 0,
    grad_j^T p < 0 of -cx_j / grad_j^T p); returns the capping
    constraint's global index (-1 if none).

    Deviation D7 (float32 robustness): the positivity test uses the
    constraint's own evaluation-noise scale eps*(1 + |grad c_j|*|x|)
    instead of strict 0.  A cx that is zero up to roundoff is ON the
    boundary; the strict test would turn its roundoff residue into an
    ~eps step cap and stall.  A cx genuinely above its noise scale is a
    real interior constraint and MUST cap the step."""
    row_norm = torch.sqrt(torch.sum(A * A, dim=-1))                # (l,)
    noise = torch.finfo(cx.dtype).eps * (1.0 + row_norm * ex(norm(x)))
    Ap = mv(A, p)  # (l,)
    idx = torch.arange(dims.l, device=cx.device)
    cand = (~mask) & (idx != ex(index_del)) & (cx > noise) & (Ap < 0.0)
    alpha_j = -cx / torch.where(Ap != 0, Ap, torch.ones_like(Ap))
    vals = torch.where(cand, alpha_j, torch.full_like(alpha_j, math.inf))
    # first (ascending global index) strict minimizer, like the scan
    amin, ix = torch.min(vals, dim=-1)
    alpha_upper = torch.clamp(amin, max=3.0)
    return alpha_upper, torch.where(amin < math.inf, ix, -1)


# ------------------------------------------------------------- STPLNG

def check_derivatives(dpsi0, psi0, psi_k, x_old, alpha, p, w, mask,
                      res_at, cons_fn, counters: Counters):
    """Finite-difference consistency test of dpsi0 after a
    Goldstein-Armijo failure.  Returns (-1 on inconsistency else 0 as a
    per-lane tensor, counters)."""
    psi_m, counters = psi(x_old, -alpha, p, w, mask, res_at, cons_fn, counters)
    fwd = (psi_k - psi0) / alpha
    bwd = (psi0 - psi_m) / alpha
    ctr = (psi_k - psi_m) / (2 * alpha)
    max_diff = torch.maximum(torch.maximum((fwd - ctr).abs(),
                                           (fwd - bwd).abs()),
                             (bwd - ctr).abs())
    inconsistent = ((fwd - dpsi0).abs() > max_diff) & \
                   ((ctr - dpsi0).abs() > max_diff)
    return torch.where(inconsistent, -1, 0), counters


class SteplengthResult(NamedTuple):
    alpha: torch.Tensor
    w: torch.Tensor
    K: torch.Tensor
    psi_error: torch.Tensor
    index_alpha_upp: torch.Tensor
    predicted_reduction: torch.Tensor
    progress: torch.Tensor
    updated_progress: object   # whether the two above were set: a host
    #                            bool (one solve) or a per-lane bool tensor
    counters: Counters


def compute_steplength(res_trial, cons_fn, x, rx, J, cx, A, act, view, t, p,
                       dimA, rankJ2, code, index_del, prev: PrevIter, K,
                       mask, dims: Dims, weight_code: int, counters: Counters,
                       max_refine: int, gac_max: int, eucmod_max: int,
                       scaling: bool, lanes=None,
                       jac_base=None) -> SteplengthResult:
    """STPLNG.

    ``res_trial(x, p) -> (alpha -> r(x + alpha*p))``: the directional
    residual factory, built ONCE here, so structured problems pay their
    ray set-up (e.g. W@x, W@p) once per step length.  ``jac_base``:
    factored mode (``Functions.jac_rowscale``/``jac_base``), where ``J``
    holds the (m, 1) row scale and J p = s * (base p).  ``code`` is the
    method code of the direction (2 = Newton: undamped step, weights
    kept): a host int for one solve, a per-lane tensor for a batch.
    ``lanes`` (batch only): the live lanes."""
    from .weights import penalty_weight_update

    dtype, dev = x.dtype, x.device
    lead = x.shape[:-1]
    const = lambda v, dt=torch.int64: torch.full(lead, v, dtype=dt, device=dev)
    batched = len(lead) > 0
    flag = (lambda v: const(v, torch.bool)) if batched else (lambda v: v)

    def newton_step():
        # undamped Newton step; weights stay w_old
        return SteplengthResult(
            alpha=const(1.0, dtype), w=prev.w, K=K, psi_error=const(0),
            index_alpha_upp=const(-1),
            predicted_reduction=prev.predicted_reduction,
            progress=prev.progress, updated_progress=flag(False),
            counters=counters)

    def damped_step():
        on = _both(lanes, code != 2) if batched else None
        res_at = res_trial(x, p)
        tmax = dims.tmax
        if jac_base is not None:
            Jp = J[..., 0] * mv(jac_base, p)
        else:
            Jp = mv(J, p)
        JpAp = torch.cat([Jp, mv(A, p)], dim=-1)
        active_Ap = mv(act.A_act, p)                    # (tmax,)
        if scaling:
            active_Ap = active_Ap / act.diag_scale      # un-scale
        active_global = view.active_list[..., :tmax]

        # ---- penalty weights + dpsi0 ----------------------------------
        w, dpsi0, dpsi_scale, K_new = penalty_weight_update(
            prev.w, Jp, active_Ap, K, rx, cx, active_global, act.valid, t,
            dimA, weight_code, dims, eucmod_max)
        w, K_new = w.to(dtype), K_new.to(dtype)

        wa = _acc(take(w, active_global))
        cxa = _acc(take(cx, active_global))
        zero_s = torch.zeros_like(wa)
        psi0 = 0.5 * (rows_dot(_acc(rx), _acc(rx)) +
                      torch.sum(torch.where(act.valid, wa * cxa * cxa,
                                            zero_s), dim=-1))

        # Non-descent detection (the reference sets psi_error = -1 when
        # dpsi0 >= 0 -> exit -6).  In float32 the two sums forming dpsi0
        # cancel to roundoff at a stationary point, so a numerically-zero
        # dpsi0 can land at +1e-7 and spuriously fail a solve that has in
        # fact converged.  dpsi0 counts as a true ascent signal only when
        # it clears the dtype noise floor of its own summands (deviation
        # D10); at float64 the floor is ~1e-15*scale, i.e.
        # reference-shaped.
        noise_floor = 10.0 * torch.finfo(dtype).eps * dpsi_scale
        descent = dpsi0 < noise_floor

        def no_descent():
            return SteplengthResult(
                alpha=const(1.0, dtype), w=w, K=K_new, psi_error=const(-1),
                index_alpha_upp=const(-1),
                predicted_reduction=prev.predicted_reduction,
                progress=prev.progress, updated_progress=flag(False),
                counters=counters)

        def search():
            on_s = _both(on, descent)
            alpha_upp, index_alpha_upp = upper_bound_steplength(
                A, cx, p, x, mask, index_del, dims)
            alpha_low = alpha_upp / 3000.0
            magfy = torch.where(rankJ2 < prev.rankJ2, 6.0, 3.0)
            alpha0 = torch.minimum(torch.clamp(magfy * prev.alpha, max=1.0),
                                   alpha_upp)
            res = linesearch_constrained(
                x, alpha0, p, rx, cx, JpAp, w, mask, psi0, dpsi0, alpha_low,
                alpha_upp, res_at, cons_fn, counters, dims, max_refine,
                gac_max, on_s)
            alpha, cnt = res.alpha, res.counters

            def after_gac_failure():
                psi_k, c = psi(x, alpha, p, w, mask, res_at, cons_fn, cnt)
                return check_derivatives(dpsi0, psi0, psi_k, x, alpha, p, w,
                                         mask, res_at, cons_fn, c)

            psi_err, cnt = cond(res.gac_error, after_gac_failure,
                                lambda: (const(0), cnt), on_s)

            uppbound = torch.clamp(_acc(alpha_upp), max=1.0)
            aAp = _acc(active_Ap)
            atwa = torch.sum(torch.where(act.valid, wa * aAp ** 2, zero_s),
                             dim=-1)
            Jp_a, rx_a = _acc(Jp), _acc(rx)
            Jp_rx, Jp_Jp = rows_sums(dot(Jp_a, rx_a), dot(Jp_a, Jp_a))
            pred = uppbound * (-2.0 * Jp_rx - uppbound * Jp_Jp
                               + (2.0 - uppbound ** 2) * atwa)
            x_new = x + ex(alpha.to(dtype)) * p
            rx_new = _acc(res_at(alpha))
            cx_new = _acc(cons_fn(x_new))
            cnt = cnt.bump(res=1, cons=1)
            cxna = take(cx_new, active_global)
            whsum = torch.sum(torch.where(act.valid, wa * cxna * cxna,
                                          zero_s), dim=-1)
            progress = 2 * psi0 - rows_dot(rx_new, rx_new) - whsum
            iau = torch.where(
                (index_alpha_upp != -1) &
                ((alpha - _acc(alpha_upp)).abs() > 0.1), -1, index_alpha_upp)
            # Cast decision-precision scalars back to the solve dtype.
            return SteplengthResult(
                alpha=alpha.to(dtype), w=w, K=K_new, psi_error=psi_err,
                index_alpha_upp=iau, predicted_reduction=pred.to(dtype),
                progress=progress.to(dtype), updated_progress=flag(True),
                counters=cnt)

        return cond(descent, search, no_descent, on)

    return cond(code == 2, newton_step, damped_step, lanes)
