"""Active-set factorizations, multiplier estimates and search directions.

Counterpart of ``enlsip_tpu/core/subproblem.py``:

* EVSCAL  -> :func:`gather_active`
* MULEST  -> :func:`first_mult_estimate`
* LEAEST  -> :func:`second_mult_estimate`
* SUBDIR  -> :func:`sub_search_direction`
* GNSRCH  -> :func:`gn_search_direction`
* NEWTON  -> :func:`newton_search_direction` (the reference's
  finite-difference HESSF/HESSH are replaced by exact AD Hessian
  contractions, ``torch.func.jacrev`` of ``jacrev``)

All matrices live in fixed max-size buffers; the working set enters as
gathered, masked rows; ranks/dims are per-lane tensors (0-d for one
solve, ``(B,)`` for a batch), and every vector/matrix may carry leading
lane axes (see ``_lanes.py``).  Q factors stay
implicit: the pivoted QR (ops/blocked_qr.py) returns compact-WY
reflectors, so J @ Q1, Q^T v and Q v are a few matrix products each.

A tall J (rows >= 32 n and rows >= 4096) takes the two-stage
factorizations of ``ops/tsqr.py`` instead of the per-column pivot loop,
and, with one WY panel and 2-D operands, the fused apply + Gram +
projection kernels of ``ops/wy_hopper.py``; the residual Jacobian may
then also arrive factored as ``diag(s) @ base`` (``jac_base``), in which
case the dense J never exists.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .._lanes import dot, ex, mtv, mv, put, take, take_rows
from ..ops.blocked_qr import (CPQRF, _panels, cpqr_blocked, q_apply,
                              qt_apply, right_q_apply)
from ..ops.qr import invperm, pseudo_rank, solve_lower, solve_upper
from ..ops.tsqr import (CholQRF, TSQRF, cholqr_cpqr,
                        qt_apply_cholqr_from_projection, qt_apply_tsqr,
                        tsqr_cpqr)
from ..ops.wy_hopper import (use_wy_hopper, wy_gram_project,
                             wy_gram_project_noapply)
from .types import Dims, WorkingView, rdims_or


class ActiveConstraint(NamedTuple):
    """Gathered (and optionally row-scaled) active-constraint data.
    Rows beyond ``t`` are zero."""

    A_act: torch.Tensor       # (tmax, n)
    cx_act: torch.Tensor      # (tmax,)
    diag_scale: torch.Tensor  # (tmax,) row norms, or their inverses if scaling
    valid: torch.Tensor       # (tmax,) bool


class FactorA(NamedTuple):
    """Pivoted QR of the active-constraint transpose: A_act^T P = Q [R; 0].
    ``f`` holds the compact-WY factors (Q implicit); ``qt_gf = Q^T grad_f``
    is precomputed."""

    f: CPQRF           # R (ka, l), V (n, kp), T, perm, diag
    qt_gf: torch.Tensor   # (n,)

    @property
    def R(self):
        return self.f.R

    @property
    def perm(self):
        return self.f.perm

    @property
    def diag(self):
        return self.f.diag


class FactorL11(NamedTuple):
    """Pivoted QR of L11 = R_A^T: L11 P2 = Q2 [R11; 0].
    ``qt_b = Q2^T (-cx_act[perm_A])`` is precomputed (the rhs used by
    every consumer)."""

    R: torch.Tensor      # (ka, ka)
    perm: torch.Tensor   # (ka,)
    qt_b: torch.Tensor   # (l,)
    diag: torch.Tensor   # (ka,)


class FactorJ2(NamedTuple):
    """Pivoted QR of J2 (the trailing n-rankA columns of J @ Q1), kept
    full-width: columns < rankA are zeroed and pivot last.  Q3 stays
    implicit; ``d = Q3^T (-J1 p1 - rx)`` is computed per use."""

    # CPQRF: R (min(m,n), n), V (m, kp), T, perm, diag; or one of the
    # two-stage forms of a tall panel (ops/tsqr.CholQRF, TSQRF), which
    # expose R, perm and diag with the same shapes
    f: CPQRF

    @property
    def R(self):
        return self.f.R

    @property
    def perm(self):
        return self.f.perm

    @property
    def diag(self):
        return self.f.diag


def _gram_jtrx(f: CholQRF, rx: torch.Tensor) -> torch.Tensor:
    """JQ1^T rx: kept by the factorization when the fused kernel produced
    it, else one stream of the tall buffer."""
    return f.jtrx if f.jtrx is not None else mtv(f.M, rx)


def j2_transform_d(F_J2: FactorJ2, JQ1: torch.Tensor, p1n: torch.Tensor,
                   rx: torch.Tensor) -> torch.Tensor:
    """d = Q3^T (-J1 p1 - rx) (J1 p1 == JQ1 @ p1n since p1n is zero past
    the leading slots).  Dispatches on the factorization kind: the direct
    CPQR, the thin-QR two-stage form, or CholeskyQR with its kept Gram."""
    f = F_J2.f
    if isinstance(f, CholQRF) and f.G is not None:
        # Small-side algebra on the kept Gram (f.M is JQ1 on this path):
        # with v = -(JQ1 p1n) - rx,
        #   M^T v   = -(G p1n) - JQ1^T rx
        #   ||v||^2 = p1n^T G p1n + 2 p1n^T (JQ1^T rx) + ||rx||^2
        # so the (m,) vector v is never formed and the tall buffer is
        # streamed at most once (not at all when the kernel emitted
        # JQ1^T rx).
        #
        # Cancellation envelope: rebuilding M^T v and ||v||^2 from the
        # Gram has absolute error ~eps ||JQ1||^2 ||p1n|| instead of the
        # materialized-v path's ~eps ||JQ1|| ||v||.  When ||v|| <<
        # ||JQ1 p1n|| (near-exact GN steps on zero-residual problems) the
        # d-vector becomes noise-dominated earlier than on the dense
        # path; the noise exit tests absorb the difference, the solve
        # still ends at the same iterate to within the working
        # precision.  The LEAEST rhs in second_mult_estimate rides the
        # same Gram and has the same envelope.
        jtrx = _gram_jtrx(f, rx)
        Gp = mv(f.G, p1n)
        y = -Gp - jtrx
        v_sq = torch.clamp(dot(p1n, Gp) + 2.0 * dot(p1n, jtrx) + dot(rx, rx),
                           min=0.0)
        return qt_apply_cholqr_from_projection(f, y, v_sq)
    v = -mv(JQ1, p1n) - rx
    if isinstance(f, TSQRF):
        return qt_apply_tsqr(f, v)
    return qt_apply(f, v)


class GNResult(NamedTuple):
    p: torch.Tensor       # (n,) search direction
    b: torch.Tensor       # (tmax,) rhs of the p1 system
    d: torch.Tensor       # (m,) rhs of the p2 system
    rankA: torch.Tensor
    rankJ2: torch.Tensor
    F_J2: FactorJ2
    JQ1: torch.Tensor     # (m, n); a (0, n) placeholder when elided
    y: torch.Tensor       # (n,) pre-Q1 coefficients: p == Q1 @ y


def _embed(v: torch.Tensor, size: int) -> torch.Tensor:
    """``v`` in the leading slots of a zero vector of length ``size``."""
    return torch.nn.functional.pad(v, (0, size - v.shape[-1]))


def gather_active(A: torch.Tensor, cx: torch.Tensor, view: WorkingView,
                  dims: Dims, scaling: bool) -> ActiveConstraint:
    """Gather the active rows of A / entries of cx into fixed (tmax, ...)
    buffers and apply EVSCAL row scaling."""
    tmax = dims.tmax
    eps = torch.finfo(A.dtype).eps
    rows_idx = view.active_list[..., :tmax]
    valid = torch.arange(tmax, device=A.device) < ex(view.t)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    A_act = torch.where(valid[..., None], take_rows(A, rows_idx), zero)
    cx_act = torch.where(valid, take(cx, rows_idx), zero)
    row_nrm = torch.sqrt(torch.sum(A_act * A_act, dim=-1))
    if scaling:
        safe = torch.where(row_nrm.abs() < eps, torch.ones_like(row_nrm),
                           row_nrm)
        A_act = A_act / safe[..., None]
        cx_act = cx_act / safe
        diag_scale = 1.0 / safe
    else:
        diag_scale = row_nrm
    return ActiveConstraint(A_act, cx_act, diag_scale, valid)


def factor_active(act: ActiveConstraint, gf: torch.Tensor, t,
                  dims: Dims) -> FactorA:
    """F_A = pivoted QR of A_act^T (t live columns); qt_gf = Q^T grad_f."""
    f = cpqr_blocked(act.A_act.transpose(-1, -2), nsteps=t, device=gf.device)
    return FactorA(f=f, qt_gf=qt_apply(f, gf))


def zeros_factor_l11(dims: Dims, dtype, device, lead=()) -> FactorL11:
    """Placeholder F_L11 for paths that never read it (full-rank GN):
    any consumer output fed by it is masked away before use.  ``lead``:
    leading lane axes."""
    ka, l = dims.ka, dims.l
    z = lambda *shape: torch.zeros((*lead, *shape), dtype=dtype, device=device)
    return FactorL11(R=z(ka, ka),
                     perm=torch.arange(ka, device=device).expand(*lead, ka),
                     qt_b=z(l), diag=z(ka))


def factor_l11(F_A: FactorA, act: ActiveConstraint, t) -> FactorL11:
    """F_L11 = pivoted QR of L11 = R_A^T ((l, ka) buffer; rows beyond t
    are automatically zero because the masked slots of A pivot last);
    qt_b = Q2^T (-cx_act[perm_A])."""
    ka, l = F_A.R.shape[-2:]
    i = torch.arange(l, device=F_A.R.device)
    L11 = F_A.R.transpose(-1, -2)        # (l, ka)
    cxp = take(act.cx_act, F_A.perm)
    bvec = -torch.where(i < ex(t), cxp, torch.zeros_like(cxp))
    f = cpqr_blocked(L11, nsteps=torch.clamp(torch.as_tensor(t), max=ka),
                     device=L11.device)
    return FactorL11(R=f.R, perm=f.perm, qt_b=qt_apply(f, bvec), diag=f.diag)


def _slots_to_constraints(v: torch.Tensor, F_A: FactorA, l: int
                          ) -> torch.Tensor:
    """Pivot-slot vector (ka,) -> active-slot order (l,)."""
    return take(_embed(v, l), invperm(F_A.perm))


def first_mult_estimate(F_A: FactorA, act: ActiveConstraint, t, dims: Dims,
                        scaling: bool, eps_rank):
    """MULEST.  Returns (lam, grad_res): first-order Lagrange multipliers
    in active slot order (l buffer) and the projected-gradient residual
    norm ``||(Q^T grad_f)[prankA:]||``."""
    l, ka = dims.l, dims.ka
    prankA = pseudo_rank(F_A.diag, t, eps_rank)
    b = F_A.qt_gf  # (n,)
    Rkk = F_A.R[..., :ka, :ka]
    lam_ls = _slots_to_constraints(solve_upper(Rkk, b[..., :ka], prankA),
                                   F_A, l)
    idx_n = torch.arange(dims.n, device=b.device)
    grad_res = torch.sqrt(torch.sum(torch.where(idx_n >= ex(prankA), b * b,
                                                torch.zeros_like(b)), dim=-1))
    b2 = -take(act.cx_act, F_A.perm)
    y = solve_lower(Rkk.transpose(-1, -2), b2[..., :ka], prankA)
    u = solve_upper(Rkk, y, prankA)
    lam = lam_ls + _slots_to_constraints(u, F_A, l)
    if scaling:
        lam = lam * act.diag_scale
    return torch.where(act.valid, lam, torch.zeros_like(lam)), grad_res


def second_mult_estimate(F_A: FactorA, JQ1: torch.Tensor, rx: torch.Tensor,
                         J: torch.Tensor, p_gn: torch.Tensor, t,
                         act: ActiveConstraint, dims: Dims, scaling: bool,
                         F_J2: FactorJ2 | None = None,
                         y_gn: torch.Tensor | None = None,
                         jac_base=None) -> torch.Tensor:
    """LEAEST: solve A^T lam = J1^T (rx + J p).

    The reference calls this with its *default* eps_rank = sqrt(eps),
    not the solver option; reproduced.  (Only consumed on the full-rank
    path, where t == rankA <= ka.)

    ``F_J2``/``y_gn``: the GN products of the CholeskyQR tall path.  With
    p == Q1 y and the Gram G = JQ1^T JQ1 held by the factorization,
    J1^T (rx + J p) == (JQ1^T rx + G y)[:t]: the two (m, n) streams
    (J @ p and JQ1^T v) become at most one (the JQ1^T rx projection,
    shared with the d-vector's) plus an (n, n) product.  ``jac_base``:
    factored mode, where ``J`` holds the (m, 1) row scale."""
    l, ka = dims.l, dims.ka
    eps_rank = torch.finfo(rx.dtype).eps ** 0.5
    prankA = pseudo_rank(F_A.diag, t, eps_rank)
    cols = torch.arange(dims.n, device=rx.device) < ex(t)
    if F_J2 is not None and y_gn is not None and \
            isinstance(F_J2.f, CholQRF) and F_J2.f.G is not None:
        b_raw = _gram_jtrx(F_J2.f, rx) + mv(F_J2.f.G, y_gn)
    else:
        # J1^T v with J1 = first t cols of JQ1: mask the (n,) RESULT.
        if jac_base is not None:  # factored J: J p = s * (base p)
            Jp_gn = J[..., 0] * mv(jac_base, p_gn)
        else:
            Jp_gn = mv(J, p_gn)
        b_raw = mtv(JQ1, rx + Jp_gn)
    b_full = torch.where(cols, b_raw, torch.zeros_like(b_raw))  # (n,)
    v = solve_upper(F_A.R[..., :ka, :ka], b_full[..., :ka], prankA)
    lam = _slots_to_constraints(v, F_A, l)
    if scaling:
        lam = lam * act.diag_scale
    return torch.where(act.valid, lam, torch.zeros_like(lam))


def _p1_stabilized(F_L11: FactorL11, dimA, rankA) -> torch.Tensor:
    """p1 for the rank-deficient path: solve R11[:dimA,:dimA] dp1 = qt_b,
    unpermute over the ka pivot slots, truncate to the first rankA
    entries.  Returns a (ka,) vector."""
    ka = F_L11.R.shape[-2]
    dp1 = solve_upper(F_L11.R[..., :ka, :ka], F_L11.qt_b[..., :ka], dimA)
    p1_full = put(torch.zeros_like(dp1), F_L11.perm, dp1)
    return torch.where(torch.arange(ka, device=dp1.device) < ex(rankA),
                       p1_full, torch.zeros_like(p1_full))


def sub_search_direction(act: ActiveConstraint, rx: torch.Tensor,
                         F_A: FactorA, F_L11: FactorL11, F_J2: FactorJ2,
                         JQ1: torch.Tensor, t, rankA, dimA, dimJ2, code,
                         dims: Dims):
    """SUBDIR, full-width formulation.

    code == 1: p1 = L11^-1 (-cx[P1])            (full-rank A)
    code == -1: stabilized p1 through F_L11      (rank-deficient A)
    then d = Q3^T (-J1 p1 - rx), p2 from dimJ2 columns of R22,
    p = Q1 (p1 ++ p2).

    Both branches are computed and selected (cheap triangular solves),
    which keeps this free of control flow."""
    n, ka = dims.n, dims.ka
    dev = rx.device
    bvec = -take(act.cx_act, F_A.perm)
    # Full-rank branch only valid when t <= ka (code 1 implies it);
    # the solve is clamped so the unselected branch stays finite.
    p1_full = solve_lower(F_A.R.transpose(-1, -2)[..., :ka, :ka],
                          bvec[..., :ka],
                          torch.clamp(torch.as_tensor(t, device=dev), max=ka))
    p1_stab = _p1_stabilized(F_L11, dimA, rankA)
    use_full = ex(torch.as_tensor(code, device=dev) == 1)
    p1 = torch.where(use_full, p1_full, p1_stab)   # (ka,)
    b = torch.where(use_full, bvec, F_L11.qt_b)    # (l,)
    # Embed p1 into y-coordinates (first rankA slots; rankA == t if code 1).
    p1n = _embed(p1, n)
    d = j2_transform_d(F_J2, JQ1, p1n, rx)     # (m,)
    kk = min(dims.m, n)
    dp2 = solve_upper(F_J2.R[..., :, :kk], d[..., :kk], dimJ2)  # (kk,)
    p2n = put(torch.zeros_like(p1n), F_J2.perm[..., :kk], dp2)
    y = p1n + p2n
    p = q_apply(F_A.f, y)
    return p, b, d, y


def gn_search_direction(J: torch.Tensor, rx: torch.Tensor,
                        act: ActiveConstraint, F_A: FactorA,
                        F_L11: FactorL11, rankA, t, eps_rank, dims: Dims,
                        rdims=None, tall_qr: str = "cholqr", jac_base=None,
                        elide_jq1: bool = False) -> GNResult:
    """GNSRCH: J Q1, the pivoted QR of its live columns, SUBDIR.

    ``jac_base`` (factored-Jacobian mode, ``Functions.jac_rowscale`` /
    ``jac_base``): ``J`` then holds the (m, 1) row scale and the semantic
    Jacobian is diag(J[:, 0]) @ jac_base; the WY apply streams the base
    with the scale fused in the kernel, so the dense J never exists.

    ``elide_jq1`` (the driver sets it when the Jacobian is factored AND
    second derivatives are off): additionally skip the (m, n) JQ1 write.
    Every consumer then rides the kept Gram (the small-side algebra of
    :func:`j2_transform_d` and :func:`second_mult_estimate`; the Newton
    branch, the only true JQ1 reader, is excluded by the option).
    ``GNResult.JQ1`` and ``CholQRF.M`` become (0, n) placeholders and the
    d-vector embedding compacts to (n + 1,) — exact for every consumer,
    which reads at most the leading n entries plus the complement norm.

    ``tall_qr``: "cholqr" or "qr", the two-stage factorization a tall
    panel takes (``Options.tall_qr``)."""
    n = dims.n
    rd = rdims_or(rdims, dims)
    rows = jac_base.shape[-2] if jac_base is not None else J.shape[-2]
    live_cols = torch.arange(n, device=J.device) >= ex(rankA)
    tall = rows >= 32 * n and rows >= 4096
    # Fused single-pass path (one tall solve, cholqr, one WY panel): the
    # apply, the CholeskyQR Gram and the JQ1^T rx projection are ONE pass
    # of the kernel over J (or the base) instead of five (m, n)-class
    # streams of separate matrix products.  The gate selects the fused
    # FORM: the wrappers launch the kernel on a CUDA tensor and run their
    # plain versions on a CPU tensor; outside the gate the Gram comes from
    # cholqr_cpqr's own products on either device.
    gram = jtrx = None
    panels = _panels(F_A.f)
    if tall and tall_qr == "cholqr" and len(panels) == 1 and J.ndim == 2 \
            and use_wy_hopper(rows, n, panels[0][0].shape[-1], J.dtype,
                              J.device):
        V0, T0 = panels[0]
        if jac_base is not None and elide_jq1:
            gram, jtrx = wy_gram_project_noapply(jac_base, V0, T0, rx,
                                                 rowscale=J[:, 0])
            JQ1 = torch.zeros((0, n), dtype=J.dtype, device=J.device)
        elif jac_base is not None:
            JQ1, gram, jtrx = wy_gram_project(jac_base, V0, T0, rx,
                                              rowscale=J[:, 0])
        else:
            JQ1, gram, jtrx = wy_gram_project(J, V0, T0, rx)
    elif jac_base is not None:
        JQ1 = J * right_q_apply(F_A.f, jac_base)    # (m, 1) broadcasts
    else:
        JQ1 = right_q_apply(F_A.f, J)
    # Only n - rankA columns are live; skip the no-op steps.
    zero = torch.zeros((), dtype=JQ1.dtype, device=JQ1.device)
    if tall and tall_qr == "cholqr":
        # Gram + shifted Cholesky, implicit Q.  JQ1 is passed UNMASKED;
        # dead columns are zeroed on the (n, n) Gram instead (the same
        # bits, and no masked (m, n) copy).
        F_J2 = FactorJ2(f=cholqr_cpqr(JQ1, nsteps=n - rankA,
                                      col_live=live_cols, gram=gram,
                                      jtrx=jtrx))
    elif tall:
        # Householder first stage: thin QR of the whole buffer + pivoted
        # QR of its R.
        J2buf = torch.where(live_cols[..., None, :], JQ1, zero)
        F_J2 = FactorJ2(f=tsqr_cpqr(J2buf, nsteps=n - rankA))
    else:
        J2buf = torch.where(live_cols[..., None, :], JQ1, zero)
        F_J2 = FactorJ2(f=cpqr_blocked(J2buf, nsteps=n - rankA,
                                       device=J.device))
    # Semantic diag length (pseudo_rank's sqrt(len) tolerance factor).
    len_diag = torch.minimum(rd.n - rankA, torch.as_tensor(rd.m,
                                                           device=J.device))
    rankJ2 = pseudo_rank(F_J2.diag, len_diag, eps_rank)
    code = torch.where(rankA == t, 1, -1)
    p, b, d, y = sub_search_direction(act, rx, F_A, F_L11, F_J2, JQ1, t,
                                      rankA, rankA, rankJ2, code, dims)
    return GNResult(p=p, b=b, d=d, rankA=rankA, rankJ2=rankJ2, F_J2=F_J2,
                    JQ1=JQ1, y=y)


def hessian_contractions(res_fn: Callable, cons_fn: Callable,
                         x: torch.Tensor, rx: torch.Tensor,
                         lam_full: torch.Tensor):
    """Exact AD replacements for HESSF/HESSH (one lane):

    r_mat = sum_k r_k(x0) * hess(r_k)(x)   = hess_x <r(x), rx_const>
    c_mat = sum_i lam_i   * hess(c_i)(x)   = hess_x <c(x), lam_full>
    """
    rxc = rx.detach()
    lamc = lam_full.detach()
    # Reverse over reverse in every dtype: torch.func's forward mode turns
    # a Python float times a 0-d float32 tensor (closures written on x[i],
    # as the HS problems are) into a float64 tangent, and
    # forward-over-reverse (torch.func.hessian) fails on the mixed types.
    hess = lambda f: torch.func.jacrev(torch.func.jacrev(f))
    r_mat = hess(lambda z: torch.dot(res_fn(z), rxc))(x)
    c_mat = hess(lambda z: torch.dot(cons_fn(z), lamc))(x)
    return r_mat, c_mat


def newton_search_direction(res_fn: Callable, cons_fn: Callable,
                            x: torch.Tensor, rx: torch.Tensor,
                            lam: torch.Tensor, view: WorkingView,
                            act: ActiveConstraint, F_A: FactorA,
                            F_L11: FactorL11, JQ1: torch.Tensor, rankA, t,
                            dims: Dims, rdims=None, hess=None):
    """NEWTON: KKT step on the null-space system with exact second-order
    terms.  Returns (p, error) where error mirrors the Cholesky-failure
    flag (-> exit code -3).

    ``hess(x, rx, lam_full) -> (r_mat, c_mat)`` replaces
    :func:`hessian_contractions` of ``res_fn``/``cons_fn`` (a batch
    passes its lane-mapped form).

    Deviation kept from the reference port: when t > rankA the Julia
    code permutes E by F_L11.p in a way that would index out of bounds
    for n > t; the intended permutation is applied on the leading t
    coordinates and identity elsewhere."""
    n, ka, l = dims.n, dims.ka, dims.l
    dev, dtype = x.device, x.dtype
    n_sem = ex(rdims_or(rdims, dims).n)
    bvec = -take(act.cx_act, F_A.perm)
    p1_full = solve_lower(F_A.R.transpose(-1, -2)[..., :ka, :ka],
                          bvec[..., :ka], torch.clamp(t, max=ka))
    p1_stab = _p1_stabilized(F_L11, rankA, rankA)
    p1 = torch.where(ex(t == rankA), p1_full, p1_stab)
    p1n = _embed(p1, n)

    # Scatter slot multipliers to the full constraint vector.
    lam_full = put(torch.zeros(l, dtype=dtype, device=dev), view.active_list,
                   torch.where(act.valid, lam, torch.zeros_like(lam)))
    if hess is None:
        r_mat, c_mat = hessian_contractions(res_fn, cons_fn, x, rx, lam_full)
    else:
        r_mat, c_mat = hess(x, rx, lam_full)
    Gamma = r_mat - c_mat
    E = right_q_apply(F_A.f, qt_apply(F_A.f, Gamma))
    # Permute leading-t coordinates by F_L11.p when t > rankA.
    idn = torch.arange(n, device=dev)
    kk = min(ka, n)
    lead = F_L11.perm.shape[:-1]
    permf = torch.cat([F_L11.perm[..., :kk], idn[kk:].expand(*lead, n - kk)],
                      dim=-1)
    permf = torch.where(idn < ex(t), permf, idn)
    Er = take_rows(E, permf)
    Ep = torch.gather(Er, -1, permf[..., None, :].expand_as(Er))
    E_used = torch.where(ex(t > rankA, 2), Ep, E)

    # Padded coordinates (>= the true n) are outside the Newton block.
    in2 = (idn >= ex(rankA)) & (idn < n_sem)
    J2 = torch.where(in2[..., None, :], JQ1,
                     torch.zeros((), dtype=dtype, device=dev))
    J2t = J2.transpose(-1, -2)
    W = E_used + J2t @ J2                     # W22 on the (>=rankA) block
    W21p1 = mv(E_used, p1n) + mv(J2t, mv(JQ1, p1n))
    dfull = torch.where(in2, -(W21p1) - mv(J2t, rx), torch.zeros_like(p1n))

    sW = 0.5 * (W + W.transpose(-1, -2))
    blk = in2[..., :, None] & in2[..., None, :]
    eye = torch.eye(n, dtype=dtype, device=dev)
    Wm = torch.where(blk, sW, eye)
    L, info = torch.linalg.cholesky_ex(Wm)
    bad = (info != 0) | torch.any(torch.isnan(L), dim=(-1, -2))
    Ls = torch.where(ex(bad, 2), eye, L)
    yv = torch.linalg.solve_triangular(Ls, dfull[..., None], upper=False)
    p2n = torch.linalg.solve_triangular(Ls.transpose(-1, -2), yv,
                                        upper=True)[..., 0]
    p2n = torch.where(in2, p2n, torch.zeros_like(p2n))
    p = q_apply(F_A.f, p1n + p2n)
    p = torch.where(ex(bad), torch.zeros_like(p), p)
    # rankA == n: constraints determine the step fully.
    full = rankA >= rdims_or(rdims, dims).n
    p = torch.where(ex(full), q_apply(F_A.f, p1n), p)
    error = bad & ~full
    return p, error
