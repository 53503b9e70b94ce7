"""Two-stage column-pivoted QR of a tall (m, n) buffer.

Counterpart of ``enlsip_tpu/ops/tsqr.py``.  The direct pivoted QR
(``ops/blocked_qr.py``) takes one sequential step per live column, each
streaming the whole (m, n) buffer; for m >> n two stages do the same
job with one or two passes over the tall data:

* :func:`cholqr_cpqr` (the default, ``Options.tall_qr="cholqr"``): the
  Gram matrix G = M^T M, its shifted Cholesky factor R1, and the pivoted
  QR of the (n, n) R1.  Q = M R1^{-1} stays implicit: no (m, n) Q buffer
  exists, and Q^T v costs one M^T v and an (n, n) triangular solve;
* :func:`tsqr_cpqr` (``tall_qr="qr"``): one unpivoted thin QR of the
  whole buffer and the pivoted QR of its (n, n) R.

Both preserve the column norms of M in their first-stage factor, so the
second stage pivots and ranks exactly like the direct factorization and
R, perm and diag have the direct factorization's shapes and meaning.

Row-sharded forms, inside the row scope of ``_dist.py`` (the giant-m
solve of ``parallel/rowsharded.py``, every rank holding m / D rows of M):
:func:`cholqr_cpqr` sums the ranks' (n, n) Grams, with M^T rx when it is
given, by ONE ``all_reduce`` a factorization, the one psum GSPMD gives
the JAX package; :func:`tsqr_cpqr` with ``axis`` factors each rank's
block by a thin QR and the (D n, n) stack of the local R factors by one
replicated pivoted QR (one exact gather).  The Q^T applications return
the compact replicated embedding (leading coefficients, then the norm of
the rest) and reduce their projections the same way.

Every function takes leading lane axes on its tensors like the rest of
the package (``torch.linalg.cholesky_ex``, ``solve_triangular`` and
``matmul`` batch natively).

Numerical envelope of CholeskyQR: cond(G) = cond(M)^2, so the implicit Q
loses orthogonality for cond(M) beyond about eps^(-1/2).  For the
Gauss-Newton subproblem this perturbs the direction, not correctness
(descent is re-checked by the merit machinery);
``Options(tall_qr="qr")`` restores the Householder path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._dist import (all_reduce, gather_slots, row_mesh_in_scope, rows_sum)
from .._lanes import dot, ex, mtv
from .blocked_qr import (CPQRF, _householder_col, _panel_T, cpqr_blocked,
                         qt_apply)


class TSQRF(NamedTuple):
    """Thin QR + pivoted QR of its R: ``qloc`` (m, n) the thin Q, ``f2``
    the CPQR of the (n, n) R.  With ``axis`` (the row-sharded form),
    ``qloc`` is this rank's (m / D, n) block and ``f2`` the CPQR of the
    (D n, n) stack of the ranks' R factors.  Exposes R / perm / diag with
    the shapes the direct CPQRF has for m >= n."""

    qloc: torch.Tensor
    f2: CPQRF
    axis: Optional[str] = None

    @property
    def R(self):
        return self.f2.R[..., :self.qloc.shape[-1], :]

    @property
    def perm(self):
        return self.f2.perm

    @property
    def diag(self):
        return self.f2.diag[..., :self.qloc.shape[-1]]


def _axis_mesh():
    mesh = row_mesh_in_scope()
    if mesh is None:
        raise ValueError(
            "tsqr over a row axis requires an ambient row mesh; run the "
            "solve inside _dist.row_scope(mesh), as "
            "parallel.rowsharded.solve_rowsharded does")
    return mesh


# Columns a panel of the card's tall QR (:func:`_householder_thin`).
_THIN_NB = 16


def _householder_thin(M: torch.Tensor):
    """The unpivoted blocked Householder QR of a tall ``M`` (m, n): panels
    of ``_THIN_NB`` columns, each factored by reflector steps (a
    matrix-vector product and a rank-1 update of the panel's later
    columns), then the trailing columns updated once by the panel's
    compact-WY form Q_p^T = I - V T^T V^T (two matrix products).  It
    works on a transposed copy, where a column is a contiguous row.
    Returns (V (m, n) unit lower, tau (n,), R (n, n)), the reflectors of
    LAPACK's convention, as geqrf gives them.  This is the card's tall
    QR: cuSOLVER's geqrf of more than 4,096 rows, and its orgqr, cannot
    be captured inside a conditional node's body."""
    m, n = M.shape
    At = M.t().contiguous()          # (n, m): column k of M is row k
    taus = M.new_zeros(n)
    for j0 in range(0, n, _THIN_NB):
        j1 = min(n, j0 + _THIN_NB)
        Vp = M.new_zeros((j1 - j0, m))
        for k in range(j0, j1):
            v, tau, diag = _householder_col(At[k], k)
            if k + 1 < j1:
                rest = At[k + 1:j1, k:]
                w = rest @ v[k:]
                rest.addmm_(w[:, None], (tau * v[k:])[None, :], alpha=-1.0)
            At[k, k] = diag
            At[k, k + 1:] = v[k + 1:]
            Vp[k - j0] = v
            taus[k] = tau
        if j1 < n:
            T = _panel_T(Vp.t(), taus[j0:j1], j1 - j0)[0]
            trail, Vj = At[j1:, j0:], Vp[:, j0:]
            trail.addmm_((trail @ Vj.t()) @ T, Vj, alpha=-1.0)
    r = torch.triu(At[:, :n].t())
    V = At.t()
    V[:n].copy_(torch.tril(V[:n], -1))
    V.diagonal().fill_(1.0)      # LAPACK's unit diagonal, also where tau = 0
    return V, taus, r


def thin_qr(M: torch.Tensor):
    """``torch.linalg.qr(M, mode="reduced")`` of a tall ``M`` (m, n), m >=
    n, by Householder reflectors: LAPACK's geqrf on the CPU, the loop of
    :func:`_householder_thin` on a CUDA device.  R is the reflectors'
    upper triangle and Q's first n columns are E - V (T V[:n]^T), the
    compact-WY form Q = I - V T V^T of the reflectors (one matrix
    product)."""
    n = M.shape[-1]
    if M.is_cuda:
        V, tau, r = _householder_thin(M)
    else:
        a, tau = torch.geqrf(M)
        V = torch.tril(a, -1)
        V.diagonal(dim1=-2, dim2=-1).fill_(1.0)
        r = torch.triu(a[..., :n, :])
    T = _panel_T(V, tau, n)[..., 0, :, :]
    # negated in place: -(V @ ...) would hold a second (m, n) buffer
    q = V @ (T @ V[..., :n, :].transpose(-1, -2))
    q.neg_()
    q.diagonal(dim1=-2, dim2=-1).add_(1.0)
    return q, r


def tsqr_cpqr(M: torch.Tensor, nsteps, axis: Optional[str] = None) -> TSQRF:
    """Column-pivoted QR of a tall ``M`` (m, n), m >= n: one thin
    QR of the whole matrix (:func:`thin_qr`), then the pivoted QR of its
    (n, n) R, with ``nsteps`` bounding the pivot steps (live columns).
    Column norms, hence pivoting and rank decisions, are those of M.

    ``axis``: the row-sharded form over the row scope's mesh; ``M``
    is this rank's block (m / D >= n rows), factored by a local thin QR,
    and the (D n, n) stack of the ranks' R factors, whose columns have
    the whole matrix's norms, by one replicated pivoted QR."""
    if axis is None:
        q, r = thin_qr(M)
        return TSQRF(qloc=q, f2=cpqr_blocked(r, nsteps=nsteps,
                                             device=M.device))
    mesh = _axis_mesh()
    rows, n = M.shape
    if rows < n:
        raise ValueError(f"tsqr needs m / D >= n row panels, got {rows} "
                         f"rows a rank for n = {n}")
    q, r = thin_qr(M)
    stack = gather_slots(r, mesh).reshape(mesh.size * n, n)
    return TSQRF(qloc=q, f2=cpqr_blocked(stack, nsteps=nsteps,
                                         device=M.device), axis=axis)


class CholQRF(NamedTuple):
    """Shifted CholeskyQR + pivoted QR of the (n, n) triangular factor.

    M: the factored (m, n) buffer (not copied), or a (0, n) placeholder
      when the caller never materialized it;
    R1: (n, n) upper Cholesky factor of the masked, shifted Gram, dead
      columns zeroed;
    f2: CPQR of R1 (single pass) or of R2 @ R1 (refined);
    R2: the CholeskyQR2 refinement factor (float64 only, else None), kept
      SEPARATE from R1 so the Q^T application composes two backward-stable
      solves instead of solving with the rounded product;
    G: the UNMASKED Gram M^T M, kept so consumers can replace (m,)-length
      streams by (n, n) products (M^T (M y) == G y);
    jtrx: optional precomputed M^T rx (the fused WY kernel emits it with
      the Gram)."""

    M: torch.Tensor
    R1: torch.Tensor
    f2: CPQRF
    R2: Optional[torch.Tensor] = None
    G: Optional[torch.Tensor] = None
    jtrx: Optional[torch.Tensor] = None

    @property
    def R(self):
        return self.f2.R[..., :self.M.shape[-1], :]

    @property
    def perm(self):
        return self.f2.perm

    @property
    def diag(self):
        return self.f2.diag[..., :self.M.shape[-1]]


def _cholesky_upper(G: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor of ``G``, NaN where the factorization broke
    down (``torch.linalg.cholesky_ex`` reports failure through ``info``
    instead; the callers select on finiteness, with no host branch)."""
    L, info = torch.linalg.cholesky_ex(G)
    nan = torch.full((), float("nan"), dtype=G.dtype, device=G.device)
    return torch.where(ex(info != 0, 2), nan, L).transpose(-1, -2)


def _solve_rt(R: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``R^T X = B`` for upper-triangular ``R``."""
    return torch.linalg.solve_triangular(R.transpose(-1, -2), B, upper=False)


def cholqr_cpqr(M: torch.Tensor, nsteps, col_live=None, gram=None,
                jtrx=None) -> CholQRF:
    """Column-pivoted QR of a tall (m, n) buffer via shifted CholeskyQR
    (implicit Q) + pivoted QR of R1.

    ``gram``: M^T M where the caller already holds it (the fused WY
    kernel emits it with the apply); ``M`` is then not read and may be a
    (0, n) placeholder.  ``col_live`` (n,) bool: columns outside it are
    dead; masking happens on the (n, n) Gram, so ``M`` is passed
    unmasked.  ``jtrx``: M^T rx to keep beside the Gram.  Inside a row
    scope, ``M``, ``gram`` and ``jtrx`` are this rank's rows' parts, and
    one ``all_reduce`` sums the Gram (with ``jtrx`` when given).

    At float64 a CholeskyQR2-style refinement runs on the Gram alone:
    the implicit Q becomes M R1^{-1} R2^{-1} with R2 the Cholesky factor
    of R1^{-T} G R1^{-1} — two (n, n) triangular solves and one (n, n)
    Cholesky, no second pass over the tall data.  At float32 it is
    skipped (it gains little below cond 1e3 and can destabilize beyond
    1e4, a range the float32 pseudo-rank truncation cuts off anyway).
    The split is static on the dtype."""
    n = M.shape[-1]
    dtype, dev = M.dtype, M.device
    G_raw = (M.transpose(-1, -2) @ M) if gram is None else gram   # (n, n)
    if row_mesh_in_scope() is not None:
        if jtrx is None:
            G_raw = rows_sum(G_raw)
        else:
            red = rows_sum(torch.cat([G_raw.reshape(-1), jtrx]))
            G_raw, jtrx = red[:n * n].reshape(n, n), red[n * n:]
    G = G_raw
    zero = torch.zeros((), dtype=dtype, device=dev)
    if col_live is not None:
        G = torch.where(col_live[..., None, :] & col_live[..., :, None], G,
                        zero)
    dG = torch.diagonal(G, dim1=-2, dim2=-1)
    live = dG > 0.0
    eps = torch.finfo(dtype).eps
    eye = torch.eye(n, dtype=dtype, device=dev)
    shift = eps * torch.amax(dG, dim=-1)
    R1 = _cholesky_upper(G + ex(shift, 2) * eye)
    # Exact-zero (masked) columns must stay exactly zero so stage-2
    # pivoting/rank logic never sees the shift; a failed factorization
    # (an all-dead Gram) collapses to zero the same way.
    live_c = live[..., None, :]
    live2 = live_c & live[..., :, None]
    R1 = torch.where(live_c & torch.isfinite(R1), R1, zero)
    if eps > torch.finfo(torch.float64).eps:
        # single pass
        return CholQRF(M=M, R1=R1,
                       f2=cpqr_blocked(R1, nsteps=nsteps, device=dev),
                       G=G_raw, jtrx=jtrx)
    # --- float64 refinement pass (implicit CholeskyQR2) -----------------
    # G_Q = R1^{-T} G R1^{-1} is the Gram of the implicit Q; its Cholesky
    # factor R2 measures (and removes) the orthogonality loss.  Dead
    # rows/cols are patched to the identity for the solves and re-zeroed.
    dead_eye = torch.where(live, zero, 1.0 + zero)[..., None, :] * eye
    R1p = R1 + dead_eye
    Gl = torch.where(live2, G, zero) + dead_eye
    X = _solve_rt(R1p, Gl)                                      # R1^{-T} G
    GQ = _solve_rt(R1p, X.transpose(-1, -2)).transpose(-1, -2)  # X R1^{-1}
    GQ = 0.5 * (GQ + GQ.transpose(-1, -2))
    shift2 = eps * torch.amax(torch.diagonal(GQ, dim1=-2, dim2=-1), dim=-1)
    R2 = _cholesky_upper(GQ + ex(shift2, 2) * eye)
    R2 = torch.where(live2 & torch.isfinite(R2), R2, zero)
    # A failed refinement Cholesky (any live column it killed) falls back
    # to the single-pass factor: a select, not a branch.
    ref_ok = torch.all(torch.diagonal(R2, dim1=-2, dim2=-1).gt(0.0) | ~live,
                       dim=-1)
    live_eye = torch.where(live, 1.0 + zero, zero)[..., None, :] * eye
    R2 = torch.where(ex(ref_ok, 2), R2, live_eye)
    # Stage-2 pivoting/ranks read the refined product; the implicit-Q
    # application composes the two factors (see CholQRF.R2).
    Rr = torch.where(live_c, R2 @ R1, zero)
    return CholQRF(M=M, R1=R1, f2=cpqr_blocked(Rr, nsteps=nsteps, device=dev),
                   R2=R2, G=G_raw, jtrx=jtrx)


def qt_apply_cholqr_from_projection(f: CholQRF, y: torch.Tensor,
                                    v_sq: torch.Tensor) -> torch.Tensor:
    """:func:`qt_apply_cholqr` given the projection y = M^T v and ||v||^2
    already computed, for callers who can form both from small-side
    quantities and never stream the tall buffer."""
    return _qt_cholqr(f, y, v_sq)


def qt_apply_cholqr(f: CholQRF, v: torch.Tensor) -> torch.Tensor:
    """Q^T v with the (m,) embedding contract of :func:`qt_apply_tsqr`:
    the leading n entries are the stage-2 coefficients, entry [n] carries
    the orthogonal-complement norm (sum(out**2) == ||v||**2)."""
    y, v_sq = mtv(f.M, v), dot(v, v)
    if row_mesh_in_scope() is not None:
        red = rows_sum(torch.cat([y, v_sq[None]]))
        y, v_sq = red[:-1], red[-1]
    return _qt_cholqr(f, y, v_sq)


def _qt_cholqr(f: CholQRF, y: torch.Tensor, v_sq: torch.Tensor
               ) -> torch.Tensor:
    m, n = f.M.shape[-2:]
    # Elided mode: M is a (0, n) placeholder.  Every consumer of the
    # returned embedding reads at most the leading n entries plus the
    # complement norm at [n], so a compact (n + 1,) buffer is exact; the
    # row-sharded form (M a rank's rows) returns the same.
    if m == 0 or row_mesh_in_scope() is not None:
        m = n + 1
    # R1^T w = y on the live columns; dead rows/cols of R1 are zero, so
    # solve on a unit-diagonal-patched copy and re-zero.
    live = torch.diagonal(f.R1, dim1=-2, dim2=-1).abs() > 0.0
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    eye = torch.eye(n, dtype=f.R1.dtype, device=f.R1.device)
    dead_eye = torch.where(live, zero, 1.0 + zero)[..., None, :] * eye
    w = _solve_rt(f.R1 + dead_eye,
                  torch.where(live, y, zero)[..., None])[..., 0]
    w = torch.where(live, w, zero)
    if f.R2 is not None:
        # CholeskyQR2 composition: Q = M R1^{-1} R2^{-1}.
        w = _solve_rt(f.R2 + dead_eye, w[..., None])[..., 0]
        w = torch.where(live, w, zero)
    u = qt_apply(f.f2, w)                           # (n,)
    rest2 = torch.clamp(v_sq - dot(w, w), min=0.0)
    out = torch.zeros((*y.shape[:-1], m), dtype=y.dtype, device=y.device)
    out[..., :n] = u[..., :n]
    out[..., n] = torch.sqrt(rest2)
    return out


def qt_apply_tsqr(f: TSQRF, v: torch.Tensor) -> torch.Tensor:
    """Q^T v embedded in an (m,) buffer whose leading n entries are the
    coefficients in the two-stage basis (exact for every consumer: the
    triangular solves and prefix norms all read < n leading entries) and
    whose entry [n] carries the orthogonal-complement norm, so
    ``sum(out**2) == ||v||**2`` like the direct transform.

    Row-sharded form (``f.axis``): ``v`` is this rank's rows; the ranks'
    local projections, stacked, and ||v||^2 come from one ``all_reduce``,
    and the result is the replicated (D n + 1,) embedding of the stacked
    basis (entries in (n, D n) differ from the direct factorization's by
    a rotation of the complement; no consumer reads them one by one)."""
    if f.axis is not None:
        mesh = _axis_mesh()
        n = f.qloc.shape[-1]
        dn = mesh.size * n
        buf = torch.zeros(dn + 1, dtype=v.dtype, device=v.device)
        buf[mesh.rank * n:(mesh.rank + 1) * n] = mtv(f.qloc, v)
        buf[dn] = dot(v, v)
        buf = all_reduce(buf, mesh)
        w = buf[:dn]
        rest2 = torch.clamp(buf[dn] - dot(w, w), min=0.0)
        return torch.cat([qt_apply(f.f2, w), torch.sqrt(rest2)[None]])
    m, n = f.qloc.shape[-2:]
    w = mtv(f.qloc, v)                                 # (n,)
    u = qt_apply(f.f2, w)
    rest2 = torch.clamp(dot(v, v) - dot(w, w), min=0.0)
    out = torch.zeros((*v.shape[:-1], m), dtype=v.dtype, device=v.device)
    out[..., :n] = u
    out[..., n] = torch.sqrt(rest2)
    return out
