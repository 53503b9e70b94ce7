"""Fixed-shape masked dense linear algebra for the solver core.

Counterpart of ``enlsip_tpu/ops/qr.py``.  The reference solver
(Enlsip.jl) leans on LAPACK's column-pivoted Householder QR and on
triangular solves with data-dependent truncation dimensions; buffers
here keep fixed shapes and the live dimension ``k`` enters as a mask,
so the same functions can serve a batched solve later.

* :func:`cpqr` — unblocked column-pivoted Householder QR (the oracle
  the blocked variants are tested against).
* masked triangular solves where only the leading ``k x k`` block
  participates, the rest of the solution being zero.
* :func:`pseudo_rank` — the reference's diagonal-based numerical rank
  with its deliberate ``sqrt(len)`` tolerance factor.

``k``/``length`` arguments may be Python ints or per-lane tensors (0-d
for one solve, ``(B,)`` for a batch); vectors and matrices may carry
leading lane axes.  :func:`cpqr` itself is single-matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import cpu_int
from .._lanes import const, ex
from .blocked_qr import _householder_col


class CPQR(NamedTuple):
    """Column-pivoted QR of a masked buffer ``M`` (rows x cols):
    ``M[:, perm] = Q @ R`` on the live columns.

    R: (kmax, cols); perm: (cols,) int64; qt_aug: ``Q^T @ aug`` or None;
    diag: (kmax,) diagonal of R."""

    R: torch.Tensor
    perm: torch.Tensor
    qt_aug: Optional[torch.Tensor]
    diag: torch.Tensor


def cpqr(M: torch.Tensor, aug: Optional[torch.Tensor] = None, *,
         nsteps: Optional[int] = None) -> CPQR:
    """Unblocked column-pivoted Householder QR of a fixed-shape buffer.

    Invalid columns of ``M`` must be zeroed by the caller; pivoting on
    column norms then orders them last.  ``aug`` columns are not pivoted
    and not factored; they receive every reflector (``Q^T @ aug``)."""
    rows, cols = M.shape
    kmax = min(rows, cols) if nsteps is None else cpu_int(nsteps)
    A = M.clone()
    G = None if aug is None else aug.clone()
    perm = torch.arange(cols, device=M.device)
    for k in range(kmax):
        sub = A[k:, k:]
        piv = k + torch.argmax(torch.sum(sub * sub, dim=0))
        idx = torch.stack([torch.full_like(piv, k), piv])
        A[:, idx] = A[:, idx.flip(0)]
        perm[idx] = perm[idx.flip(0)]
        v, tau, _ = _householder_col(A[:, k], k)
        A -= tau * torch.outer(v, v @ A)
        if G is not None:
            G -= tau * torch.outer(v, v @ G)
        A[k + 1:, k] = 0.0
    R = A[:min(rows, cols) if nsteps is None else kmax, :]
    return CPQR(R=R, perm=perm, qt_aug=G, diag=torch.diagonal(R).clone())


def pseudo_rank(diag: torch.Tensor, length, eps_rank) -> torch.Tensor:
    """Numerical rank from a pivoted triangular diagonal.

    With ``tol = |d_0| * sqrt(length) * eps_rank`` the rank is the length
    of the leading run of entries with ``|d_i| > tol``; 0 if the diagonal
    is empty or ``|d_0| < eps_rank``.  Entries ``>= length`` are ignored.
    ``diag`` is (..., k) and ``length`` a per-lane count; returns a
    per-lane int64 tensor."""
    k = diag.shape[-1]
    dev = diag.device
    length = const(length, dev)
    if k == 0:
        return torch.zeros(diag.shape[:-1], dtype=torch.int64, device=dev)
    idx = torch.arange(k, device=dev)
    d0 = diag[..., 0].abs()
    flen = torch.clamp(length, min=1).to(diag.dtype)
    tol = d0 * torch.sqrt(flen) * eps_rank
    ok = (diag.abs() > ex(tol)) & (idx < ex(length))
    r = torch.sum(torch.cumprod(ok.to(torch.int64), dim=-1), dim=-1)
    return torch.where((length <= 0) | (d0 < eps_rank),
                       torch.zeros_like(r), r)


def _masked_tri(Rk: torch.Tensor, k) -> torch.Tensor:
    """Doctor R so only its leading k x k block takes part in a solve:
    entries outside the block become the identity."""
    c = Rk.shape[-1]
    i = torch.arange(c, device=Rk.device)
    k2 = ex(k, 2)
    inblk = (i[:, None] < k2) & (i[None, :] < k2)
    return torch.where(inblk, Rk, torch.eye(c, dtype=Rk.dtype,
                                            device=Rk.device))


def _solve_masked(R: torch.Tensor, b: torch.Tensor, k, upper: bool
                  ) -> torch.Tensor:
    c = R.shape[-2]
    i = torch.arange(c, device=R.device)
    Rm = _masked_tri(R[..., :, :c], k)
    live = i < ex(k)
    bc = b[..., :c]
    bm = torch.where(live, bc, torch.zeros_like(bc))
    x = torch.linalg.solve_triangular(Rm, bm[..., None], upper=upper)[..., 0]
    return torch.where(live, x, torch.zeros_like(x))


def solve_upper(R: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """x[:k] = R[:k,:k]^-1 b[:k]; x[k:] = 0 (per lane; ``k`` may be a
    Python int or a per-lane tensor)."""
    return _solve_masked(R, b, k, upper=True)


def solve_lower(L: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """x[:k] = L[:k,:k]^-1 b[:k]; x[k:] = 0 (forward substitution)."""
    return _solve_masked(L, b, k, upper=False)


def invperm(perm: torch.Tensor) -> torch.Tensor:
    """Inverse permutation along the last axis: out[perm[i]] = i."""
    ar = torch.arange(perm.shape[-1], dtype=perm.dtype, device=perm.device)
    return torch.empty_like(perm).scatter_(-1, perm, ar.expand_as(perm))


def prefix_dot(v: torch.Tensor, k) -> torch.Tensor:
    """<v[:k], v[:k]> per lane, ``k`` an int or a per-lane tensor."""
    idx = torch.arange(v.shape[-1], device=v.device)
    return torch.sum(torch.where(idx < ex(k), v * v, torch.zeros_like(v)),
                     dim=-1)


def prefix_norm(v: torch.Tensor, k) -> torch.Tensor:
    """||v[:k]||."""
    return torch.sqrt(prefix_dot(v, k))
