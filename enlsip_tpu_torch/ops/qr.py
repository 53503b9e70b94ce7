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

``k``/``length`` arguments may be Python ints or 0-d tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
    kmax = min(rows, cols) if nsteps is None else int(nsteps)
    A = M.clone()
    G = None if aug is None else aug.clone()
    perm = torch.arange(cols, device=M.device)
    for k in range(kmax):
        sub = A[k:, k:]
        piv = k + torch.argmax(torch.sum(sub * sub, dim=0))
        idx = torch.stack([torch.as_tensor(k, device=M.device), piv])
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
    Returns a 0-d int64 tensor."""
    k = diag.shape[0]
    dev = diag.device
    length = torch.as_tensor(length, device=dev)
    if k == 0:
        return torch.zeros((), dtype=torch.int64, device=dev)
    idx = torch.arange(k, device=dev)
    d0 = diag[0].abs()
    flen = torch.clamp(length, min=1).to(diag.dtype)
    tol = d0 * torch.sqrt(flen) * eps_rank
    ok = (diag.abs() > tol) & (idx < length)
    r = torch.sum(torch.cumprod(ok.to(torch.int64), dim=0))
    return torch.where((length <= 0) | (d0 < eps_rank),
                       torch.zeros_like(r), r)


def _masked_tri(Rk: torch.Tensor, k) -> torch.Tensor:
    """Doctor R so only its leading k x k block takes part in a solve:
    entries outside the block become the identity."""
    c = Rk.shape[0]
    i = torch.arange(c, device=Rk.device)
    inblk = (i[:, None] < k) & (i[None, :] < k)
    return torch.where(inblk, Rk, torch.eye(c, dtype=Rk.dtype,
                                            device=Rk.device))


def _solve_masked(R: torch.Tensor, b: torch.Tensor, k, upper: bool
                  ) -> torch.Tensor:
    c = R.shape[0]
    i = torch.arange(c, device=R.device)
    Rm = _masked_tri(R[:, :c], k)
    live = i < k
    bm = torch.where(live, b[:c], torch.zeros_like(b[:c]))
    x = torch.linalg.solve_triangular(Rm, bm[:, None], upper=upper)[:, 0]
    return torch.where(live, x, torch.zeros_like(x))


def solve_upper(R: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """x[:k] = R[:k,:k]^-1 b[:k]; x[k:] = 0."""
    return _solve_masked(R, b, k, upper=True)


def solve_lower(L: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """x[:k] = L[:k,:k]^-1 b[:k]; x[k:] = 0 (forward substitution)."""
    return _solve_masked(L, b, k, upper=False)


def invperm(perm: torch.Tensor) -> torch.Tensor:
    """Inverse permutation: out[perm[i]] = i."""
    out = torch.empty_like(perm)
    out[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return out


def prefix_dot(v: torch.Tensor, k) -> torch.Tensor:
    """<v[:k], v[:k]> with ``k`` an int or 0-d tensor."""
    idx = torch.arange(v.shape[0], device=v.device)
    return torch.sum(torch.where(idx < k, v * v, torch.zeros_like(v)))


def prefix_norm(v: torch.Tensor, k) -> torch.Tensor:
    """||v[:k]||."""
    return torch.sqrt(prefix_dot(v, k))
