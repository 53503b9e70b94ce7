"""Column-pivoted QR of an (m, n) buffer whose rows are sharded over ranks.

The counterpart of what GSPMD makes of ``ops/blocked_qr.py``'s pivot
loop when the JAX package row-shards J2 over a mesh
(``enlsip_tpu/parallel/rowsharded.py``, ``tsqr=False``): the rank-1
Householder loop with EXACT trailing column norms, as ``_cpqr_xla``, run
on every rank's contiguous block of m / D rows with the n-space state
(norms, pivot, R, T) replicated.

Collectives a pivot step (both ``all_reduce`` of an n-vector):

1. this rank's partial trailing column norms (rows >= k) together with
   row k of the buffer, which only its owner fills: every rank then
   picks the same pivot (first maximum) and knows the head element
   alpha of the reflector and the rest of R's row k;
2. the partial products v^T B of the reflector with the trailing
   columns, from which every rank updates its own rows and R's row k.

After the loop one exact merge assembles R (the leading min(m, n) rows)
and one sum gives each WY panel's V^T V for its T factor.  The tail
norm of the reflector is the pivot column's norm from step 1, so the
loop needs nothing else.

``qt_apply_rows`` applies Q^T to a row-sharded vector with one
collective a panel and returns the replicated compact embedding of
``ops/tsqr.py``: the leading min(m, n) coefficients, then the norm of
the rest, so ``sum(out**2) == ||v||**2``.  Every consumer of the solver's
d-vector reads leading entries and norms of it only.

The JAX package takes the downdated-norm panel loop on the CPU from
kmax >= 192 (``_cpqr_xla_panels``); this loop keeps exact norms at any
size, so pivot ties can break differently there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._dist import Mesh, all_reduce, merge_disjoint
from .blocked_qr import NB, _clamp_steps, _panel_T, _panels, panel_width


class RowCPQRF(NamedTuple):
    """Pivoted QR of a row-sharded buffer: R (kmax, n), perm, T and diag
    replicated; V (local rows, kp) this rank's rows of the reflectors."""

    R: torch.Tensor
    perm: torch.Tensor
    V: torch.Tensor
    tau: torch.Tensor
    T: torch.Tensor
    diag: torch.Tensor
    mesh: Mesh


def _global_rows(rows: int, mesh: Mesh, device) -> torch.Tensor:
    return torch.arange(rows, device=device) + mesh.rank * rows


def cpqr_rows(M: torch.Tensor, nsteps, mesh: Mesh, nb: int = NB
              ) -> RowCPQRF:
    """Column-pivoted QR of the (m, n) buffer whose rows
    [rank * rows, (rank + 1) * rows) are this rank's ``M`` (rows, n).
    ``nsteps`` bounds the steps to the live columns, as in
    ``cpqr_blocked``; zero columns pivot last."""
    rows, cols = M.shape
    kmax = min(rows * mesh.size, cols)
    nb, kp = panel_width(kmax, nb)
    dtype, dev = M.dtype, M.device
    g = _global_rows(rows, mesh, dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    B = M.clone()
    V = torch.zeros((rows, kp), dtype=dtype, device=dev)
    taus = torch.zeros(kp, dtype=dtype, device=dev)
    perm = torch.arange(cols, device=dev)
    off = mesh.rank * rows
    for k in range(_clamp_steps(nsteps, kmax)):
        part = torch.sum(torch.where((g >= k)[:, None], B * B, zero), dim=0)
        rowk = B[k - off] if 0 <= k - off < rows else torch.zeros_like(part)
        red = all_reduce(torch.cat([part, rowk]), mesh)
        nrm2, rowk = red[:cols], red[cols:]
        piv = k + torch.argmax(nrm2[k:])
        idx = torch.stack([torch.as_tensor(k, device=dev), piv])
        swp = idx.flip(0)
        B[:, idx] = B[:, swp]
        perm[idx] = perm[swp]
        nrm2, rowk = nrm2.clone(), rowk.clone()
        nrm2[idx], rowk[idx] = nrm2[swp], rowk[swp]
        # the reflector of ops/blocked_qr._householder_col, from the
        # replicated head alpha and tail norm
        alpha, signorm = rowk[k], torch.sqrt(nrm2[k])
        beta = torch.where(alpha >= 0, -signorm, signorm)
        denom = alpha - beta
        safe = denom.abs() > 0
        denom = torch.where(safe, denom, one)
        tau = torch.where(safe & (beta != 0),
                          (beta - alpha) / torch.where(beta != 0, beta, one),
                          zero)
        v = torch.where(g > k, B[:, k] / denom,
                        torch.where(g == k, safe.to(dtype), zero))
        if k + 1 < cols:
            w = all_reduce(v @ B[:, k + 1:], mesh)
            B[:, k + 1:] -= torch.outer(v, tau * w)
        B[:, k] = torch.where(g == k, torch.where(safe, beta, alpha),
                              torch.where(g > k, v, B[:, k]))
        V[:, k] = v
        taus[k] = tau
    lead = torch.zeros((kmax, cols), dtype=dtype, device=dev)
    mine = g < kmax
    lead[g[mine]] = B[mine]
    R = torch.triu(merge_disjoint(lead, mesh))
    T = _panel_T(V, taus, nb, sum_rows=lambda t: all_reduce(t, mesh))
    return RowCPQRF(R=R, perm=perm, V=V, tau=taus, T=T,
                    diag=torch.diagonal(R).clone(), mesh=mesh)


def qt_apply_rows(f: RowCPQRF, v: torch.Tensor) -> torch.Tensor:
    """Q^T v for this rank's rows ``v`` of a row-sharded vector, as the
    replicated (kmax + 1,) embedding: the leading kmax coefficients, then
    the norm of the remaining ones."""
    x = v[:, None]
    for Vi, Ti in _panels(f):
        x = x - Vi @ (Ti.transpose(-1, -2) @ all_reduce(Vi.transpose(-1, -2)
                                                        @ x, f.mesh))
    x = x[:, 0]
    kmax = f.R.shape[0]
    g = _global_rows(x.shape[0], f.mesh, x.device)
    lead = g < kmax
    buf = torch.zeros(kmax + 1, dtype=x.dtype, device=x.device)
    buf[g[lead]] = x[lead]
    buf[kmax] = torch.sum(torch.where(lead, torch.zeros_like(x), x * x))
    buf = all_reduce(buf, f.mesh)
    return torch.cat([buf[:kmax], torch.sqrt(buf[kmax:])])
