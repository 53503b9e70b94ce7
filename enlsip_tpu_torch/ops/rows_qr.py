"""Column-pivoted QR of an (m, n) buffer whose rows are sharded over ranks.

The counterpart of what GSPMD makes of ``ops/blocked_qr.py``'s pivot
loops when the JAX package row-shards J2 over a mesh
(``enlsip_tpu/parallel/rowsharded.py``, ``tsqr=False``).  Under sharding
no Pallas kernel sees the operand, so the reference's ``cpqr_blocked``
takes, on every platform, the rank-1 loop with EXACT trailing column
norms (``_cpqr_xla``) below kmax = 192 and the geqp3-style panel loop
with DOWNDATED norms, recomputed exactly at every panel start
(``_cpqr_xla_panels``), from 192 on.  This module runs the same two
loops on every rank's contiguous block of m / D rows, with the n-space
state (norms, pivots, R's row k, the panel accumulator F, T) replicated:

* :func:`_exact_loop`, two ``all_reduce`` of an n-vector a pivot step:
  the partial trailing column norms (rows >= k) with row k of the
  buffer, which only its owner fills, so every rank picks the same pivot
  (first maximum) and knows the reflector's head alpha; then the partial
  products v^T B of the reflector with the columns;
* :func:`_panel_loop`, one ``all_reduce`` a panel start (the exact
  norms) and two a step: the partial tail norm of the current column
  with its head and the owner's rows k of the stale buffer and of the
  panel's reflectors; then the partial products B^T v and Vp^T v from
  which every rank forms the accumulator's column and the downdate.

Both loops are device-resident: a step count in device memory, the step
index a device scalar, every step a trip of ``_lanes.while_loop`` (a
WHILE node when captured), every row or column k taken by a clamped
gather and an ownership mask and written by a select, so nothing is read
back and no shape depends on data.  Every rank runs the same trips: the
step count and every decision come from replicated values.

After the loop one exact merge assembles R (the leading min(m, n) rows)
and one sum gives each WY panel's V^T V for its T factor.

``qt_apply_rows`` applies Q^T to a row-sharded vector with one
collective a panel and returns the replicated compact embedding of
``ops/tsqr.py``: the leading min(m, n) coefficients, then the norm of
the rest, so ``sum(out**2) == ||v||**2``.  Every consumer of the solver's
d-vector reads leading entries and norms of it only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._dist import Mesh, all_reduce, merge_disjoint
from .._lanes import const, while_loop
from .blocked_qr import LARGE_KMAX, NB, _panel_T, _panels, panel_width


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


def _owned_row(A: torch.Tensor, k: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Global row ``k`` of the row-sharded ``A`` where this rank owns it,
    zeros elsewhere (a clamped gather and an ownership mask; the sum over
    the ranks is the row)."""
    rows = A.shape[0]
    loc = k - mesh.rank * rows
    mine = (loc >= 0) & (loc < rows)
    row = A.index_select(0, torch.clamp(loc, 0, rows - 1).reshape(1))[0]
    return torch.where(mine, row, torch.zeros_like(row))


def _col(A: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return A.index_select(1, k.reshape(1))[:, 0]


def _swap(k: torch.Tensor, piv: torch.Tensor, n: int, device):
    """The index vector that swaps entries ``k`` and ``piv`` of n."""
    c = torch.arange(n, device=device)
    return torch.where(c == k, piv, torch.where(c == piv, k, c))


def _reflector(alpha, tail2, dtype):
    """(beta, tau, denom, safe) of ``blocked_qr._householder_col`` from
    the replicated head ``alpha`` and squared tail norm ``tail2``."""
    zero = torch.zeros((), dtype=dtype, device=alpha.device)
    one = torch.ones((), dtype=dtype, device=alpha.device)
    signorm = torch.sqrt(tail2)
    beta = torch.where(alpha >= 0, -signorm, signorm)
    denom = alpha - beta
    safe = denom.abs() > 0
    denom = torch.where(safe, denom, one)
    tau = torch.where(safe & (beta != 0),
                      (beta - alpha) / torch.where(beta != 0, beta, one),
                      zero)
    return beta, tau, denom, safe


def _exact_loop(M, ns, mesh: Mesh, kp: int):
    """The rank-1 loop with exact norms (``_cpqr_xla``); returns (B with
    R in its owned rows' upper part, V, taus, perm)."""
    rows, cols = M.shape
    dtype, dev = M.dtype, M.device
    g = _global_rows(rows, mesh, dev)
    cidx = torch.arange(cols, device=dev)
    kidx = torch.arange(kp, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def step(st):
        k, B, V, taus, perm = st
        part = torch.sum(torch.where((g >= k)[:, None], B * B, zero), dim=0)
        red = all_reduce(torch.cat([part, _owned_row(B, k, mesh)]), mesh)
        nrm2, rowk = red[:cols], red[cols:]
        piv = torch.argmax(torch.where(cidx >= k, nrm2,
                                       torch.full_like(nrm2, -1.0)))
        sw = _swap(k, piv, cols, dev)
        B = B.index_select(1, sw)
        perm = perm.index_select(0, sw)
        nrm2, rowk = nrm2.index_select(0, sw), rowk.index_select(0, sw)
        alpha, tail2 = rowk.index_select(0, k.reshape(1))[0], \
            nrm2.index_select(0, k.reshape(1))[0]
        beta, tau, denom, safe = _reflector(alpha, tail2, dtype)
        Bk = _col(B, k)
        v = torch.where(g > k, Bk / denom,
                        torch.where(g == k, safe.to(dtype), zero))
        w = all_reduce(v @ B, mesh)
        w = torch.where(cidx > k, tau * w, zero)
        B = B - torch.outer(v, w)
        newk = torch.where(g == k, torch.where(safe, beta, alpha),
                           torch.where(g > k, v, Bk))
        B = torch.where((cidx == k)[None, :], newk[:, None], B)
        V = torch.where((kidx == k)[None, :], v[:, None], V)
        taus = torch.where(kidx == k, tau, taus)
        return k + 1, B, V, taus, perm

    k0 = torch.zeros((), dtype=torch.int64, device=dev)
    V0 = torch.zeros((rows, kp), dtype=dtype, device=dev)
    t0 = torch.zeros(kp, dtype=dtype, device=dev)
    _, B, V, taus, perm = while_loop(
        lambda st: st[0] < ns, step,
        (k0, M.clone(memory_format=torch.contiguous_format), V0, t0,
         torch.arange(cols, device=dev)))
    return B, V, taus, perm


def _panel_loop(M, ns, mesh: Mesh, nb: int, kp: int):
    """The geqp3-style panel loop with downdated norms
    (``_cpqr_xla_panels``): within a panel the buffer stays stale and
    each reflector's effect is carried by the replicated accumulator F
    (updated_j = B - V_j F_j^T); the norms are exact at every panel start
    and downdated by R's row k after every step; the trailing matrix is
    updated once a panel.  Returns (B, V, taus, perm)."""
    rows, cols = M.shape
    dtype, dev = M.dtype, M.device
    g = _global_rows(rows, mesh, dev)
    cidx = torch.arange(cols, device=dev)
    jidx = torch.arange(nb, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    B = M.clone(memory_format=torch.contiguous_format)
    V = torch.zeros((rows, kp), dtype=dtype, device=dev)
    taus = torch.zeros(kp, dtype=dtype, device=dev)
    perm = torch.arange(cols, device=dev)

    for s in range(0, kp, nb):
        # exact trailing norms at the panel start
        nrm2 = all_reduce(torch.sum(torch.where((g >= s)[:, None], B * B,
                                                zero), dim=0), mesh)

        def step(st, s=s):
            j, B, Vp, tp, betas, perm, nrm2, F = st
            k = j + s
            piv = torch.argmax(torch.where(cidx >= k, nrm2,
                                           torch.full_like(nrm2, -1.0)))
            sw = _swap(k, piv, cols, dev)
            B = B.index_select(1, sw)
            F = F.index_select(0, sw)
            nrm2 = nrm2.index_select(0, sw)
            perm = perm.index_select(0, sw)
            before = (jidx < j).to(dtype)
            Fk = F.index_select(0, k.reshape(1))[0]
            # the current column with the panel's pending updates
            bcol = _col(B, k) - Vp @ (before * Fk)
            head = torch.cat([
                torch.sum(torch.where(g >= k, bcol * bcol, zero))[None],
                _owned_row(bcol[:, None], k, mesh),
                _owned_row(B, k, mesh), _owned_row(Vp, k, mesh)])
            head = all_reduce(head, mesh)
            tail2, alpha = head[0], head[1]
            rowB, rowV = head[2:2 + cols], head[2 + cols:]
            beta, tau, denom, safe = _reflector(alpha, tail2, dtype)
            v = torch.where(g > k, bcol / denom,
                            torch.where(g == k, safe.to(dtype), zero))
            w = all_reduce(torch.cat([B.t() @ v, Vp.t() @ v]), mesh)
            w1, w2 = w[:cols], torch.where(jidx < j, w[cols:], zero)
            f = tau * (w1 - F @ w2)
            at_j = jidx == j
            F = torch.where(at_j[None, :], f[:, None], F)
            Vp = torch.where(at_j[None, :], v[:, None], Vp)
            tp = torch.where(at_j, tau, tp)
            betas = torch.where(at_j, beta, betas)
            # R's row k: the stale row minus the panel's updates so far
            rowV = torch.where(at_j, safe.to(dtype), rowV)
            rowk = rowB - F @ torch.where(jidx <= j, rowV, zero)
            nrm2 = torch.where(cidx > k,
                               torch.clamp(nrm2 - rowk * rowk, min=0.0), nrm2)
            return j + 1, B, Vp, tp, betas, perm, nrm2, F

        j0 = torch.zeros((), dtype=torch.int64, device=dev)
        Vp0 = torch.zeros((rows, nb), dtype=dtype, device=dev)
        nbz = torch.zeros(nb, dtype=dtype, device=dev)
        F0 = torch.zeros((cols, nb), dtype=dtype, device=dev)
        _, B, Vp, tp, betas, perm, nrm2, F = while_loop(
            lambda st, s=s: (st[0] < nb) & (st[0] + s < ns), step,
            (j0, B, Vp0, nbz, nbz.clone(), perm, nrm2, F0))

        # one matrix product updates the panel and the trailing columns;
        # the panel's factored columns get beta on the diagonal and zeros
        # below it (V is kept apart); columns past the step count stay
        B = B - Vp @ F.t()
        active = (cidx >= s) & (cidx < s + nb) & (cidx < ns)
        below = g[:, None] > cidx[None, :]
        B = torch.where(active[None, :] & below, zero, B)
        beta_of_col = betas.index_select(0, torch.clamp(cidx - s, 0, nb - 1))
        on_diag = (g[:, None] == cidx[None, :]) & active[None, :]
        B = torch.where(on_diag, beta_of_col[None, :], B)
        V[:, s:s + nb] = Vp
        taus[s:s + nb] = tp
    return B, V, taus, perm


def cpqr_rows(M: torch.Tensor, nsteps, mesh: Mesh, nb: int = NB
              ) -> RowCPQRF:
    """Column-pivoted QR of the (m, n) buffer whose rows
    [rank * rows, (rank + 1) * rows) are this rank's ``M`` (rows, n).
    ``nsteps`` (an int or a 0-d tensor, the same on every rank) bounds
    the steps to the live columns, as in ``cpqr_blocked``; zero columns
    pivot last.  kmax = min(m, n) >= 192 takes the downdated-norm panel
    loop, as the reference's sharded ``cpqr_blocked`` does."""
    rows, cols = M.shape
    kmax = min(rows * mesh.size, cols)
    nb, kp = panel_width(kmax, nb)
    dev = M.device
    ns = torch.clamp(const(kmax if nsteps is None else nsteps, dev,
                           torch.int64), 0, kmax)
    if kmax >= LARGE_KMAX:
        B, V, taus, perm = _panel_loop(M, ns, mesh, nb, kp)
    else:
        B, V, taus, perm = _exact_loop(M, ns, mesh, kp)
    # this rank's rows of R's leading kmax rows, then one exact merge
    off = mesh.rank * rows
    lead = torch.zeros((kmax, cols), dtype=M.dtype, device=dev)
    if off < kmax:
        lead[off:min(off + rows, kmax)] = B[:min(rows, kmax - off)]
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
    rows = x.shape[0]
    off = f.mesh.rank * rows
    own = max(0, min(rows, kmax - off))     # this rank's leading rows
    buf = torch.zeros(kmax + 1, dtype=x.dtype, device=x.device)
    if own:
        buf[off:off + own] = x[:own]
    buf[kmax] = torch.sum(x[own:] * x[own:])
    buf = all_reduce(buf, f.mesh)
    return torch.cat([buf[:kmax], torch.sqrt(buf[kmax:])])
