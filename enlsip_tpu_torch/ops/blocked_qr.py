"""Column-pivoted Householder QR with compact-WY implicit Q.

Counterpart of ``enlsip_tpu/ops/blocked_qr.py``.  The reference leans
on LAPACK ``geqp3`` through Julia's ``qr(A, ColumnNorm())``; this module
provides the same factorization in three forms behind one dispatch
(:func:`cpqr_blocked`):

* the rank-1 update loop with *exact* trailing column norms every step
  (:func:`_cpqr_xla`), for small and medium matrices;
* a geqp3-style panel loop with downdated norms
  (:func:`_cpqr_xla_panels`), for large factorizations on the CPU;
* the fused Hopper kernel (``ops/cpqr_hopper.py``), for large
  factorizations on a CUDA device.

A batch of same-shaped buffers (3-D input) gives a :class:`CPQRF` with a
leading lane axis on every field, by the route :func:`batched_route`
picks from the shape, dtype and device type alone: tiny matrices through
the batched kernel (``ops/cpqr_batched_hopper.py``); large ones, as the
JAX package's ``vmap`` of :func:`cpqr_blocked` takes them, through the
fused Hopper kernel once a lane on a CUDA device
(``ops/cpqr_hopper.cpqr_hopper_lanes``) and through the panel loop once
a lane on the CPU; the rest through the batched rank-1 loop.  The Q
applications below take either form.

``Q`` is never materialized.  Reflectors ``V, tau`` come back with
panel-wise compact-WY ``T`` factors (``Q = prod_p (I - V_p T_p V_p^T)``),
so ``Q^T x``, ``Q x`` and ``J @ Q`` are short chains of matrix products;
``J @ Q`` of a tall J with one panel is one pass of the fused WY kernel
(``ops/wy_hopper.py``).  The two-stage factorizations of a tall buffer
(CholeskyQR, thin QR + pivoted QR of R) are in ``ops/tsqr.py``.

Zero (masked) columns have zero norms, pivot last and produce
``tau = 0`` no-op reflectors — callers mask invalid columns and get the
factorization of the live submatrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import cpu_int, resolve_device
from .._lanes import const, mtv, mv
from ..utils.profiling import span

# WY panel width for T/apply blocking.
NB = 128
# Smallest min(rows, cols) sent to the panel loop (CPU) or the fused
# kernel (CUDA); below it the rank-1 loop runs.
LARGE_KMAX = 192


class CPQRF(NamedTuple):
    """Pivoted QR: ``M[:, perm] = Q @ [R; 0]`` with
    ``Q = (I - V_0 T_0 V_0^T) (I - V_1 T_1 V_1^T) ...`` (implicit).

    R: (kmax, cols) upper-trapezoidal; V: (rows, kp) unit-lower
    reflectors (kp = kmax padded to the panel width); tau: (kp,);
    T: (np, nb, nb) per-panel WY factors; perm: (cols,) int64;
    diag: (kmax,)."""

    R: torch.Tensor
    perm: torch.Tensor
    V: torch.Tensor
    tau: torch.Tensor
    T: torch.Tensor
    diag: torch.Tensor


def panel_width(kmax: int, nb: int = NB) -> tuple[int, int]:
    """(nb, kp): the WY panel width for ``kmax`` reflectors and ``kmax``
    padded up to a multiple of it."""
    nb = min(nb, kmax) if kmax >= nb else kmax
    return nb, -(-kmax // nb) * nb


def _householder_col(col: torch.Tensor, k: int):
    """Reflector annihilating col[k+1:]; entries < k ignored.
    Returns (v, tau, beta); no-op (v=0, tau=0) for a zero tail, where
    the third value keeps ``alpha``."""
    tail = col[k:]
    alpha = col[k]
    signorm = torch.sqrt(torch.sum(tail * tail))
    beta = torch.where(alpha >= 0, -signorm, signorm)
    denom = alpha - beta
    safe = denom.abs() > 0
    one = torch.ones_like(denom)
    denom = torch.where(safe, denom, one)
    v = torch.zeros_like(col)
    v[k + 1:] = tail[1:] / denom
    v[k] = safe.to(col.dtype)
    tau = torch.where(safe & (beta != 0),
                      (beta - alpha) / torch.where(beta != 0, beta, one),
                      torch.zeros_like(beta))
    return v, tau, torch.where(safe, beta, alpha)


def _panel_T(V: torch.Tensor, taus: torch.Tensor, nb: int,
             sum_rows=None) -> torch.Tensor:
    """Per-panel compact-WY T factors: T_p = U_p^{-1},
    U_p = diag(1/tau_p) + strict_upper(V_p^T V_p).  ``V`` (..., rows, kp)
    and ``taus`` (..., kp) may carry leading lane axes.  ``sum_rows``:
    for reflectors whose rows are sharded over ranks, the reduction that
    adds the ranks' partial V_p^T V_p."""
    *lead, rows, kp = V.shape
    n_panels = kp // nb
    Vp = V.reshape(*lead, rows, n_panels, nb).movedim(-2, -3)  # (np, rows, nb)
    tp = taus.reshape(*lead, n_panels, nb)
    VtV = Vp.transpose(-1, -2) @ Vp
    if sum_rows is not None:
        VtV = sum_rows(VtV)
    live = tp > 0
    safe_tau = torch.where(live, tp, torch.ones_like(tp))
    U = torch.triu(VtV, 1) + torch.diag_embed(1.0 / safe_tau)
    eye = torch.eye(nb, dtype=V.dtype, device=V.device).expand_as(U)
    T = torch.linalg.solve_triangular(U, eye, upper=True)
    keep = live[..., :, None] & live[..., None, :]
    return torch.where(keep, T, torch.zeros_like(T))


def _clamp_steps(nsteps, kmax: int) -> int:
    """Host int number of Householder steps, clamped to [0, kmax], from
    an int or a CPU tensor (a CUDA tensor raises: on the card the count
    stays in device memory, see :func:`step_bound`)."""
    if nsteps is None:
        return kmax
    return max(0, min(cpu_int(nsteps), kmax))


def step_bound(nsteps, kmax: int):
    """(host loop bound, device count or None) of a step loop.

    An int or ``None`` gives the exact bound and no mask.  A tensor (a
    device count, as the card's code keeps it) gives the bound ``kmax``
    and the count as a 0-d int64 tensor: a step ``k`` is live while
    ``k < nsteps`` and an exact no-op otherwise, so nothing is read
    back and the result equals the exact loop's."""
    if not isinstance(nsteps, torch.Tensor):
        return _clamp_steps(nsteps, kmax), None
    return kmax, nsteps.to(torch.int64)


# ------------------------------------------------------ rank-1 loop

def cpqr_packed_plain(M: torch.Tensor, nsteps):
    """The rank-1 update loop on the transposed buffer, returning the
    fused kernel's packed triple — this is the kernel's plain version,
    and the rank-1 route of :func:`cpqr_blocked` below 192 pivots.

    Returns ``(Bt, tau, perm)``: ``Bt`` (cols, rows) holds, for every
    factored column k, R above the diagonal, the Householder beta on it
    and the reflector tail below; columns > k carry the updated trailing
    matrix; columns ``>= nsteps`` are never touched below the rows the
    reflectors reached.  ``tau`` is (kp,), zero past ``nsteps``;
    ``perm`` is (cols,) int64.

    ``nsteps``: an int, or a 0-d tensor with which the loop runs all
    kmax steps, each past ``nsteps`` an exact no-op, and reads nothing
    back (:func:`step_bound`)."""
    rows, cols = M.shape
    kmax = min(rows, cols)
    _, kp = panel_width(kmax)
    dev = M.device
    Bt = M.t().clone(memory_format=torch.contiguous_format)
    taus = torch.zeros(kp, dtype=M.dtype, device=dev)
    perm = torch.arange(cols, device=dev)
    ub, ns = step_bound(nsteps, kmax)
    for k in range(ub):
        # exact trailing norms (B-rows >= k) of the unpivoted columns;
        # argmax returns the first maximum
        sub = Bt[k:, k:]
        piv = k + torch.argmax(torch.sum(sub * sub, dim=1))
        live = None if ns is None else k < ns
        if live is not None:
            piv = torch.where(live, piv, k)
        idx = torch.stack([torch.full_like(piv, k), piv])
        # in-place swaps by index assignment (the reference's
        # scatter-free select updates are a TPU workaround)
        Bt[idx] = Bt[idx.flip(0)]
        perm[idx] = perm[idx.flip(0)]
        v, tau, diag = _householder_col(Bt[k], k)
        trail = Bt[k + 1:]
        upd = torch.outer(tau * (trail @ v), v)
        if live is None:
            trail -= upd
            Bt[k, k] = diag
            Bt[k, k + 1:] = v[k + 1:]
        else:
            tau = torch.where(live, tau, torch.zeros_like(tau))
            trail -= torch.where(live, upd, torch.zeros_like(upd))
            Bt[k, k] = torch.where(live, diag, Bt[k, k])
            Bt[k, k + 1:] = torch.where(live, v[k + 1:], Bt[k, k + 1:])
        taus[k] = tau
    return Bt, taus, perm


def unpack_packed(Bt: torch.Tensor, tau: torch.Tensor, perm: torch.Tensor,
                  nb: int = NB) -> CPQRF:
    """Packed triple -> :class:`CPQRF`: R = triu, V = strict lower part
    with a unit diagonal where ``tau > 0``, per-panel T.  ``Bt`` (...,
    cols, rows), ``tau`` (..., kp) and ``perm`` (..., cols) may carry
    leading lane axes (one packed triple a lane)."""
    *lead, cols, rows = Bt.shape
    kmax = min(rows, cols)
    nb, kp = panel_width(kmax, nb)
    B = Bt.transpose(-1, -2)
    R = torch.triu(B[..., :kmax, :])
    V = torch.zeros((*lead, rows, kp), dtype=Bt.dtype, device=Bt.device)
    V[..., :kmax] = torch.tril(B[..., :kmax], -1)
    k = torch.arange(kmax, device=Bt.device)
    V[..., k, k] = (tau[..., :kmax] > 0).to(Bt.dtype)
    if tau.shape[-1] != kp:     # packed tau is padded to the NB grid
        tau = torch.cat([tau[..., :kmax], tau.new_zeros((*lead, kp - kmax))],
                        dim=-1)
    return CPQRF(R=R, perm=perm, V=V, tau=tau, T=_panel_T(V, tau, nb),
                 diag=torch.diagonal(R, dim1=-2, dim2=-1).clone())


def _cpqr_xla(M: torch.Tensor, nb: int, nsteps) -> CPQRF:
    """The rank-1 update loop with exact norms (named after its
    reference counterpart)."""
    return unpack_packed(*cpqr_packed_plain(M, nsteps), nb=nb)


# ------------------------------------------------------- panel loop

def _panels_loop(M: torch.Tensor, nb: int, nsteps):
    """geqp3-style panel CPQR (LAPACK xLAQPS structure): within a panel
    the matrix stays STALE and each reflector's effect is carried by the
    accumulator F, with updated_j = B - V_j F_j^T holding exactly; the
    trailing matrix is updated ONCE per panel by a single matrix
    product.  Pivoting searches all trailing columns using downdated
    norms (nrm2 -= R[k, :]^2), with an exact recompute at every panel
    start, so downdating drift is bounded to one panel.

    Returns ``(B, V, taus, perm, nb, ub)``: the final matrix (R above the
    diagonal, the Householder betas on it and zeros below it in the
    factored columns, the updated trailing matrix in the others), the
    reflectors (rows, kp), tau (kp,), the permutation, the panel width
    and the number of steps taken."""
    rows, cols = M.shape
    kmax = min(rows, cols)
    nb, kp = panel_width(kmax, nb)
    n_panels = kp // nb
    dtype, dev = M.dtype, M.device
    ridx = torch.arange(rows, device=dev)
    cidx = torch.arange(cols, device=dev)
    ub = _clamp_steps(nsteps, kmax)

    B = M.clone()
    V = torch.zeros((rows, kp), dtype=dtype, device=dev)
    taus = torch.zeros((kp,), dtype=dtype, device=dev)
    perm = torch.arange(cols, device=dev)

    for p in range(n_panels):
        s = p * nb
        # Exact trailing norms at panel start (bounds downdate drift).
        nrm2 = torch.sum(B[s:] * B[s:], dim=0)
        Vp = torch.zeros((rows, nb), dtype=dtype, device=dev)
        tp = torch.zeros((nb,), dtype=dtype, device=dev)
        betas = torch.zeros((nb,), dtype=dtype, device=dev)
        F = torch.zeros((cols, nb), dtype=dtype, device=dev)
        # Steps at or past ``ub`` are exact no-ops (self-swap,
        # tau = v = 0) and are skipped on the host.
        for j in range(max(0, min(nb, ub - s))):
            # Clamp to a real column, as the reference does: s + j can
            # reach kp > cols in the final panel, and an out-of-range
            # index raises here.
            k = min(s + j, cols - 1)
            # ---- pivot among trailing columns (downdated norms) ------
            piv = k + torch.argmax(nrm2[k:])
            idx = torch.stack([torch.full_like(piv, k), piv])
            swp = idx.flip(0)
            B[:, idx] = B[:, swp]
            F[idx] = F[swp]
            nrm2[idx] = nrm2[swp]
            perm[idx] = perm[swp]
            # ---- current column with pending panel updates applied ---
            bcol = B[:, k] - Vp[:, :j] @ F[k, :j]
            v, tau, beta = _householder_col(bcol, k)
            # ---- F column j: tau (B^T v - F (Vp^T v)) ----------------
            w1 = B.t() @ v                                    # full pass
            w2 = Vp[:, :j].t() @ v
            F[:, j] = tau * (w1 - F[:, :j] @ w2)
            Vp[:, j] = v
            tp[j] = tau
            betas[j] = beta
            # ---- row k of the updated matrix -> norm downdate --------
            rowk = B[k] - F[:, :j + 1] @ Vp[k, :j + 1]
            down = torch.clamp(nrm2 - rowk * rowk, min=0.0)
            nrm2 = torch.where(cidx > k, down, nrm2)

        # ---- one matrix product updates panel + trailing columns -----
        B -= Vp @ F.t()
        # Panel columns inside the nsteps bound: exact Householder beta
        # on the diagonal, zeros below it (V is stored separately).
        # Columns past ub were never factorized and stay untouched.
        active_col = (cidx >= s) & (cidx < s + nb) & (cidx < ub)
        below = ridx[:, None] > cidx[None, :]
        B = torch.where(active_col[None, :] & below, torch.zeros_like(B), B)
        # (indexing with a clamp: for the last panel s + nb may exceed
        # cols)
        beta_of_col = betas[torch.clamp(cidx - s, 0, nb - 1)]
        diag_mask = (ridx[:, None] == cidx[None, :]) & active_col[None, :]
        B = torch.where(diag_mask, beta_of_col[None, :], B)
        V[:, s:s + nb] = Vp
        taus[s:s + nb] = tp
    return B, V, taus, perm, nb, ub


def _cpqr_xla_panels(M: torch.Tensor, nb: int, nsteps) -> CPQRF:
    """The panel loop (:func:`_panels_loop`) as a :class:`CPQRF`.  Same
    contract as :func:`_cpqr_xla`; individual values differ by reduction
    order, and pivot tie-breaking can differ where downdated and exact
    norms round differently."""
    B, V, taus, perm, nb, _ = _panels_loop(M, nb, nsteps)
    R = torch.triu(B[:min(M.shape), :])
    return CPQRF(R=R, perm=perm, V=V, tau=taus, T=_panel_T(V, taus, nb),
                 diag=torch.diagonal(R).clone())


def cpqr_panels_packed_plain(M: torch.Tensor, nsteps, nb: int = NB):
    """The panel loop (:func:`_panels_loop`, the JAX package's
    ``_cpqr_xla_panels``) returning the fused kernel's packed triple, as
    :func:`cpqr_packed_plain` packs it: ``Bt`` (cols, rows) with R above
    the diagonal, the beta on it and the reflector tails below in every
    factored column, the updated trailing matrix in the others; ``tau``
    (kp,), zero past ``nsteps``; ``perm`` (cols,) int64.  This is the
    plain version of B1's panel route (``ops/cpqr_hopper.py``).

    :func:`unpack_packed` gives back :func:`_cpqr_xla_panels`'s
    :class:`CPQRF` where the columns past ``nsteps`` hold nothing below
    the diagonal (every step taken, or a masked buffer such as J2);
    otherwise V's columns past ``nsteps`` carry that trailing part (as
    for the rank-1 loop), where T makes them no-ops.  ``nsteps``: an
    int, or a CPU tensor (read on the host)."""
    B, V, taus, perm, _, ub = _panels_loop(M, nb, nsteps)
    Bt = B.t().clone(memory_format=torch.contiguous_format)
    below = (torch.arange(M.shape[0], device=M.device)[None, :]
             > torch.arange(ub, device=M.device)[:, None])
    Bt[:ub] = torch.where(below, V[:, :ub].t(), Bt[:ub])
    return Bt, taus, perm


def _cpqr_xla_panels_lanes(M: torch.Tensor, nb: int, nsteps) -> CPQRF:
    """:func:`_cpqr_xla_panels` of every lane of a CPU batch ``M`` (B,
    rows, cols), stacked into one :class:`CPQRF` with NB-column panels:
    what the JAX package's ``vmap`` of ``cpqr_blocked`` runs off the TPU
    (downdated norms, an exact recompute at each panel start).  Lane b
    takes its own ``nsteps[b]`` Householder steps, read on the host as
    the 2-D loop reads its count (a CPU tensor: no read-back of the
    card)."""
    lanes = M.shape[0]
    ns = None if nsteps is None else const(nsteps, M.device).expand(lanes)
    fs = [_cpqr_xla_panels(M[b], nb, None if ns is None else ns[b])
          for b in range(lanes)]
    return CPQRF(*(torch.stack(field) for field in zip(*fs)))


# --------------------------------------------------------- dispatch

def batched_route(rows: int, cols: int, dtype, device_type: str) -> str:
    """The route of a batch of (rows, cols) factorizations, a pure
    function of shape, dtype and device type:

    * ``"b2"``: inside the batched kernel's gate
      (``cpqr_batched_hopper.in_gate``), on either device (the CPU takes
      its plain version);
    * ``"b1_lanes"``: kmax = min(rows, cols) >= 192 on a CUDA device, the
      fused kernel once a lane (``cpqr_hopper.cpqr_hopper_lanes``), where
      the TPU runs its Pallas kernel under ``vmap``;
    * ``"panels"``: kmax >= 192 on the CPU, the panel loop a lane, as the
      JAX package's ``vmap`` of ``cpqr_blocked`` runs off the TPU;
    * ``"rank1"``: everything else, the batched rank-1 loop with exact
      norms, the counterpart of the JAX package's ``_cpqr_xla`` under
      ``vmap`` (no Pallas kernel takes these shapes)."""
    from .cpqr_batched_hopper import in_gate
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"batched CPQR takes float32 or float64, got {dtype}")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"batched CPQR runs on 'cpu' or 'cuda', got "
                         f"{device_type!r}")
    if in_gate(rows, cols):
        return "b2"
    if min(rows, cols) >= LARGE_KMAX:
        return "b1_lanes" if device_type == "cuda" else "panels"
    return "rank1"


def _span(M: torch.Tensor, route: str, nsteps):
    """The ``cpqr`` span of one factorization (``utils/profiling.py``):
    its route, its shape, and a 0-d ``nsteps`` as its payload.  It holds
    the factorization alone, not the unpack into R, V and T."""
    return span("cpqr", M.device, nsteps, route=route, rows=M.shape[-2],
                cols=M.shape[-1], lanes=M.shape[0] if M.ndim == 3 else 0)


def cpqr_blocked(M: torch.Tensor, nb: int = NB, nsteps=None, *,
                 device=None) -> CPQRF:
    """Column-pivoted QR of a fixed-shape buffer (zeroed invalid columns
    pivot last).

    A 3-D ``M`` (B, rows, cols) is a batch of same-shaped buffers and
    gives a :class:`CPQRF` whose every field carries the leading lane
    axis, by the route of :func:`batched_route`: tiny matrices go to the
    batched kernel, which runs all kmax steps (one WY panel, nb = kmax);
    kmax >= 192 to the fused kernel (CUDA) or the panel loop (CPU) once
    a lane, with NB-column panels; the rest to the batched rank-1 loop
    (one panel).  The per-lane ``nsteps`` (B,) is each lane's own step
    count, read nowhere on the host on the card.

    ``nsteps`` (int or 0-d tensor) bounds the number of Householder
    steps to the number of LIVE columns: steps past it would be no-ops
    on zero columns (tau = 0), so skipping them changes nothing — but
    for a masked buffer like the solver's J2 (n - rankA live columns of
    n) it removes almost the whole sequential loop.

    Runs on ``device`` (default: the card; raises if there is none).
    Factorizations with min(rows, cols) >= 192 go to the fused Hopper
    kernel on a CUDA device and to the panel loop on the CPU; smaller
    ones run the rank-1 loop on either.  Each factorization is a
    ``cpqr`` span with its route: ``b2``, ``b1_lanes``, ``resident`` or
    ``panels`` (B1's route, ``cpqr_hopper.b1_route``; the CPU panel
    loop), ``rank1``."""
    M = torch.as_tensor(M).to(resolve_device(device))
    if M.ndim == 3:
        from .cpqr_batched_hopper import (cpqr_batched_packed,
                                          cpqr_batched_packed_plain,
                                          unpack_batched)
        route = batched_route(M.shape[1], M.shape[2], M.dtype, M.device.type)
        if route == "b2":
            with _span(M, route, nsteps):
                packed = cpqr_batched_packed(M)
            return unpack_batched(*packed)
        if route == "b1_lanes":
            from .cpqr_hopper import cpqr_hopper_lanes
            steps = min(M.shape[1:]) if nsteps is None else nsteps
            M = M.contiguous()
            with _span(M, route, nsteps):
                packed = cpqr_hopper_lanes(M, steps)
            return unpack_packed(*packed, nb=nb)
        if route == "panels":
            with _span(M, route, nsteps):
                return _cpqr_xla_panels_lanes(M, nb, nsteps)
        if M.is_cuda:
            cpqr_blocked.cuda_rank1["lanes"] += 1
        with _span(M, route, nsteps):
            packed = cpqr_batched_packed_plain(M, nsteps)
        return unpack_batched(*packed)
    kmax = min(M.shape)
    if kmax >= LARGE_KMAX:
        if M.is_cuda:
            from .cpqr_hopper import _route_of, cpqr_hopper
            steps = kmax if nsteps is None else nsteps
            M = M.contiguous()
            with _span(M, _route_of(M), nsteps):
                packed = cpqr_hopper(M, steps)
            return unpack_packed(*packed, nb=nb)
        with _span(M, "panels", nsteps):
            return _cpqr_xla_panels(M, nb, nsteps)
    if M.is_cuda:
        cpqr_blocked.cuda_rank1["single"] += 1
    with _span(M, "rank1", nsteps):
        return _cpqr_xla(M, nb, nsteps)


# Calls of the rank-1 routes on a CUDA tensor, the only ones in which the
# card runs a plain PyTorch loop: "lanes" a batch (3-D), "single" one
# matrix.  Host counts, made when a call is traced (a captured graph's
# replays add nothing); set them to 0 before the code they hold.
cpqr_blocked.cuda_rank1 = {"lanes": 0, "single": 0}


# ------------------------------------------------------- Q application
# Q = P_0 P_1 ... P_{np-1},  P_i = I - V_i T_i V_i^T.

# ``f`` may carry leading lane axes on every field (a batched CPQRF);
# ``x`` is then a per-lane vector (..., rows) or matrix (..., rows, c).

def _panels(f: CPQRF):
    kp = f.V.shape[-1]
    nb = f.T.shape[-1]
    return [(f.V[..., i * nb:(i + 1) * nb], f.T[..., i, :, :])
            for i in range(kp // nb)]


def _left_apply(f: CPQRF, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    vec = x.ndim == f.V.ndim - 1
    panels = _panels(f)
    for Vi, Ti in (panels if transpose else reversed(panels)):
        Tm = Ti.transpose(-1, -2) if transpose else Ti
        if vec:
            # lane-wise products whose rounding does not follow the
            # number of lanes (see _lanes.mv)
            x = x - mv(Vi, mv(Tm, mtv(Vi, x)))
        else:
            x = x - Vi @ (Tm @ (Vi.transpose(-1, -2) @ x))
    return x


def qt_apply(f: CPQRF, x: torch.Tensor) -> torch.Tensor:
    """Q^T @ x (vector or matrix): apply P_i^T in forward order."""
    return _left_apply(f, x, True)


def q_apply(f: CPQRF, x: torch.Tensor) -> torch.Tensor:
    """Q @ x: apply P_i in reverse order."""
    return _left_apply(f, x, False)


def right_q_apply(f: CPQRF, J: torch.Tensor) -> torch.Tensor:
    """J @ Q: right-multiply by P_i in forward order.

    A tall 2-D ``J`` with a single WY panel inside the gate
    ``use_wy_hopper`` takes the fused form ``ops/wy_hopper.wy_right_apply``
    (``J - (J V) W`` with ``W = T V^T``): on a CUDA tensor that is the
    kernel, which reads J once and keeps ``J V`` on chip, and on a CPU
    tensor the same arithmetic as plain matrix products.  Everything else
    takes the chain of matrix products below."""
    panels = _panels(f)
    if len(panels) == 1 and J.ndim == 2 and f.V.ndim == 2:
        from .wy_hopper import use_wy_hopper, wy_right_apply
        V0, T0 = panels[0]
        if use_wy_hopper(J.shape[0], J.shape[1], V0.shape[1], J.dtype,
                         J.device):
            return wy_right_apply(J, V0, T0)
    for Vi, Ti in panels:
        J = J - ((J @ Vi) @ Ti) @ Vi.transpose(-1, -2)
    return J
