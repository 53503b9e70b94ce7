"""Batched column-pivoted QR of tiny matrices on an NVIDIA Hopper card:
the wrapper of ``csrc/cpqr_batched.cu``.

Replaces the TPU kernel ``enlsip_tpu/ops/pallas_batched_qr.py::_kernel``
(and its wrappers ``cpqr_batched_packed`` / ``cpqr_blocked_batched``).
The batched solver factors two tiny masked buffers per lane and lockstep
trip (A_act^T and J2); as step-by-step tensor code that is some thirty
launches a Householder step over a (B, rows, cols) buffer.  The kernel
runs a lane's whole factorization on a group of G threads with the
matrix in shared memory, so a factorization of the batch is ONE launch:
it reads the caller's tensor through its strides and writes fresh
outputs, with no layout copy on either side.  The source note in
``csrc/cpqr_batched.cu`` says what bounds it and what the design does
about it.

Beside the kernel:

* its plain PyTorch version, :func:`cpqr_batched_packed_plain` (the same
  arithmetic step by step on a leading batch axis), which
  :func:`cpqr_batched_packed` takes ONLY for a tensor that lies on the
  CPU.  For a CUDA tensor it launches the kernel or raises;
* the launch shape: :func:`group_size` (threads a lane) and
  :func:`block_lanes` (lanes a block), pure functions of the shape and
  type that :func:`launch_shape` caches, and :func:`_shared_bytes`, the
  block's shared memory, which the source computes again from the same
  arguments;
* :func:`launch`, the kernel alone into preallocated outputs;
* ``cpqr_batched_packed.launches``, a plain integer counting kernel
  launches (one per batch factorization sent to the card), and
  ``cpqr_batched_packed_plain.cuda_calls``, the plain version's calls on
  a CUDA tensor.

Differences from the TPU kernel, all deliberate: no 512-lane blocks and
no batch padding (lanes past B hold zero and are not written back),
perm comes out as int64 directly, tau and perm are separate outputs, and
the kernel is instantiated for float64 too, so a float64 batch on the
card (the float64 re-solve of escalated lanes) also gets it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._device import resolve_device, to_host
from .blocked_qr import CPQRF, _panel_T

# Static gates of the kernel path (the TPU kernel's numbers, kept):
# beyond them a lane no longer sits in a group's share of shared memory
# and the batched rank-1 loop of tensor operations is the right tool.
MAX_KMAX = 32
MAX_ELEMS = 32 * 64

# Dynamic shared memory a block may ask for on Hopper (227 KB).
SHARED_LIMIT = 232_448
# Warps a block when they fit; lanes a block = WARPS * 32 / G.
WARPS = 2
# Elements of its lane a thread works on, at most (see group_size).
WORK = 64

_CTYPES = {torch.float32: "cpqr_batched_f32", torch.float64: "cpqr_batched_f64"}


def in_gate(rows: int, cols: int) -> bool:
    """Whether a batch of (rows, cols) matrices goes to the kernel."""
    return (0 < min(rows, cols) <= MAX_KMAX) and rows * cols <= MAX_ELEMS


def _lane_stride(rows: int, cols: int, G: int) -> int:
    """Elements between two lanes' matrices in shared memory: row-major
    with the row stride ``cols | 1``, raised to = G * (cols | 1) mod 32 so
    that the rows a warp touches at once lie on distinct banks."""
    ld = cols | 1
    s = rows * ld
    return s + (G * ld - s) % 32


def _shared_bytes(rows: int, cols: int, itemsize: int, G: int, L: int) -> int:
    """Dynamic shared memory of one block of L lanes: the matrices, tau,
    and perm as int32 (``cpqr_batched_shared_bytes`` in the source)."""
    kmax = min(rows, cols)
    return L * ((_lane_stride(rows, cols, G) + kmax) * itemsize + 4 * cols)


def group_size(rows: int, cols: int, dtype) -> int:
    """Threads a lane: the smallest power of two G that leaves each thread
    at most WORK elements of the lane (its ceil(rows / G) rows times the
    columns), with no more threads than rows and 32 at most.  Fewer
    threads a lane hide less latency; more repeat the work every thread
    of a group does once a step (the butterflies, the pivot scan, the
    reflector).  Read off the group-size sweep on the card: at the main
    paths' shapes the fastest G is the same in both types, so the rule
    does not look at ``dtype``."""
    G = 1
    while G < min(32, rows) and -(-rows // G) * cols > WORK:
        G *= 2
    return G


@functools.lru_cache(maxsize=None)
def launch_shape(rows: int, cols: int, dtype) -> tuple[int, int]:
    """(G, L) of a launch on a batch of (rows, cols) matrices."""
    G = group_size(rows, cols, dtype)
    return G, block_lanes(rows, cols, dtype, G)


def block_lanes(rows: int, cols: int, dtype, G: int) -> int:
    """Lanes a block: WARPS warps of groups, or as many lanes as fit a
    block's shared memory where fewer do (the last warp then runs part
    full)."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    per_lane = _shared_bytes(rows, cols, itemsize, G, 1)
    return min(WARPS * 32 // G, SHARED_LIMIT // per_lane)


@functools.lru_cache(maxsize=None)
def _library():
    """The built library, its C functions typed (built at first use)."""
    from ._build import load_library
    lib = load_library("cpqr_batched")
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in _CTYPES.values():
        getattr(lib, fn).argtypes = [ptr, ll, ll, ll, ptr, ptr, ptr,
                                     i, i, i, i, i, ptr]
        getattr(lib, fn).restype = i
    lib.cpqr_batched_shared_bytes.argtypes = [i, i, i, i, i]
    lib.cpqr_batched_shared_bytes.restype = ll
    lib.cpqr_batched_error_string.argtypes = [i]
    lib.cpqr_batched_error_string.restype = ctypes.c_char_p
    return lib


def cpqr_batched_packed_plain(M: torch.Tensor, nsteps=None):
    """The kernel's plain version: the pivot / reflect / update chain of
    every lane, step by step on the leading batch axis.

    ``M`` is (B, rows, cols).  Returns ``(packed (B, rows, cols), tau
    (B, kmax), perm (B, cols) int64)``: R in packed's upper triangle, the
    Householder beta on the diagonal, reflector tails below it.  Pivot
    ties resolve to the lowest column index; a zero column gives
    ``tau = 0`` and an exact no-op.  ``M`` is not modified.

    ``nsteps`` (B,) int, optional: lane b takes only its first
    ``nsteps[b]`` steps (a mask; the loop stops at the largest count,
    read back once).  The kernel takes no such argument — on masked
    buffers the steps past the live columns are no-ops — so this is for
    batches beyond the kernel's gate, where skipping them saves most of a
    long loop.

    ``cpqr_batched_packed_plain.cuda_calls`` counts its calls on a CUDA
    tensor (outside the kernel's gate, or a comparison with the
    kernel)."""
    B, rows, cols = M.shape
    kmax = min(rows, cols)
    dev, dtype = M.device, M.dtype
    if M.is_cuda:
        cpqr_batched_packed_plain.cuda_calls += 1
    A = M.clone(memory_format=torch.contiguous_format)
    perm = torch.arange(cols, device=dev).expand(B, cols).clone()
    taus = torch.zeros((B, kmax), dtype=dtype, device=dev)
    ridx = torch.arange(rows, device=dev)
    cidx = torch.arange(cols, device=dev)
    last = kmax
    if nsteps is not None:
        nsteps = torch.as_tensor(nsteps, device=dev).expand(B)
        last = 0 if B == 0 else max(0, min(kmax, int(to_host(nsteps.max()))))
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    for k in range(last):
        # ---- exact trailing norms, first maximum per lane ---------------
        sub = A[:, k:, :]
        nrm2 = torch.sum(sub * sub, dim=1)                       # (B, cols)
        nrm2 = torch.where(cidx >= k, nrm2, -one)
        mx = torch.max(nrm2, dim=1, keepdim=True).values
        piv = torch.min(torch.where(nrm2 == mx, cidx, cols), dim=1).values
        piv = torch.where(piv >= cols, k, piv)     # no finite candidate
        if nsteps is not None:
            on = k < nsteps                                       # (B,)
            piv = torch.where(on, piv, k)
        # ---- swap columns k <-> piv and their perm entries --------------
        pcol = piv[:, None, None].expand(B, rows, 1)
        colp = torch.gather(A, 2, pcol)                          # (B, rows, 1)
        colk = A[:, :, k:k + 1].clone()
        A.scatter_(2, pcol, colk)
        A[:, :, k] = colp[:, :, 0]
        pp = torch.gather(perm, 1, piv[:, None])
        pk = perm[:, k:k + 1].clone()
        perm.scatter_(1, piv[:, None], pk)
        perm[:, k] = pp[:, 0]
        # ---- Householder reflector on column k --------------------------
        col = A[:, :, k]                                         # (B, rows)
        tail = torch.where(ridx >= k, col, zero)
        alpha = col[:, k]
        signorm = torch.sqrt(torch.sum(tail * tail, dim=1))
        beta = torch.where(alpha >= 0, -signorm, signorm)
        denom = alpha - beta
        safe = denom.abs() > 0
        denom = torch.where(safe, denom, one)
        v = torch.where(ridx > k, tail / denom[:, None], zero)
        v = torch.where(ridx == k, safe[:, None].to(dtype), v)
        tau = torch.where(safe & (beta != 0),
                          (beta - alpha) / torch.where(beta != 0, beta, one),
                          zero)
        if nsteps is not None:
            tau = torch.where(on, tau, zero)
        # ---- H = I - tau v v^T on the columns > k -----------------------
        vtA = torch.sum(v[:, :, None] * A, dim=1)                # (B, cols)
        vtA = torch.where(cidx > k, vtA, zero)
        upd = A - (tau[:, None] * v)[:, :, None] * vtA[:, None, :]
        # tau = 0 is an exact no-op unless a lane holds inf/NaN
        A = torch.where((tau != 0)[:, None, None], upd, A)
        newcol = torch.where(ridx == k,
                             torch.where(safe, beta, alpha)[:, None],
                             torch.where(ridx < k, col, v))
        if nsteps is not None:
            newcol = torch.where(on[:, None], newcol, col)
        A[:, :, k] = newcol
        taus[:, k] = tau
    return A, taus, perm


cpqr_batched_packed_plain.cuda_calls = 0


def cpqr_batched_packed(M: torch.Tensor):
    """Batched CPQR of ``M`` (B, rows, cols): all ``kmax = min(rows,
    cols)`` steps on every lane.

    Returns ``(packed (B, rows, cols), tau (B, kmax), perm (B, cols)
    int64)`` as :func:`cpqr_batched_packed_plain` describes.  ``M`` may be
    any strided view (the kernel reads it in place) and is never
    modified."""
    if M.ndim != 3 or M.shape[1] == 0 or M.shape[2] == 0:
        raise ValueError(f"cpqr_batched_packed takes a (B, rows, cols) batch "
                         f"of non-empty matrices, got shape {tuple(M.shape)}")
    if M.dtype not in _CTYPES:
        raise TypeError(f"cpqr_batched_packed takes float32 or float64, got "
                        f"{M.dtype}")
    B, rows, cols = M.shape
    if not in_gate(rows, cols):
        raise ValueError(
            f"cpqr_batched_packed takes min(rows, cols) <= {MAX_KMAX} and "
            f"rows * cols <= {MAX_ELEMS}, got ({rows}, {cols})")
    if M.device.type == "cpu":
        return cpqr_batched_packed_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"cpqr_batched_packed takes a CPU or CUDA tensor, "
                         f"got {M.device}")
    packed = torch.empty((B, rows, cols), dtype=M.dtype, device=M.device)
    tau = torch.empty((B, min(rows, cols)), dtype=M.dtype, device=M.device)
    perm = torch.empty((B, cols), dtype=torch.int64, device=M.device)
    _launch(M, packed, tau, perm, *launch_shape(rows, cols, M.dtype))
    return packed, tau, perm


def launch(M: torch.Tensor, packed: torch.Tensor, tau: torch.Tensor,
           perm: torch.Tensor) -> None:
    """Launch the kernel on a CUDA batch ``M`` (B, rows, cols), any
    strides, into preallocated contiguous outputs ``packed`` (B, rows,
    cols), ``tau`` (B, kmax) and ``perm`` (B, cols) int64, with the launch
    shape of :func:`launch_shape`."""
    B, rows, cols = M.shape
    outs = ((packed, (B, rows, cols), M.dtype),
            (tau, (B, min(rows, cols)), M.dtype),
            (perm, (B, cols), torch.int64))
    if not (M.is_cuda and M.dtype in _CTYPES and in_gate(rows, cols)
            and all(o.device == M.device and tuple(o.shape) == shape
                    and o.dtype == dt and o.is_contiguous()
                    for o, shape, dt in outs)):
        raise ValueError("the batched CPQR kernel takes a CUDA float32/float64 "
                         "(B, rows, cols) batch inside its gate and contiguous "
                         "outputs of its shapes on the same device")
    _launch(M, packed, tau, perm, *launch_shape(rows, cols, M.dtype))


def _launch(M, packed, tau, perm, G: int, L: int) -> None:
    """The one place the kernel is launched and counted: ``G`` threads a
    lane, ``L`` lanes a block, on outputs the caller has checked (the
    source rejects a G or L it does not take)."""
    B, rows, cols = M.shape
    if B == 0:
        return
    lib = _library()
    if M.device.index != torch.cuda.current_device():
        with torch.cuda.device(M.device):
            return _launch(M, packed, tau, perm, G, L)
    cpqr_batched_packed.launches += 1
    # the raw current stream: building a torch.cuda.Stream costs more
    # host time than the launch itself
    err = getattr(lib, _CTYPES[M.dtype])(
        M.data_ptr(), *M.stride(), packed.data_ptr(), tau.data_ptr(),
        perm.data_ptr(), rows, cols, B, G, L,
        torch._C._cuda_getCurrentRawStream(M.device.index))
    if err != 0:
        raise RuntimeError(f"cpqr_batched kernel launch failed: "
                           f"{lib.cpqr_batched_error_string(err).decode()} "
                           f"({err})")


cpqr_batched_packed.launches = 0


def unpack_batched(packed: torch.Tensor, tau: torch.Tensor,
                   perm: torch.Tensor) -> CPQRF:
    """Packed batch -> batched :class:`CPQRF` with one WY panel
    (nb = kmax): R = triu, V = strict lower part with a unit diagonal
    where ``tau > 0``, T, diag; every field carries the lane axis."""
    B, rows, cols = packed.shape
    kmax = min(rows, cols)
    ridx = torch.arange(rows, device=packed.device)[:, None]
    kcol = torch.arange(kmax, device=packed.device)[None, :]
    Bk = packed[:, :, :kmax]
    V = torch.where(ridx > kcol, Bk, torch.zeros_like(Bk[:1, :1, :1]))
    V = V + ((ridx == kcol) & (tau[:, None, :] > 0)).to(packed.dtype)
    R = torch.triu(packed[:, :kmax, :])
    return CPQRF(R=R, perm=perm, V=V, tau=tau, T=_panel_T(V, tau, kmax),
                 diag=torch.diagonal(R, dim1=-2, dim2=-1).clone())


def cpqr_blocked_batched(M: torch.Tensor, *, device=None) -> CPQRF:
    """Batched :class:`CPQRF` (leading B axis) of tiny matrices through
    the kernel.  Runs on ``device`` (default: the card; raises if there
    is none)."""
    M = torch.as_tensor(M).to(resolve_device(device))
    return unpack_batched(*cpqr_batched_packed(M))
