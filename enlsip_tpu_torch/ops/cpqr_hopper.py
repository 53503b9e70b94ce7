"""Fused column-pivoted QR on an NVIDIA Hopper card: the wrapper of
``csrc/cpqr.cu``.

Replaces the TPU kernel ``enlsip_tpu/ops/pallas_qr2.py::_kernel`` (and
its wrapper ``cpqr_pallas2_packed``).  The work is a sequential chain of
Householder steps, each a card-wide dependency norms -> pivot ->
reflector -> update, so the kernel is bound by what one such round trip
costs, not by bytes or arithmetic; the source note in ``csrc/cpqr.cu``
says what its design does about it.

Two hand-written routes, chosen by :func:`cpqr_hopper` from the shape
and the device's properties alone:

* :func:`cpqr_hopper_resident`: one persistent cooperative launch with
  the matrix resident in the card's shared memory, one grid-wide barrier
  a step.  Taken when :func:`fits_resident` says the matrix fits;
* :func:`cpqr_hopper_stream`: two small launches a step on a transposed
  copy in global memory, for everything else.

Beside the kernel:

* its plain PyTorch version, :func:`cpqr_packed_plain` (the rank-1
  loop of ``ops/blocked_qr.py``), which the three entry points take ONLY
  for a tensor that lies on the CPU.  For a CUDA tensor they launch the
  kernel or raise;
* ``cpqr_hopper.launches``, a plain integer counting kernel launches
  (one per factorization sent to the card, by either route; a launch
  captured into a CUDA graph counts on the device at every replay, see
  ``_graph.launches``), and ``cpqr_hopper.last_route``, the name of the
  route the last one took.

The number of steps is a 0-d int32 tensor on the card that the kernels
read (``pallas_qr2.py`` takes it in SMEM), and the resident route's
grid-barrier counter is zeroed by a memset enqueued before the launch,
so both routes can be captured into a graph and replayed.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _graph
from .._lanes import const
from .blocked_qr import cpqr_packed_plain, panel_width

_STREAM = {torch.float32: "cpqr_f32", torch.float64: "cpqr_f64"}
_RESIDENT = {torch.float32: "cpqr_resident_f32",
             torch.float64: "cpqr_resident_f64"}
_limits: dict[int, tuple[int, int, bool]] = {}


def _library():
    from ._build import load_library
    lib = load_library("cpqr")
    if not getattr(lib, "_enlsip_bound", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        for fn in _STREAM.values():
            getattr(lib, fn).argtypes = [ptr] * 6 + [i, i, ptr]
            getattr(lib, fn).restype = i
        for fn in _RESIDENT.values():
            getattr(lib, fn).argtypes = [ptr] * 9 + [i] * 4 + [ptr]
            getattr(lib, fn).restype = i
        lib.cpqr_resident_shared_bytes.argtypes = [i, i, i, i]
        lib.cpqr_resident_shared_bytes.restype = ctypes.c_longlong
        lib.cpqr_device_limits.argtypes = [ctypes.POINTER(i)] * 3
        lib.cpqr_device_limits.restype = i
        lib.cpqr_barrier_probe.argtypes = [i, i, i, ptr, ptr]
        lib.cpqr_barrier_probe.restype = i
        lib.cpqr_error_string.argtypes = [i]
        lib.cpqr_error_string.restype = ctypes.c_char_p
        lib.cpqr_scratch_entries.argtypes = [i]
        lib.cpqr_scratch_entries.restype = i
        lib._enlsip_bound = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.cpqr_error_string(err).decode()} ({err})")


def _device_limits(device) -> tuple[int, int, bool]:
    """(SM count, opt-in shared bytes a block, takes cooperative launches)
    of a CUDA device, asked of the runtime once a device."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _limits:
        lib = _library()
        sms, shared, coop = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            err = lib.cpqr_device_limits(ctypes.byref(sms), ctypes.byref(shared),
                                         ctypes.byref(coop))
        _raise_on(lib, err, "cpqr device query")
        _limits[index] = (sms.value, shared.value, bool(coop.value))
    return _limits[index]


def _resident_shared_bytes(rows: int, cols: int, blocks: int,
                          itemsize: int) -> int:
    """Dynamic shared memory of one block of the resident kernel: its
    ``ceil(cols / blocks)`` columns, the reflector, its columns' norms and
    the two int32 position <-> column maps (as ``csrc/cpqr.cu`` sizes
    it)."""
    nloc = -(-cols // blocks)
    return (nloc * rows + rows + nloc) * itemsize + 2 * cols * 4


def fits_resident(rows: int, cols: int, dtype, sm_count: int,
                  shared_bytes_per_block: int) -> bool:
    """Route gate, a pure function: does a (rows, cols) matrix of
    ``dtype`` fit the shared memory of a card with ``sm_count`` SMs and
    ``shared_bytes_per_block`` opt-in bytes a block, one block an SM,
    columns dealt round-robin?"""
    if dtype not in _STREAM or rows < 1 or cols < 1 or sm_count < 1:
        return False
    itemsize = torch.empty(0, dtype=dtype).element_size()
    blocks = min(sm_count, cols)
    return (rows * cols < 2 ** 31 and
            _resident_shared_bytes(rows, cols, blocks, itemsize)
            <= shared_bytes_per_block)


def _checked(name: str, M: torch.Tensor, nsteps):
    if M.ndim != 2 or M.shape[0] == 0 or M.shape[1] == 0:
        raise ValueError(f"{name} takes a non-empty matrix, got shape "
                         f"{tuple(M.shape)}")
    if M.dtype not in _STREAM:
        raise TypeError(f"{name} takes float32 or float64, got {M.dtype}")
    if M.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes a CPU or CUDA tensor, got {M.device}")
    rows, cols = M.shape
    if M.device.type == "cuda":
        if not M.is_contiguous():
            raise ValueError(f"{name} takes a contiguous matrix")
        if rows * cols >= 2 ** 31:
            raise ValueError(f"{name} indexes rows and columns with int32")
        # the kernels read the count from device memory and clamp it
        return const(nsteps, M.device, torch.int32)
    return nsteps


def _launched(route: str) -> None:
    _graph.count_launch(cpqr_hopper)
    cpqr_hopper.last_route = route


def _resident(M: torch.Tensor, nsteps, max_blocks: int | None = None):
    """The resident launch on a CUDA matrix, on at most ``max_blocks``
    blocks (default: one an SM).  The result does not depend on the block
    count."""
    rows, cols = M.shape
    nsteps = const(nsteps, M.device, torch.int32)
    sms, shared, coop = _device_limits(M.device)
    blocks = min(sms, cols, max_blocks or sms)
    need = _resident_shared_bytes(rows, cols, blocks, M.element_size())
    if not coop or need > shared:
        raise ValueError(
            f"cpqr_hopper_resident: a {rows} x {cols} {M.dtype} matrix needs "
            f"{need} bytes of shared memory a block on {blocks} blocks; the "
            f"device gives {shared} (cooperative launch: {coop})")
    lib = _library()
    _, kp = panel_width(min(rows, cols))
    dev = M.device
    with torch.cuda.device(dev):
        Bt = torch.empty((cols, rows), dtype=M.dtype, device=dev)
        tau = torch.empty(kp, dtype=M.dtype, device=dev)
        perm = torch.empty(cols, dtype=torch.int64, device=dev)
        # Scratch freed on return is safe: the caching allocator hands a
        # block back only to work queued later on this same stream.
        cand = torch.empty((2, blocks, rows), dtype=M.dtype, device=dev)
        cval = torch.empty((2, blocks), dtype=M.dtype, device=dev)
        cpos = torch.empty((2, blocks), dtype=torch.int32, device=dev)
        counter = torch.empty(1, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        _launched("resident")
        err = getattr(lib, _RESIDENT[M.dtype])(
            M.data_ptr(), Bt.data_ptr(), tau.data_ptr(), perm.data_ptr(),
            cand.data_ptr(), cval.data_ptr(), cpos.data_ptr(),
            counter.data_ptr(), nsteps.data_ptr(), rows, cols, kp, blocks,
            stream)
    _raise_on(lib, err, "cpqr resident kernel launch")
    return Bt, tau, perm


def cpqr_hopper_resident(M: torch.Tensor, nsteps):
    """:func:`cpqr_hopper` by the resident route; raises for a CUDA matrix
    that does not fit the card's shared memory."""
    nsteps = _checked("cpqr_hopper_resident", M, nsteps)
    if M.device.type == "cpu":
        return cpqr_packed_plain(M, nsteps)
    return _resident(M, nsteps)


def cpqr_hopper_stream(M: torch.Tensor, nsteps):
    """:func:`cpqr_hopper` by the stream route (any shape)."""
    nsteps = _checked("cpqr_hopper_stream", M, nsteps)
    if M.device.type == "cpu":
        return cpqr_packed_plain(M, nsteps)
    rows, cols = M.shape
    lib = _library()
    _, kp = panel_width(min(rows, cols))
    with torch.cuda.device(M.device):
        # a fresh buffer: the kernel works in place on it
        Bt = M.t().clone(memory_format=torch.contiguous_format)
        tau = torch.zeros(kp, dtype=M.dtype, device=M.device)
        perm = torch.arange(cols, dtype=torch.int32, device=M.device)
        # (scratch freed on return is safe, as above)
        nscratch = lib.cpqr_scratch_entries(cols)
        pval = torch.empty(nscratch, dtype=M.dtype, device=M.device)
        pidx = torch.empty(nscratch, dtype=torch.int32, device=M.device)
        stream = torch.cuda.current_stream().cuda_stream
        _launched("stream")
        err = getattr(lib, _STREAM[M.dtype])(
            Bt.data_ptr(), tau.data_ptr(), perm.data_ptr(), pval.data_ptr(),
            pidx.data_ptr(), nsteps.data_ptr(), rows, cols, stream)
    _raise_on(lib, err, "cpqr stream kernel launch")
    return Bt, tau, perm.to(torch.int64)


def cpqr_hopper(M: torch.Tensor, nsteps):
    """Packed CPQR of ``M`` (rows, cols) with ``nsteps`` Householder
    steps (an int or a 0-d tensor, clamped to [0, min(rows, cols)]; on
    the card the kernels read it from device memory, as the TPU kernel
    reads its count from SMEM, so a count computed on the device is
    never read back).

    Returns ``(Bt, tau, perm)``: ``Bt`` (cols, rows) packed as
    :func:`cpqr_packed_plain` describes, ``tau`` (kp,), ``perm`` (cols,)
    int64.  ``M`` itself is not modified.  A CUDA matrix takes the
    resident route where :func:`fits_resident` holds on its device (and
    the device takes cooperative launches), the stream route otherwise."""
    nsteps = _checked("cpqr_hopper", M, nsteps)
    if M.device.type == "cpu":
        return cpqr_packed_plain(M, nsteps)
    sms, shared, coop = _device_limits(M.device)
    if coop and fits_resident(M.shape[0], M.shape[1], M.dtype, sms, shared):
        return _resident(M, nsteps)
    return cpqr_hopper_stream(M, nsteps)


def _barrier_probe_us(kind: int, blocks: int, iters: int = 4000) -> float:
    """Microseconds one grid-wide barrier of ``blocks`` blocks takes on the
    current device: kind 0 the resident kernel's own, kind 1
    cooperative-groups ``grid.sync()``.  The difference of two launches
    with ``iters`` and ``iters / 4`` barriers, so the launch cancels."""
    lib = _library()
    counter = torch.empty(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(n):
        best = float("inf")
        for _ in range(4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            err = lib.cpqr_barrier_probe(kind, blocks, n, counter.data_ptr(),
                                         stream)
            b.record()
            _raise_on(lib, err, "cpqr barrier probe")
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b))
        return best

    return (run(iters) - run(iters // 4)) * 1e3 / (iters - iters // 4)


cpqr_hopper.launches = 0
cpqr_hopper.last_route = None
_graph.register_counts(cpqr_hopper)
