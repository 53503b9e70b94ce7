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

:func:`cpqr_hopper_lanes` takes a batch: the same route once a lane,
each lane's step count read from its slot of a (B,) device buffer.

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
        return None if nsteps is None else const(nsteps, M.device,
                                                 torch.int32)
    return nsteps


def _launched(route: str) -> None:
    _graph.count_launch(cpqr_hopper)
    cpqr_hopper.last_route = route


def _resident_blocks(M: torch.Tensor, max_blocks: int | None = None) -> int:
    """Blocks of a resident launch on ``M``'s trailing (rows, cols): at
    most one an SM and ``max_blocks``; raises where the matrix does not
    fit the card's shared memory on them."""
    rows, cols = M.shape[-2:]
    sms, shared, coop = _device_limits(M.device)
    blocks = min(sms, cols, max_blocks or sms)
    need = _resident_shared_bytes(rows, cols, blocks, M.element_size())
    if not coop or need > shared:
        raise ValueError(
            f"cpqr_hopper_resident: a {rows} x {cols} {M.dtype} matrix needs "
            f"{need} bytes of shared memory a block on {blocks} blocks; the "
            f"device gives {shared} (cooperative launch: {coop})")
    return blocks


def _resident_into(M, Bt, tau, perm, nsteps_ptr: int, blocks: int,
                   count) -> None:
    """Resident launches on the current device and stream, one a matrix
    of the lists ``M`` (contiguous (rows, cols)) -> ``Bt``, ``tau``,
    ``perm`` (contiguous outputs), the i-th reading its step count at
    ``nsteps_ptr + 4 i`` (int32 in device memory).  ``count()`` is called
    before each launch."""
    rows, cols = M[0].shape
    dtype, dev = M[0].dtype, M[0].device
    lib = _library()
    _, kp = panel_width(min(rows, cols))
    # Scratch shared by the launches and freed on return is safe: the
    # caching allocator hands a block back only to work queued later on
    # this same stream, and the launches run one after another on it.
    cand = torch.empty((2, blocks, rows), dtype=dtype, device=dev)
    cval = torch.empty((2, blocks), dtype=dtype, device=dev)
    cpos = torch.empty((2, blocks), dtype=torch.int32, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for i, (m, bt, t, p) in enumerate(zip(M, Bt, tau, perm)):
        count()
        err = getattr(lib, _RESIDENT[dtype])(
            m.data_ptr(), bt.data_ptr(), t.data_ptr(), p.data_ptr(),
            cand.data_ptr(), cval.data_ptr(), cpos.data_ptr(),
            counter.data_ptr(), nsteps_ptr + 4 * i, rows, cols, kp, blocks,
            stream)
        _raise_on(lib, err, "cpqr resident kernel launch")


def _stream_into(Bt, tau, perm, nsteps_ptr: int, count) -> None:
    """Stream-route launches on the current device and stream, in place on
    each transposed copy of the list ``Bt`` (contiguous (cols, rows)) with
    ``tau`` zeroed and ``perm`` an int32 identity, the i-th reading its
    step count at ``nsteps_ptr + 4 i``.  ``count()`` is called before each
    factorization's launches."""
    cols, rows = Bt[0].shape
    dtype, dev = Bt[0].dtype, Bt[0].device
    lib = _library()
    # (scratch freed on return is safe, as above)
    nscratch = lib.cpqr_scratch_entries(cols)
    pval = torch.empty(nscratch, dtype=dtype, device=dev)
    pidx = torch.empty(nscratch, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for i, (bt, t, p) in enumerate(zip(Bt, tau, perm)):
        count()
        err = getattr(lib, _STREAM[dtype])(
            bt.data_ptr(), t.data_ptr(), p.data_ptr(), pval.data_ptr(),
            pidx.data_ptr(), nsteps_ptr + 4 * i, rows, cols, stream)
        _raise_on(lib, err, "cpqr stream kernel launch")


def _resident(M: torch.Tensor, nsteps, max_blocks: int | None = None):
    """The resident launch on a CUDA matrix, on at most ``max_blocks``
    blocks (default: one an SM).  The result does not depend on the block
    count."""
    rows, cols = M.shape
    nsteps = const(nsteps, M.device, torch.int32)
    blocks = _resident_blocks(M, max_blocks)
    _, kp = panel_width(min(rows, cols))
    dev = M.device
    with torch.cuda.device(dev):
        Bt = torch.empty((cols, rows), dtype=M.dtype, device=dev)
        tau = torch.empty(kp, dtype=M.dtype, device=dev)
        perm = torch.empty(cols, dtype=torch.int64, device=dev)
        _resident_into([M], [Bt], [tau], [perm], nsteps.data_ptr(), blocks,
                       lambda: _launched("resident"))
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
    _, kp = panel_width(min(rows, cols))
    with torch.cuda.device(M.device):
        # a fresh buffer: the kernel works in place on it
        Bt = M.t().clone(memory_format=torch.contiguous_format)
        tau = torch.zeros(kp, dtype=M.dtype, device=M.device)
        perm = torch.arange(cols, dtype=torch.int32, device=M.device)
        _stream_into([Bt], [tau], [perm], nsteps.data_ptr(),
                     lambda: _launched("stream"))
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


def cpqr_hopper_lanes(M: torch.Tensor, nsteps):
    """:func:`cpqr_hopper` once a lane of a batch ``M`` (B, rows, cols):
    the batched path's factorizations with min(rows, cols) >= 192 on the
    card (``ops/blocked_qr.batched_route``), where the TPU runs its
    Pallas kernel under ``vmap`` (a grid axis a lane).

    ``nsteps``: lane b's step count, a (B,) int tensor on the card (or an
    int or a 0-d tensor for every lane).  Lane b's launch reads
    ``nsteps[b]`` from device memory through a pointer into the (B,)
    int32 buffer and clamps it, so nothing is read back and the launches
    can be captured.  Every lane takes the route :func:`cpqr_hopper`
    takes for one (rows, cols) matrix: one resident launch where
    :func:`fits_resident` holds, else the stream route's launches.

    Returns ``(Bt (B, cols, rows), tau (B, kp), perm (B, cols) int64)``,
    lane b equal to the bits of ``cpqr_hopper(M[b], nsteps[b])``.  On a
    CPU tensor: the plain version, lane by lane.
    ``cpqr_hopper_lanes.launches`` counts one launch a lane (a stream
    factorization's launches count once), ``stream_launches`` those by
    the stream route, ``last_route`` names the route."""
    if M.ndim != 3 or 0 in M.shape:
        raise ValueError(f"cpqr_hopper_lanes takes a (B, rows, cols) batch of "
                         f"non-empty matrices, got shape {tuple(M.shape)}")
    _checked("cpqr_hopper_lanes", M[0], None)
    B, rows, cols = M.shape
    if M.device.type == "cpu":
        ns = const(nsteps, M.device).expand(B)
        outs = [cpqr_packed_plain(M[b], ns[b]) for b in range(B)]
        return tuple(torch.stack(field) for field in zip(*outs))
    if not M.is_contiguous():
        raise ValueError("cpqr_hopper_lanes takes a contiguous batch")
    dev = M.device
    ns = const(nsteps, dev, torch.int32).expand(B).contiguous()
    _, kp = panel_width(min(rows, cols))
    sms, shared, coop = _device_limits(dev)
    with torch.cuda.device(dev):
        if coop and fits_resident(rows, cols, M.dtype, sms, shared):
            Bt = torch.empty((B, cols, rows), dtype=M.dtype, device=dev)
            tau = torch.empty((B, kp), dtype=M.dtype, device=dev)
            perm = torch.empty((B, cols), dtype=torch.int64, device=dev)
            _resident_into(M, Bt, tau, perm, ns.data_ptr(),
                           _resident_blocks(M), lambda: _lane_launched("resident"))
            return Bt, tau, perm
        # fresh buffers: the kernels work in place on them
        Bt = M.transpose(-1, -2).clone(memory_format=torch.contiguous_format)
        tau = torch.zeros((B, kp), dtype=M.dtype, device=dev)
        perm = torch.arange(cols, dtype=torch.int32,
                            device=dev).expand(B, cols).contiguous()
        _stream_into(Bt, tau, perm, ns.data_ptr(),
                     lambda: _lane_launched("stream"))
    return Bt, tau, perm.to(torch.int64)


def _lane_launched(route: str) -> None:
    _graph.count_launch(cpqr_hopper_lanes)
    if route == "stream":
        _graph.count_launch(cpqr_hopper_lanes, "stream_launches")
    cpqr_hopper_lanes.last_route = route


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
cpqr_hopper_lanes.launches = 0
cpqr_hopper_lanes.stream_launches = 0
cpqr_hopper_lanes.last_route = None
_graph.register_counts(cpqr_hopper_lanes, "launches", "stream_launches")
