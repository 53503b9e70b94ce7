"""Fused column-pivoted QR on an NVIDIA Hopper card: the wrapper of
``csrc/cpqr.cu`` and ``csrc/cpqr_panels.cu``.

Replaces the TPU kernel ``enlsip_tpu/ops/pallas_qr2.py::_kernel`` (and
its wrapper ``cpqr_pallas2_packed``), and above the TPU's VMEM gate what
the JAX package runs in its place, ``enlsip_tpu/ops/blocked_qr.py::
_cpqr_xla_panels``.  The work is a sequential chain of Householder steps,
each a card-wide dependency norms -> pivot -> reflector -> update, so the
kernels are bound by what one such round trip costs, not by bytes or
arithmetic; the source notes say what each design does about it.

Two hand-written routes, chosen by the pure rule :func:`b1_route` from
the shape, dtype and the device's properties alone:

* ``"resident"``, :func:`cpqr_hopper_resident`: one persistent
  cooperative launch with the matrix resident in the card's shared
  memory and EXACT norms every step, as the Pallas kernel keeps the
  matrix in VMEM.  Taken where :func:`fits_resident` says it fits;
* ``"panels"``, :func:`cpqr_hopper_panels`: one persistent cooperative
  launch of the JAX package's geqp3 panel loop (DOWNDATED norms, an
  exact recompute at each panel start), for everything else, as the TPU
  takes that loop above its 12 MB VMEM gate.

:func:`cpqr_hopper_lanes` takes a batch: the same route once a lane,
each lane's step count read from its slot of a (B,) device buffer.

Beside the kernels:

* their plain PyTorch versions, :func:`cpqr_packed_plain` (the rank-1
  loop of ``ops/blocked_qr.py``, exact norms) and
  :func:`cpqr_panels_packed_plain` (the panel loop), which the entry
  points take ONLY for a tensor that lies on the CPU.  For a CUDA tensor
  they launch a kernel or raise.  On the CPU the dispatch takes the
  route :func:`b1_route` names for an H100 (:data:`H100_LIMITS`);
* ``cpqr_hopper.launches``, a plain integer counting kernel launches
  (one per factorization sent to the card, by either route; a launch
  captured into a CUDA graph counts on the device at every replay, see
  ``_graph.launches``), ``cpqr_hopper_panels.launches`` those of the
  panel route alone, and ``cpqr_hopper.last_route``, the name of the
  route the last one took.

The number of steps is a 0-d int32 tensor on the card that the kernels
read (``pallas_qr2.py`` takes it in SMEM), and each launch's grid-barrier
counter is zeroed by a memset enqueued before it, so both routes can be
captured into a graph and replayed.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _graph
from .._lanes import const
from .blocked_qr import (cpqr_packed_plain, cpqr_panels_packed_plain,
                         panel_width)

_RESIDENT = {torch.float32: "cpqr_resident_f32",
             torch.float64: "cpqr_resident_f64"}
_PANELS = {torch.float32: "cpqr_panels_f32", torch.float64: "cpqr_panels_f64"}
_limits: dict[int, tuple[int, int, bool]] = {}

# (SM count, opt-in shared bytes a block, cooperative launches) of the
# card the port is written for, an H100 SXM: the route a CPU tensor's
# plain version follows.
H100_LIMITS = (132, 232_448, True)

# The panel kernel's layout (``csrc/cpqr_panels.cu``): warps a block, the
# bytes it stages in shared memory (at least; v at most), a W^T v task's
# bytes, own columns a warp at most.
_PANEL_WARPS = 16
_PANEL_STAGE_BYTES = 8 * 64 * 65
_PANEL_V_BYTES = 48 * 1024
_PANEL_SEG_BYTES = 4096
_PANEL_MAX_COLS_PER_WARP = 8


def _library():
    from ._build import load_library
    lib = load_library("cpqr")
    if not getattr(lib, "_enlsip_bound", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
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
        lib._enlsip_bound = True
    return lib


def _panels_library():
    from ._build import load_library
    lib = load_library("cpqr_panels")
    if not getattr(lib, "_enlsip_bound", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        for fn in _PANELS.values():
            getattr(lib, fn).argtypes = [ptr] * 7 + [i] * 5 + [ptr]
            getattr(lib, fn).restype = i
        for fn in (lib.cpqr_panels_shared_bytes, lib.cpqr_panels_scratch_bytes):
            fn.argtypes = [i] * 5
            fn.restype = ctypes.c_longlong
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
    if dtype not in _RESIDENT or rows < 1 or cols < 1 or sm_count < 1:
        return False
    itemsize = torch.empty(0, dtype=dtype).element_size()
    blocks = min(sm_count, cols)
    return (rows * cols < 2 ** 31 and
            _resident_shared_bytes(rows, cols, blocks, itemsize)
            <= shared_bytes_per_block)


def _panels_shared_bytes(rows: int, cols: int, blocks: int, nb: int,
                         itemsize: int) -> int:
    """Dynamic shared memory of one block of the panel kernel: the stage
    (at least its tiles, and v in whole 4 KB segments up to 48 KB), the F
    rows, norms, W^T v and row k of its ``ceil(cols / blocks)`` columns,
    four panel-width vectors, an int32 position a column of its own, a bit
    a column of the matrix and a 16-bit list of them (as
    ``csrc/cpqr_panels.cu`` sizes it)."""
    nloc = -(-cols // blocks)
    seg = _PANEL_SEG_BYTES // itemsize
    v_rows = min(-(-((rows + 3) & ~3) // seg) * seg, _PANEL_V_BYTES // itemsize)
    stage = max(_PANEL_STAGE_BYTES, v_rows * itemsize)
    return (stage + (nloc * (nb + 3) + 4 * nb) * itemsize + 4 * nloc
            + 4 * -(-cols // 32) + 2 * cols)


def fits_panels(rows: int, cols: int, dtype, sm_count: int,
                shared_bytes_per_block: int) -> bool:
    """Does the panel kernel's layout take a (rows, cols) matrix of
    ``dtype`` on a card with ``sm_count`` SMs and
    ``shared_bytes_per_block`` opt-in bytes a block?  Its shared memory
    holds the F rows of a block's columns and a warp holds the sums of at
    most 8 of them, so it bounds the columns (on an H100: 16,896 in
    either dtype, 128 a block), not the rows."""
    if dtype not in _PANELS or rows < 1 or cols < 1 or sm_count < 1:
        return False
    itemsize = torch.empty(0, dtype=dtype).element_size()
    return _panels_take(rows, cols, itemsize, min(sm_count, cols),
                        shared_bytes_per_block)


def _panels_take(rows: int, cols: int, itemsize: int, blocks: int,
                 shared_bytes_per_block: int) -> bool:
    """The panel kernel's layout on ``blocks`` blocks: int32 indices,
    16-bit column numbers, at most 128 columns a block, its shared memory
    within the limit."""
    nb, _ = panel_width(min(rows, cols))
    return (rows * cols < 2 ** 31 and cols <= 2 ** 16 and
            -(-cols // blocks) <= _PANEL_WARPS * _PANEL_MAX_COLS_PER_WARP and
            _panels_shared_bytes(rows, cols, blocks, nb, itemsize)
            <= shared_bytes_per_block)


def b1_route(rows: int, cols: int, dtype, sm_count: int, shared_bytes: int,
             coop: bool) -> str:
    """B1's route for a (rows, cols) matrix of ``dtype`` on a card with
    ``sm_count`` SMs, ``shared_bytes`` opt-in bytes a block and
    cooperative launches or not, a pure function: ``"resident"`` where
    :func:`fits_resident` holds and the card takes cooperative launches
    (the matrix in shared memory, exact norms, as the Pallas kernel keeps
    it in VMEM); ``"panels"`` otherwise (the JAX package's geqp3 panel
    loop with downdated norms, which it runs where the Pallas kernel does
    not fit)."""
    if coop and fits_resident(rows, cols, dtype, sm_count, shared_bytes):
        return "resident"
    return "panels"


def _route_of(M: torch.Tensor) -> str:
    """:func:`b1_route` of ``M``'s trailing (rows, cols): by its card's
    properties, or by :data:`H100_LIMITS` for a CPU tensor."""
    limits = (_device_limits(M.device) if M.device.type == "cuda"
              else H100_LIMITS)
    return b1_route(M.shape[-2], M.shape[-1], M.dtype, *limits)


_PLAIN = {"resident": cpqr_packed_plain, "panels": cpqr_panels_packed_plain}


def _checked(name: str, M: torch.Tensor, nsteps):
    if M.ndim != 2 or M.shape[0] == 0 or M.shape[1] == 0:
        raise ValueError(f"{name} takes a non-empty matrix, got shape "
                         f"{tuple(M.shape)}")
    if M.dtype not in _RESIDENT:
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
    if route == "panels":
        _graph.count_launch(cpqr_hopper_panels)
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


def _panel_blocks(M: torch.Tensor, max_blocks: int | None = None) -> int:
    """Blocks of a panel launch on ``M``'s trailing (rows, cols): at most
    one an SM and ``max_blocks``; raises where the kernel's layout does
    not take the matrix on them."""
    rows, cols = M.shape[-2:]
    sms, shared, coop = _device_limits(M.device)
    blocks = min(sms, cols, max_blocks or sms)
    if not coop or not _panels_take(rows, cols, M.element_size(), blocks,
                                    shared):
        nb, _ = panel_width(min(rows, cols))
        raise ValueError(
            f"cpqr_hopper_panels: a {rows} x {cols} {M.dtype} matrix needs "
            f"{_panels_shared_bytes(rows, cols, blocks, nb, M.element_size())}"
            f" bytes of shared memory a block and {-(-cols // blocks)} "
            f"columns a block on {blocks} blocks; the device gives {shared} "
            f"bytes, at most {_PANEL_WARPS * _PANEL_MAX_COLS_PER_WARP} "
            f"columns (cooperative launch: {coop})")
    return blocks


def _panels_into(M, Bt, tau, perm, nsteps_ptr: int, blocks: int,
                 count) -> None:
    """Panel launches on the current device and stream, one a matrix of
    the lists ``M`` (contiguous (rows, cols)) -> ``Bt``, ``tau``,
    ``perm`` (contiguous outputs), the i-th reading its step count at
    ``nsteps_ptr + 4 i``.  ``count()`` is called before each launch."""
    rows, cols = M[0].shape
    dtype, dev = M[0].dtype, M[0].device
    lib = _panels_library()
    nb, kp = panel_width(min(rows, cols))
    itemsize = M[0].element_size()
    # One scratch set (the working copy W among it) for the launches, in
    # stream order; freed on return, which is safe as for the resident
    # route's scratch.
    scratch = torch.empty(lib.cpqr_panels_scratch_bytes(rows, cols, blocks,
                                                        nb, itemsize),
                          dtype=torch.uint8, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for i, (m, bt, t, p) in enumerate(zip(M, Bt, tau, perm)):
        count()
        err = getattr(lib, _PANELS[dtype])(
            m.data_ptr(), bt.data_ptr(), t.data_ptr(), p.data_ptr(),
            scratch.data_ptr(), counter.data_ptr(), nsteps_ptr + 4 * i, rows,
            cols, kp, nb, blocks, stream)
        # (the error's text from the resident route's library: both are
        # the CUDA runtime's)
        _raise_on(_library(), err, "cpqr panel kernel launch")


def _launch(route: str, M: torch.Tensor, nsteps,
            max_blocks: int | None = None):
    """One launch of ``route`` on a CUDA matrix, on at most ``max_blocks``
    blocks (default: one an SM).  The result does not depend on the
    block count."""
    rows, cols = M.shape
    nsteps = const(nsteps, M.device, torch.int32)
    blocks = (_resident_blocks if route == "resident"
              else _panel_blocks)(M, max_blocks)
    into = _resident_into if route == "resident" else _panels_into
    _, kp = panel_width(min(rows, cols))
    dev = M.device
    with torch.cuda.device(dev):
        Bt = torch.empty((cols, rows), dtype=M.dtype, device=dev)
        tau = torch.empty(kp, dtype=M.dtype, device=dev)
        perm = torch.empty(cols, dtype=torch.int64, device=dev)
        into([M], [Bt], [tau], [perm], nsteps.data_ptr(), blocks,
             lambda: _launched(route))
    return Bt, tau, perm


def cpqr_hopper_resident(M: torch.Tensor, nsteps):
    """:func:`cpqr_hopper` by the resident route (exact norms); raises for
    a CUDA matrix that does not fit the card's shared memory."""
    nsteps = _checked("cpqr_hopper_resident", M, nsteps)
    if M.device.type == "cpu":
        return cpqr_packed_plain(M, nsteps)
    return _launch("resident", M, nsteps)


def cpqr_hopper_panels(M: torch.Tensor, nsteps):
    """:func:`cpqr_hopper` by the panel route (the JAX package's
    ``_cpqr_xla_panels``: NB-column panels, downdated norms); any shape
    whose columns the kernel's layout takes (:func:`fits_panels`), raises
    for others."""
    nsteps = _checked("cpqr_hopper_panels", M, nsteps)
    if M.device.type == "cpu":
        return cpqr_panels_packed_plain(M, nsteps)
    return _launch("panels", M, nsteps)


def cpqr_hopper(M: torch.Tensor, nsteps):
    """Packed CPQR of ``M`` (rows, cols) with ``nsteps`` Householder
    steps (an int or a 0-d tensor, clamped to [0, min(rows, cols)]; on
    the card the kernels read it from device memory, as the TPU kernel
    reads its count from SMEM, so a count computed on the device is
    never read back).

    Returns ``(Bt, tau, perm)``: ``Bt`` (cols, rows) packed as
    :func:`cpqr_packed_plain` describes, ``tau`` (kp,), ``perm`` (cols,)
    int64.  ``M`` itself is not modified.  The route is
    :func:`b1_route`'s: "resident" (exact norms) where the matrix fits the
    card's shared memory, "panels" (downdated norms) otherwise; a CPU
    tensor takes the plain version of the route an H100 would take."""
    nsteps = _checked("cpqr_hopper", M, nsteps)
    route = _route_of(M)
    if M.device.type == "cpu":
        return _PLAIN[route](M, nsteps)
    return _launch(route, M, nsteps)


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
    takes for one (rows, cols) matrix (:func:`b1_route`), one launch a
    lane; the lanes share one scratch set in stream order.

    Returns ``(Bt (B, cols, rows), tau (B, kp), perm (B, cols) int64)``,
    lane b equal to the bits of ``cpqr_hopper(M[b], nsteps[b])``.  On a
    CPU tensor: that route's plain version, lane by lane.
    ``cpqr_hopper_lanes.launches`` counts one launch a lane,
    ``panel_launches`` those by the panel route, ``last_route`` names
    the route."""
    if M.ndim != 3 or 0 in M.shape:
        raise ValueError(f"cpqr_hopper_lanes takes a (B, rows, cols) batch of "
                         f"non-empty matrices, got shape {tuple(M.shape)}")
    _checked("cpqr_hopper_lanes", M[0], None)
    B, rows, cols = M.shape
    route = _route_of(M)
    if M.device.type == "cpu":
        ns = const(nsteps, M.device).expand(B)
        outs = [_PLAIN[route](M[b], ns[b]) for b in range(B)]
        return tuple(torch.stack(field) for field in zip(*outs))
    if not M.is_contiguous():
        raise ValueError("cpqr_hopper_lanes takes a contiguous batch")
    dev = M.device
    ns = const(nsteps, dev, torch.int32).expand(B).contiguous()
    _, kp = panel_width(min(rows, cols))
    blocks = (_resident_blocks if route == "resident" else _panel_blocks)(M)
    into = _resident_into if route == "resident" else _panels_into
    with torch.cuda.device(dev):
        Bt = torch.empty((B, cols, rows), dtype=M.dtype, device=dev)
        tau = torch.empty((B, kp), dtype=M.dtype, device=dev)
        perm = torch.empty((B, cols), dtype=torch.int64, device=dev)
        into(M, Bt, tau, perm, ns.data_ptr(), blocks,
             lambda: _lane_launched(route))
    return Bt, tau, perm


def _lane_launched(route: str) -> None:
    _graph.count_launch(cpqr_hopper_lanes)
    if route == "panels":
        _graph.count_launch(cpqr_hopper_lanes, "panel_launches")
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
cpqr_hopper_panels.launches = 0
_graph.register_counts(cpqr_hopper_panels)
cpqr_hopper_lanes.launches = 0
cpqr_hopper_lanes.panel_launches = 0
cpqr_hopper_lanes.last_route = None
_graph.register_counts(cpqr_hopper_lanes, "launches", "panel_launches")
