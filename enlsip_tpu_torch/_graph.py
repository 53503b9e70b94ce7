"""The device-resident executor: a solve as one captured CUDA graph.

Counterpart of the JAX package's jitted solve loop
(``enlsip_tpu/core/driver.py::_solve_full_jit`` / ``_run_chunk_jit`` and
``enlsip_tpu/parallel/batch.py::_solve_batched_jit``): init, the
iteration loop and the packed result run as ONE device program that the
host launches once and reads back once.

How it works on a CUDA device.  :func:`run` captures a function into a
CUDA graph the first time it meets a key and replays the graph after
that.  While the function is captured, the control-flow helpers of
``_lanes`` (``cond``, ``switch``, ``while_loop``) do not read their
predicates back: each becomes a conditional node of the graph
(``csrc/graph_cond.cu``), an IF whose body holds one side or a WHILE
whose body holds one trip, so the card evaluates the branch and runs
ONE side, as the host loop does.

Memory.  The whole function is captured in a root body (an IF node that
is always taken) on ONE body stream, and so is every body nested in it,
at any depth (``csrc/graph_cond.cu`` suspends the capture of the
enclosing body while a nested one is captured on the same stream).
Everything the capture allocates goes to one memory pool of the graph's
own (``torch.cuda.MemPool``), so no block of a graph is handed to other
work while the graph lives.  PyTorch's caching allocator hands a freed
block out again only to an allocation on the stream it was freed on: on
one stream, a block that one body frees is reused by the next body, at
any depth, as the eager loop reuses it in the next step, and the graph
holds about the eager loop's working set rather than one working set
per stream.  The reuse is safe because the graph runs its nodes in the
order they were captured: every body is captured on one stream, and a
conditional node is added after every node its enclosing body has so
far, so a block is written again only after every node that used it
before its free.  A WHILE body replays its trips over memory the
capture saw freed once; that is safe as long as no block that a body
reads and that was allocated before the body is freed during the body's
capture, and none is: such a tensor is held by what runs the body (the
closures' cells, the loop state that ``_lanes.while_loop`` keeps until
the node is captured), and a block returns to the pool only when its
tensor's last reference is gone.  A block allocated inside a trip is
written in that trip before it is read.

On the CPU the same functions run eagerly as a rehearsal: the helpers
read their flags directly (what a conditional node does on the card),
and :func:`_device.forbid_readbacks` makes any other read-back raise.

Graphs are cached by key (the static arguments: closures, dims, options,
dtype, shapes, device, and for a sharded solve the mesh: its process
group, size, rank and axis, ``_dist.mesh_key``) in a bounded cache;
:func:`clear_graph_cache` empties it and gives the pools back.  A
sharded solve's collectives are captured where they are enqueued: NCCL's
own stream joins the capturing stream by events, so a collective inside
a conditional body lands in that body.  Nothing falls back: a failed
capture, a refused launch or a missing conditional-node API raises.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
import time

import torch
from torch.utils import _pytree as pytree

from ._device import flag_value, forbid_readbacks, to_host_list

class _State(threading.local):
    mode = None          # None (eager), "capture" or "emulate"
    guards = None        # names of the capture's finite-value checks


_state = _State()


def mode():
    """``"capture"`` while a CUDA graph is being captured, ``"emulate"``
    during a CPU rehearsal, else ``None``."""
    return _state.mode


def capturing() -> bool:
    return _state.mode == "capture"


def device_resident() -> bool:
    """Inside :func:`run` (either form): branches are taken on the
    device, and nothing may read back."""
    return _state.mode is not None


@contextlib.contextmanager
def _mode(m):
    before = _state.mode
    _state.mode = m
    try:
        yield
    finally:
        _state.mode = before


# ----------------------------------------------------------- the library

_lib = None


def _library():
    global _lib
    if _lib is None:
        from .ops._build import load_library
        lib = load_library("graph_cond")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.cg_begin.argtypes = [ptr, ptr, i, ptr,
                                 ctypes.POINTER(ctypes.c_ulonglong),
                                 ctypes.POINTER(ptr), ctypes.POINTER(ptr)]
        lib.cg_begin.restype = i
        lib.cg_set.argtypes = [ptr, ctypes.c_ulonglong, ptr]
        lib.cg_set.restype = i
        lib.cg_end.argtypes = [ptr, ptr, ptr]
        lib.cg_end.restype = i
        lib.cg_stamp.argtypes = [ptr, ptr, ctypes.c_ulonglong, i, ptr]
        lib.cg_stamp.restype = i
        lib.cg_runtime_version.restype = i
        lib.cg_driver_version.restype = i
        lib.cg_error_string.argtypes = [i]
        lib.cg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{_library().cg_error_string(err).decode()} "
                           f"({err})")


_body_streams: dict = {}


def _card(device) -> torch.device:
    """``device`` with its index (the current card's where it names
    none), so that "cuda" and "cuda:0" share one stream and one warm-up."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    return dev


def _body_stream(device) -> torch.cuda.Stream:
    """The stream every conditional body of a capture on ``device`` is
    captured on."""
    dev = _card(device)
    if dev not in _body_streams:
        _body_streams[dev] = torch.cuda.Stream(device=dev)
    return _body_streams[dev]


def _as_flag(pred) -> torch.Tensor:
    """A 0-d bool device tensor the set-conditional kernel can read."""
    if pred.ndim != 0:
        raise ValueError(f"a conditional node takes a 0-d flag, got shape "
                         f"{tuple(pred.shape)}")
    return pred if pred.dtype == torch.bool else pred != 0


@contextlib.contextmanager
def _body(kind: int, pred):
    """Capture what the block enqueues into the body of a new IF (kind 0)
    or WHILE (kind 1) node taken on the device flag ``pred`` (``None``:
    an IF taken at every launch, the root body of :func:`capture`), on
    the body stream.  Yields the node's handle (a WHILE body ends with
    :func:`_set_again`).  The flag is held until the body is captured:
    the node reads it where it was enqueued."""
    flag = None if pred is None else _as_flag(pred)
    parent = torch.cuda.current_stream()
    body = _body_stream(parent.device)
    handle = ctypes.c_ulonglong()
    suspended, after = ctypes.c_void_p(), ctypes.c_void_p()
    lib = _library()
    _check(lib.cg_begin(parent.cuda_stream, body.cuda_stream, kind,
                        None if flag is None else flag.data_ptr(),
                        ctypes.byref(handle), ctypes.byref(suspended),
                        ctypes.byref(after)),
           "adding a conditional node")
    failed = False
    try:
        with torch.cuda.stream(body):
            yield handle.value
    except BaseException:
        failed = True
        raise
    finally:
        err = lib.cg_end(body.cuda_stream, suspended, after)
        if not failed:
            _check(err, "ending a conditional body's capture")


def _set_again(handle: int, pred) -> None:
    flag = _as_flag(pred)
    _check(_library().cg_set(torch.cuda.current_stream().cuda_stream, handle,
                             flag.data_ptr()),
           "setting a WHILE node's condition")


def if_body(pred, fn):
    """``fn()`` captured into the body of an IF node on the 0-d device
    flag ``pred``: on replay it runs only where the flag holds, and its
    outputs hold garbage otherwise."""
    with _body(0, pred):
        return fn()


def while_body(pred, fn):
    """A WHILE node on the 0-d device flag ``pred``; ``fn()`` is one
    trip and returns the flag for the next (taken at the end of the
    trip)."""
    with _body(1, pred) as handle:
        _set_again(handle, fn())


class _GuardFlags:
    """One bool slot per finite-value check of a captured graph, on each
    device, made once OUTSIDE every graph: a flag allocated during a
    capture would share its memory with the graph's earlier temporaries,
    which a replay writes after the flag was zeroed.  The k-th check of a
    capture takes slot k; a replay zeroes the slots of its graph first
    and reads them back after."""

    CAPACITY = 4096
    slots: dict = {}


def _guard_slots(device) -> torch.Tensor:
    dev = torch.device(device).index
    if dev is None:
        dev = torch.cuda.current_device()
    if dev not in _GuardFlags.slots:
        _GuardFlags.slots[dev] = torch.zeros(
            _GuardFlags.CAPACITY, dtype=torch.bool, device=f"cuda:{dev}")
    return _GuardFlags.slots[dev]


def guard(name: str, bad) -> None:
    """A finite-value check inside a device-resident solve
    (``utils.debug.guarded_functions``).  On a CPU rehearsal it raises
    at once; captured, the device flag ``bad`` is or-ed into the check's
    slot (:class:`_GuardFlags`), zeroed before every replay and read back
    after it (one read-back, only in graphs that hold a check), and the
    first function whose flag is set is named."""
    if _state.mode == "emulate":
        if flag_value(bad):
            raise FloatingPointError(f"non-finite values from {name}(x)")
        return
    k = len(_state.guards)
    if k == _GuardFlags.CAPACITY:
        raise RuntimeError(f"more than {k} finite-value checks in one "
                           f"captured solve")
    # the check may sit beneath torch.func transforms (a closure's
    # Jacobian, a Newton Hessian), which refuse writes into a tensor made
    # outside them: ``bad`` is a plain tensor, and so is the write
    with torch._C._DisableFuncTorch():
        _guard_slots(bad.device)[k:k + 1].logical_or_(bad.reshape(1))
    _state.guards.append(name)


def _check_guards(entry, slots) -> None:
    if not entry.guards:
        return
    hit = to_host_list(slots[:len(entry.guards)])
    for name, bad in zip(entry.guards, hit):
        if bad:
            raise FloatingPointError(f"non-finite values from {name}(x)")


# ------------------------------------------------------------- launches

class _DeviceCounts:
    """Launches that a captured graph makes when it is replayed: one int64
    slot per kernel on each device, incremented by a node captured beside
    the kernel's launch.  The slots are made once, with room for
    ``CAPACITY`` counts: a graph holds their address."""

    CAPACITY = 64
    names: list = []
    slots: dict = {}


def _count_name(fn, attr: str) -> str:
    return f"{fn.__module__}.{fn.__qualname__}.{attr}"


def count_launch(fn, attr: str = "launches") -> None:
    """Count one launch of the kernel whose wrapper is ``fn``: on the
    wrapper's plain integer ``fn.<attr>`` when the launch happens now,
    on a device counter when it is captured (it happens at every
    replay)."""
    if not capturing():
        setattr(fn, attr, getattr(fn, attr) + 1)
        return
    name = _count_name(fn, attr)
    if name not in _DeviceCounts.names:
        raise RuntimeError(f"{name} is not registered for device launch "
                           f"counts (call _graph.register_counts first)")
    slots = _DeviceCounts.slots[torch.cuda.current_device()]
    slots[_DeviceCounts.names.index(name)].add_(1)


def register_counts(fn, *attrs: str) -> None:
    """Make room for the device launch counts of a kernel wrapper's
    count attributes (default ``launches``); at import time, before any
    capture: the counters live outside every graph."""
    for attr in attrs or ("launches",):
        if _count_name(fn, attr) not in _DeviceCounts.names:
            if len(_DeviceCounts.names) == _DeviceCounts.CAPACITY:
                raise RuntimeError("no device launch count slot is left")
            _DeviceCounts.names.append(_count_name(fn, attr))


def _device_slots(device) -> torch.Tensor:
    dev = torch.device(device).index
    if dev is None:
        dev = torch.cuda.current_device()
    if dev not in _DeviceCounts.slots:
        _DeviceCounts.slots[dev] = torch.zeros(
            _DeviceCounts.CAPACITY, dtype=torch.int64, device=f"cuda:{dev}")
    return _DeviceCounts.slots[dev]


def launches(fn, attr: str = "launches", device=None) -> int:
    """All launches of a kernel: the wrapper's own count plus what
    replayed graphs launched on ``device`` (default: the current card),
    read back once.  For measurement scripts."""
    total = getattr(fn, attr)
    name = _count_name(fn, attr)
    if name in _DeviceCounts.names and torch.cuda.is_available():
        slots = _device_slots(device if device is not None else "cuda")
        total += int(slots[_DeviceCounts.names.index(name)])
    return total


def reset_launches() -> None:
    """Zero the device launch counts (the wrappers' own integers are
    zeroed by their modules' reset functions or by assignment)."""
    for slots in _DeviceCounts.slots.values():
        slots.zero_()


# ---------------------------------------------------------------- spans

class _SpanRing:
    """The ring the span stamps of ``utils/profiling.py`` write on each
    device: ``CAPACITY`` events of 16 bytes (site and edge, payload,
    ``%globaltimer`` ns) after a 16-byte head whose first word counts the
    stamps taken (an event goes to slot count mod ``CAPACITY``).  Made
    once, OUTSIDE every graph (a block allocated during a capture would
    be reused by the graph's temporaries, see :class:`_GuardFlags`):
    :func:`capture` makes it before a capture with tracing on, a graph
    holds its address."""

    CAPACITY = 1 << 20
    rings: dict = {}


def span_ring(device=None, make: bool = False):
    """The span ring of the CUDA ``device`` (default: the current card),
    made if ``make``, else ``None`` where it was never made."""
    if not torch.cuda.is_available():
        return None
    dev = _card(device if device is not None else "cuda")
    if dev not in _SpanRing.rings and make:
        if capturing():
            raise RuntimeError("a span ring cannot be made while a graph "
                               "is captured: tracing was turned on inside "
                               "the capture")
        _SpanRing.rings[dev] = torch.zeros(
            (_SpanRing.CAPACITY + 1, 2), dtype=torch.int64, device=dev)
    return _SpanRing.rings.get(dev)


def span_rings() -> list:
    return list(_SpanRing.rings.values())


def clear_span_rings() -> None:
    for ring in _SpanRing.rings.values():
        ring.zero_()


def stamp(device, code: int, payload_ptr) -> None:
    """Launch the span stamp ``code`` (2 site + edge) on the current
    stream of the CUDA ``device``, reading its payload from the int at
    ``payload_ptr`` (``None``: no payload) when it runs."""
    ring = span_ring(device, make=True)
    _check(_library().cg_stamp(
        torch.cuda.current_stream(ring.device).cuda_stream, ring.data_ptr(),
        _SpanRing.CAPACITY, code, payload_ptr), "launching a span stamp")


def _tracing() -> bool:
    from .utils import profiling
    return profiling.enabled()


# -------------------------------------------------------------- capture

_SCRATCH = {}


def warm_up(device) -> None:
    """Create what the libraries create at their first call on a stream
    (cuBLAS and cuSOLVER handles and workspaces) before a capture, on the
    body stream (the capture stream only adds the root node), in both
    dtypes."""
    dev = _card(device)
    if dev in _SCRATCH:
        return
    st = _body_stream(dev)
    st.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(st):
        for dt in (torch.float32, torch.float64):
            a = torch.eye(4, dtype=dt, device=dev) * 2.0
            b = a @ a
            torch.linalg.cholesky_ex(b)
            torch.linalg.cholesky_ex(b.expand(3, 4, 4))
            torch.linalg.solve_triangular(a, b, upper=True)
            torch.linalg.solve_triangular(a.expand(3, 4, 4),
                                          b.expand(3, 4, 4), upper=True)
            torch.linalg.qr(torch.ones(64, 4, dtype=dt, device=dev)
                            + a.repeat(16, 1))
            torch.bmm(a.expand(3, 4, 4), b.expand(3, 4, 4))
    torch.cuda.current_stream(dev).wait_stream(st)
    _device_slots(dev)
    _guard_slots(dev)
    torch.cuda.synchronize(dev)
    _SCRATCH[dev] = True


_capture_streams: dict = {}


def _capture_stream(device) -> torch.cuda.Stream:
    dev = _card(device)
    if dev not in _capture_streams:
        _capture_streams[dev] = torch.cuda.Stream(device=dev)
    return _capture_streams[dev]


class Graph:
    """A captured function: its graph, the static inputs the caller copies
    into before a replay, the outputs a replay overwrites, the pool of
    its memory, how long capture and instantiation took, and the names
    of its finite-value checks in slot order."""

    def __init__(self, graph, inputs, outputs, pool, capture_s: float,
                 guards=()):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.pool = pool
        self.capture_s = capture_s
        self.guards = list(guards)


def capture(fn, inputs, device) -> Graph:
    """Capture ``fn(*inputs)`` on the CUDA ``device`` (``inputs``: a
    tuple of tensor nests, the graph's static inputs)."""
    dev = torch.device(device)
    _library()
    # every kernel module registers its device launch counts on import:
    # import them before a capture might
    from . import _dist  # noqa: F401
    from .ops import cpqr_batched_hopper, cpqr_hopper, wy_hopper  # noqa: F401
    with torch.cuda.device(dev):
        warm_up(dev)
        if _tracing():
            span_ring(dev, make=True)
        t0 = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        pool = torch.cuda.MemPool()
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        with torch.cuda.graph(g, stream=_capture_stream(dev),
                              capture_error_mode="thread_local"):
            # the function runs in the root body, on the body stream, and
            # every allocation made during the capture goes to the graph's
            # own pool, whatever thread makes it: the backward ops of
            # reverse-mode AD in a body (a Newton step's Hessians) run on
            # autograd's device thread, and a block that left the pool
            # would be freed after the capture while the graph still
            # writes it (PyTorch's capture stream allocates nothing)
            torch._C._cuda_beginAllocateToPool(index, pool.id)
            _state.guards = []
            try:
                with _mode("capture"), forbid_readbacks(strict=False), \
                        _body(0, None):
                    outputs = fn(*inputs)
            finally:
                # the begin took a reference to the pool, as
                # torch.cuda.use_mem_pool's does: give it back (the
                # MemPool object keeps its own while the graph lives)
                torch._C._cuda_endAllocateToPool(index, pool.id)
                torch._C._cuda_releasePool(index, pool.id)
                guards, _state.guards = _state.guards, None
        torch.cuda.synchronize(dev)
        return Graph(g, inputs, outputs, pool, time.perf_counter() - t0,
                     guards)


class _Cache:
    """Bounded LRU of captured graphs."""

    def __init__(self, size: int):
        self.size = size
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def clear(self) -> None:
        self.entries.clear()


_cache = _Cache(8)


def clear_graph_cache() -> None:
    """Drop every cached graph and give its memory back to the card."""
    _cache.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def graph_stats() -> dict:
    """Captures, replays and capture seconds since the last reset."""
    return {"captures": _cache.captures, "replays": _cache.replays,
            "capture_s": _cache.capture_s, "cached": len(_cache.entries)}


def reset_graph_stats() -> None:
    _cache.captures = _cache.replays = 0
    _cache.capture_s = 0.0


def graph_key(key, device) -> tuple:
    """The cache key of :func:`run` with ``key`` on ``device`` now: the
    key, the device and whether tracing is on."""
    return key, torch.device(device), _tracing()


def cached(key, device) -> bool:
    """Whether :func:`run` with ``key`` on the CUDA ``device`` replays a
    cached graph (else it captures one).  For measurement scripts."""
    return graph_key(key, device) in _cache.entries


def _copy_into(dst, src) -> None:
    for d, s in zip(pytree.tree_leaves(dst), pytree.tree_leaves(src)):
        if isinstance(d, torch.Tensor):
            d.copy_(s)


def run(key, fn, inputs: tuple, device, warm=None):
    """``fn(*inputs)`` device-resident.

    On a CUDA device: captured at the first call with this ``key``,
    replayed after (the inputs are copied into the graph's static inputs
    first).  Returns the graph's output buffers, which the next replay of
    the same key overwrites: the caller clones what it keeps.  On the CPU:
    a rehearsal, ``fn(*inputs)`` eagerly with the flags read directly and
    every other read-back forbidden.

    ``warm``: run eagerly before a capture (and before a rehearsal), so
    that what user closures create at their first call (constants moved
    to the device) exists before the capture begins; its spans are not
    recorded.  Whether tracing is on (``utils.profiling.enabled``) is part
    of the key: a graph captured with span stamps is never replayed for
    a call without them, nor the reverse."""
    from .utils.profiling import quiet
    dev = torch.device(device)
    if dev.type != "cuda":
        if warm is not None:
            with quiet():
                warm()
        with _mode("emulate"), forbid_readbacks():
            return fn(*inputs)
    if device_resident():
        raise RuntimeError("a device-resident solve cannot start another")
    full_key = graph_key(key, dev)
    entry = _cache.entries.get(full_key)
    if entry is None:
        static = pytree.tree_map(
            lambda a: a.clone() if isinstance(a, torch.Tensor) else a, inputs)
        if warm is not None:
            with torch.cuda.device(dev), quiet():
                warm()
        entry = capture(fn, static, dev)
        _cache.captures += 1
        _cache.capture_s += entry.capture_s
        _cache.entries[full_key] = entry
        while len(_cache.entries) > _cache.size:
            _cache.entries.popitem(last=False)
    else:
        _cache.entries.move_to_end(full_key)
        with torch.cuda.device(dev):
            _copy_into(entry.inputs, inputs)
    with torch.cuda.device(dev):
        slots = _guard_slots(dev)
        slots[:len(entry.guards)].zero_()
        entry.graph.replay()
    _cache.replays += 1
    _check_guards(entry, slots)
    return entry.outputs


def shapes_key(tree) -> tuple:
    """The static part of a nest of inputs: structure, and each tensor
    leaf's shape and dtype (non-tensor leaves by value)."""
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec),) + tuple(
        (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
        for a in leaves)


@contextlib.contextmanager
def linalg_scope(device):
    """cuSOLVER for PyTorch's linear algebra on the card during a solve,
    eager or captured alike (its heuristic may otherwise pick MAGMA, a
    host-hybrid library that cannot be captured, and a graph and the
    eager loop must run the same library to give the same bits)."""
    if torch.device(device).type != "cuda":
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)
