"""Spans: named regions of a solve, on the host's clock and on the card's.

Counterpart of ``enlsip_tpu/utils/profiling.py``.  The reference's
observability is wall-clock timing and evaluation counters (both kept in
``ExecutionInfo``); this module adds spans that also see inside a
captured solve, where a host timer, an NVTX range or a
``record_function`` range sees only "the replay".

``span(name, device=None, payload=None, **attrs)`` marks a region:

* a DEVICE span (``device`` a CUDA device) launches a one-thread stamp
  kernel (``csrc/graph_cond.cu``, ``enlsip_span_stamp``) at its entry and
  at its exit on the current stream.  Captured into a graph, the stamp
  runs where the replay reaches it (inside a conditional body only when
  the body runs) and writes ``(site, payload, %globaltimer ns)`` into a
  ring on the card (``_graph._SpanRing``).  ``payload`` is a 0-d integer
  tensor on the card that the stamp reads when it runs (a step count),
  or a function that makes one, called only while tracing is on (a count
  that costs a kernel of its own: with tracing off it never runs);
* on the CPU (a rehearsal of a device-resident solve) the same site
  appends ``(site, payload, perf_counter_ns)`` to a host list;
* a HOST span (no ``device``: the API's stages) records
  ``perf_counter_ns`` in the host list and, while a ``torch.profiler``
  session is open, is also a ``record_function`` range, so it sits on the
  trace's CPU timeline by name.

A site is registered the first time it runs (at capture for a graph)
with its name, its parent site (the innermost span open on the same
clock), its static attributes and its clock.  Tracing is on after
``enable(True)``, or while a ``torch.profiler`` session is open (unless
``enable(False)`` forced it off).  With tracing off ``span`` returns at
once: it records nothing, captures nothing and launches nothing, and
``_graph.run`` keys a graph by whether tracing was on when it was
captured, so a graph with stamps and one without are never confused.

``spans()`` pairs each entry with its exit (one copy of each ring) into
:class:`Span` records; :func:`align` puts the card's clock on a
``torch.profiler`` trace's; :func:`trace` writes a trace and the records.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import statistics
import threading
import time
from typing import NamedTuple, Optional

import torch

from .. import _device, _graph

STAMP_KERNEL = "enlsip_span_stamp"
NO_PAYLOAD = -(1 << 31)         # the stamp's payload word where it read none


class Span(NamedTuple):
    """One span as it ran.  ``call``: the ordinal of its root span among
    the roots recorded on its clock (``None`` for a record outside any);
    ``parent``: the index of the enclosing record in the list
    :func:`spans` returns (``None`` for a root); ``start_ns`` /
    ``end_ns`` on ``clock`` ("device": the card's ``%globaltimer``;
    "host": ``time.perf_counter_ns``)."""

    call: Optional[int]
    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: int
    clock: str
    attrs: dict
    payload: Optional[int]


class _Site(NamedTuple):
    name: str
    parent: Optional[int]
    attrs: tuple
    clock: str


class _Local(threading.local):
    def __init__(self):
        self.open = {"host": [], "device": []}     # site ids of open spans
        self.quiet = 0


_local = _Local()
_sites: list = []
_site_ids: dict = {}
_host = collections.deque(maxlen=_graph._SpanRing.CAPACITY)
_forced: Optional[bool] = None
_cache = {"key": None, "records": None}
_NULL = contextlib.nullcontext()


def enable(flag: Optional[bool] = True) -> None:
    """``True``: trace from now on; ``False``: never, even under a
    profiler; ``None``: trace while a ``torch.profiler`` session is open
    (the default)."""
    global _forced
    _forced = flag


def enabled() -> bool:
    if _forced is not None:
        return _forced
    return torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def quiet():
    """No span inside (the eager warm-up before a capture, which is no
    part of a solve)."""
    _local.quiet += 1
    try:
        yield
    finally:
        _local.quiet -= 1


def _site(name, parent, attrs, clock) -> int:
    key = _Site(name, parent, tuple(sorted(attrs.items())), clock)
    site = _site_ids.get(key)
    if site is None:
        site = _site_ids[key] = len(_sites)
        _sites.append(key)
    return site


class _Span:
    __slots__ = ("name", "device", "payload", "attrs", "site", "clock",
                 "ranged")

    def __init__(self, name, device, payload, attrs):
        self.name, self.payload, self.attrs = name, payload, attrs
        self.device = None if device is None else torch.device(device)
        self.clock = "device" if self.device is not None and \
            self.device.type == "cuda" else "host"

    def _mark(self, edge: int) -> None:
        code = 2 * self.site + edge
        p = self.payload
        if self.clock == "device":
            ptr = p.data_ptr() if isinstance(p, torch.Tensor) and \
                p.is_cuda and p.ndim == 0 and not p.is_floating_point() \
                else None
            _graph.stamp(self.device, code, ptr)
        else:
            if isinstance(p, torch.Tensor):
                p = _device.cpu_int(p) if p.ndim == 0 and \
                    p.device.type == "cpu" else None
            _host.append((code, NO_PAYLOAD if p is None else int(p),
                          time.perf_counter_ns()))

    def __enter__(self):
        stack = _local.open[self.clock]
        self.site = _site(self.name, stack[-1] if stack else None,
                          self.attrs, self.clock)
        stack.append(self.site)
        self.ranged = self.device is None and \
            torch._C._autograd._profiler_enabled()
        if self.ranged:
            self.ranged = torch.profiler.record_function(self.name)
            self.ranged.__enter__()
        self._mark(0)
        return self

    def __exit__(self, *exc):
        self._mark(1)
        _local.open[self.clock].pop()
        if self.ranged:
            self.ranged.__exit__(*exc)
        return False


def span(name: str, device=None, payload=None, **attrs):
    """A named region (see the module docstring); a context manager."""
    if _local.quiet or not enabled():
        return _NULL
    if callable(payload):
        payload = payload()
    return _Span(name, device, payload, attrs)


annotate = span


def clear() -> None:
    """Forget every record (the sites stay: captured graphs name them)."""
    _host.clear()
    _graph.clear_span_rings()
    _cache["key"] = None


def device_events(device=None) -> list:
    """The card's stamps in the order they ran, ``(code, payload,
    t_ns)`` each (``code`` = 2 site + edge, edge 1 at an exit), from one
    copy of the ring of ``device`` (default: the current card); the
    oldest are overwritten past the ring's capacity.  Not a read-back of
    a solve: nothing counts it."""
    ring = _graph.span_ring(device)
    if ring is None:
        return []
    torch.cuda.synchronize(ring.device)
    return _decode(ring.cpu())


def _decode(ring: torch.Tensor) -> list:
    cap = ring.shape[0] - 1
    head = int(ring[0, 0])
    rows = ring[1:]
    if head > cap:
        k = head % cap
        rows = torch.cat([rows[k:], rows[:k]])
    else:
        rows = rows[:head]
    word = rows[:, 0]
    code = (word & 0xFFFFFFFF).tolist()
    payload = (word >> 32).tolist()
    return list(zip(code, payload, rows[:, 1].tolist()))


def _pair(events, clock: str, out: list) -> None:
    """Append the records of one clock's stamps to ``out``: each entry
    with its exit, nested as they ran.  A stretch that does not nest (the
    start of a ring that wrapped) is skipped up to the next root."""
    stack, call, first = [], -1, len(out)
    for code, payload, t in events:
        site, edge = code >> 1, code & 1
        info = _sites[site] if site < len(_sites) else None
        top = stack[-1] if stack else None
        if edge == 0:
            if info is None or info.parent != (None if top is None
                                                else out[top][0]):
                stack.clear()
                continue
            if top is None:
                call += 1
            out.append([site, call, top, t, None,
                        None if payload == NO_PAYLOAD else payload])
            stack.append(len(out) - 1)
        elif top is not None and out[top][0] == site:
            out[stack.pop()][4] = t
        else:
            stack.clear()
    # a call whose root did not close is left out, with what it holds
    open_calls = {out[i][1] for i in range(first, len(out))
                  if out[i][4] is None}
    if open_calls:
        keep = [r for r in out[first:] if r[1] not in open_calls]
        remap = {id(r): first + i for i, r in enumerate(keep)}
        index = {i: remap.get(id(out[i])) for i in range(first, len(out))}
        for r in keep:
            r[2] = None if r[2] is None else index[r[2]]
        del out[first:]
        out.extend(keep)


def spans() -> list:
    """Every record of the host list and of each card's ring, as
    :class:`Span` (host records first, then each card's)."""
    rings = _graph.span_rings()
    if rings:
        torch.cuda.synchronize()
    heads = tuple(int(r[0, 0]) for r in rings)   # one small copy each
    key = (heads, len(_host), _host[-1] if _host else None)
    if _cache["key"] == key:
        return _cache["records"]
    raw, clocks = [], []
    for events, clock in [(list(_host), "host")] + [
            (_decode(r.cpu()), "device") for r in rings]:
        first = len(raw)
        _pair(events, clock, raw)
        clocks += [clock] * (len(raw) - first)
    records = [Span(call=call, name=_sites[site].name, parent=parent,
                    start_ns=start, end_ns=end, clock=clock,
                    attrs=dict(_sites[site].attrs), payload=payload)
               for (site, call, parent, start, end, payload), clock
               in zip(raw, clocks)]
    _cache["key"], _cache["records"] = key, records
    return records


class Alignment(NamedTuple):
    """The card's ``%globaltimer`` on a trace's clock.  ``offset_us``:
    the median of the paired differences (trace start less card time);
    ``spread_us``: their largest less their smallest; ``step_us``: the
    largest change between two consecutive pairs (the two clocks drift
    apart slowly over seconds, which widens the spread, not the step);
    ``stamps``: how many were paired; ``pairs``: (card us, trace us) of
    each, in order."""

    offset_us: float
    spread_us: float
    step_us: float
    stamps: int
    pairs: tuple

    def to_trace(self, t_ns: int) -> float:
        """A card time on the trace's clock, in us: the difference of the
        nearest pairs, linear between them (a stamp's own time maps to
        its kernel's start)."""
        t = t_ns * 1e-3
        pairs = self.pairs
        i = bisect.bisect_left(pairs, (t, float("-inf")))
        if i == 0:
            return t + pairs[0][1] - pairs[0][0]
        if i == len(pairs):
            return t + pairs[-1][1] - pairs[-1][0]
        (a, sa), (b, sb) = pairs[i - 1], pairs[i]
        w = 0.0 if b == a else (t - a) / (b - a)
        return t + (sa - a) + w * ((sb - b) - (sa - a))


def align(kernels, events=None) -> Optional[Alignment]:
    """Pair the k-th ``enlsip_span_stamp`` kernel of a ``torch.profiler``
    trace (``(name, start_us, end_us)`` tuples, any kernels) with the
    k-th of the card's last K stamps (K: the stamps in the trace;
    ``events`` default :func:`device_events`).  ``None`` when there are
    fewer stamps on the card than in the trace, or when the last K do
    not nest as whole spans (a stamp the trace lost)."""
    starts = sorted(s for name, s, _ in kernels if STAMP_KERNEL in name)
    if events is None:
        events = device_events()
    k = len(starts)
    if k == 0 or k > len(events):
        return None
    last = events[len(events) - k:]
    stack = []
    for code, _, _ in last:
        if code & 1 == 0:
            stack.append(code >> 1)
        elif not stack or stack.pop() != code >> 1:
            return None
    if stack:
        return None
    pairs = tuple((t * 1e-3, s) for s, (_, _, t) in zip(starts, last))
    diffs = [s - t for t, s in pairs]
    step = max((abs(b - a) for a, b in zip(diffs, diffs[1:])), default=0.0)
    return Alignment(statistics.median(diffs), max(diffs) - min(diffs), step,
                     k, pairs)


@contextlib.contextmanager
def trace(dir_path: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card; on exit it is written to ``dir_path/trace.json``
    (Chrome trace format: chrome://tracing or Perfetto), and the spans
    recorded inside (tracing is on while the profiler is open) to
    ``dir_path/spans.json`` with :func:`align`'s offset of the card's
    clock onto the trace's.  Yields the profiler (``key_averages()`` for
    sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dir_path, exist_ok=True)
    clear()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dir_path, "trace.json"))
    kernels = [(e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() != torch.autograd.DeviceType.CPU]
    found = align(kernels) if torch.cuda.is_available() else None
    with open(os.path.join(dir_path, "spans.json"), "w") as out:
        json.dump({"align": None if found is None else {
            k: v for k, v in found._asdict().items() if k != "pairs"},
                   "spans": [r._asdict() for r in spans()]}, out)
