"""Spans (``enlsip_tpu_torch/utils/profiling.py``) on the CPU, and the
benchmark's readers of them (``portbench/metrics/*``).

* Rehearsed solves with tracing on: one ``solve`` span, one ``iteration``
  span a trip of the loop, every child inside its parent, self times not
  negative, one ``cpqr`` span a factorization with the dispatch's route;
  a rehearsed batch: one ``trip`` span a lockstep trip.
* Tracing off: no record, no span object, no stamp; the graph key knows
  whether tracing is on.
* ``align`` on a synthetic trace; each reader on synthetic records.
No JAX compile.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import enlsip_tpu_torch as et
from enlsip_tpu_torch import _graph
from enlsip_tpu_torch.ops import blocked_qr
from enlsip_tpu_torch.ops.blocked_qr import (LARGE_KMAX, batched_route,
                                             cpqr_blocked)
from enlsip_tpu_torch.parallel import solve_batched
from enlsip_tpu_torch.parallel.batch import run_batch
from enlsip_tpu_torch.problems.classic import HS65, chained_rosenbrock
from enlsip_tpu_torch.utils import profiling
from enlsip_tpu_torch.utils.profiling import Span

from torch_port_helpers import F64

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tracing():
    profiling.clear()
    profiling.enable(True)
    yield
    profiling.enable(None)
    profiling.clear()


@pytest.fixture
def routes(monkeypatch):
    """Every factorization the dispatch ran on the CPU as (route, rows,
    cols, lanes), in order: the route named by the function that ran it
    (the outermost, where one calls another)."""
    from enlsip_tpu_torch.ops import cpqr_batched_hopper
    seen, depth = [], [0]

    def counted(route, fn):
        def call(M, *a, **k):
            if depth[0] == 0:
                seen.append((route, M.shape[-2], M.shape[-1],
                             M.shape[0] if M.ndim == 3 else 0))
            depth[0] += 1
            try:
                return fn(M, *a, **k)
            finally:
                depth[0] -= 1
        return call

    for module, name, route in [
            (blocked_qr, "_cpqr_xla", "rank1"),
            (blocked_qr, "_cpqr_xla_panels", "panels"),
            (blocked_qr, "_cpqr_xla_panels_lanes", "panels"),
            (cpqr_batched_hopper, "cpqr_batched_packed", "b2"),
            (cpqr_batched_hopper, "cpqr_batched_packed_plain", "rank1")]:
        monkeypatch.setattr(module, name,
                            counted(route, getattr(module, name)))
    return seen


def _expected_route(rows, cols, lanes):
    if lanes:
        return batched_route(rows, cols, F64, "cpu")
    return "panels" if min(rows, cols) >= LARGE_KMAX else "rank1"


def _check_nesting(recs):
    for i, r in enumerate(recs):
        assert r.end_ns >= r.start_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
            assert p.call == r.call and p.clock == r.clock
        kids = [k for k in recs if k.parent == i]
        assert sum(k.end_ns - k.start_ns for k in kids) <= \
            r.end_ns - r.start_ns


def _check_cpqr(recs, seen):
    cpqr = [r for r in recs if r.name == "cpqr"]
    assert len(cpqr) == len(seen) > 0
    for r, (route, rows, cols, lanes) in zip(cpqr, seen):
        assert r.attrs == {"route": route, "rows": rows, "cols": cols,
                           "lanes": lanes}
        assert route == _expected_route(rows, cols, lanes)


@pytest.mark.parametrize("problem", ["hs65", "chained_rosenbrock_10"])
def test_rehearsed_solve_spans(problem, tracing, routes):
    model = et.CnlsModel(**(HS65 if problem == "hs65"
                            else chained_rosenbrock(10)))
    et.solve(model, device="cpu")
    recs = profiling.spans()
    names = [r.name for r in recs]
    assert names.count("solve") == names.count("api.solve") == 1
    assert names.count("init") == names.count("pack") == 1
    # one iteration span a trip of the loop: the counted iterations and
    # the pass whose TERCRI ends the solve (it records no iteration)
    iterations = len(model.model_info.iterations_detail)
    assert names.count("iteration") == iterations + 1
    for stage in ("wrkset", "analys", "stplng", "tercri"):
        assert names.count(stage) == iterations + 1
    _check_nesting(recs)
    _check_cpqr(recs, routes)
    # the single solve's step counts are 0-d tensors: read as payloads
    assert all(r.payload is not None and r.payload >= 0
               for r in recs if r.name == "cpqr")
    (solve,) = [r for r in recs if r.name == "solve"]
    assert recs[solve.parent].name == "replay"
    assert {recs[r.parent].name for r in recs if r.name == "iteration"} \
        == {"solve"}


def test_rehearsed_batch_trip_spans(tracing, routes):
    fns = et.Functions(*et.models.model._model_functions(
        et.CnlsModel(**HS65), F64, "cpu"))
    rng = np.random.default_rng(3)
    x0 = HS65["starting_point"] + 0.3 * rng.normal(size=(8, 3))
    solve_batched(fns, x0, et.Dims(3, 3, 0, 7), et.Options(),
                  et.Tols.for_dtype(F64), device="cpu")
    recs = profiling.spans()
    names = [r.name for r in recs]
    assert names.count("batch") == names.count("api.solve_batched") == 1
    assert names.count("trip") == run_batch.last_trips > 0
    _check_nesting(recs)
    _check_cpqr(recs, routes)
    assert {r.attrs["route"] for r in recs if r.name == "cpqr"} >= {"b2"}


@pytest.mark.parametrize("shape", [(7, 5), (200, 192), (4, 6, 3),
                                   (3, 30, 12), (2, 200, 192)])
def test_every_cpqr_call_is_a_span_with_its_route(shape, tracing, routes):
    M = torch.randn(shape, dtype=F64,
                    generator=torch.Generator().manual_seed(0))
    nsteps = torch.tensor(3) if len(shape) == 2 else None
    cpqr_blocked(M, nsteps=nsteps, device="cpu")
    recs = profiling.spans()
    _check_cpqr(recs, routes)
    assert recs[0].payload == (3 if len(shape) == 2 else None)


def test_tracing_off_records_and_stamps_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span was made with tracing off")
    stamps = []
    monkeypatch.setattr(_graph, "stamp", lambda *a: stamps.append(a))
    profiling.clear()
    profiling.enable(False)
    try:
        monkeypatch.setattr(profiling, "_Span", refuse)
        et.solve(et.CnlsModel(**HS65), device="cpu")
        with profiling.span("x", "cuda"):
            pass
        assert profiling.spans() == [] and stamps == []
        monkeypatch.undo()
        monkeypatch.setattr(_graph, "stamp", lambda *a: stamps.append(a))
        # the same device span with tracing on launches its two stamps
        profiling.enable(True)
        with profiling.span("x", "cuda"):
            pass
        assert [code & 1 for _, code, _ in stamps] == [0, 1]
    finally:
        profiling.enable(None)
        profiling.clear()


def test_graph_key_knows_whether_tracing_is_on():
    try:
        profiling.enable(False)
        off = _graph.graph_key(("solve", 1), "cuda:0")
        profiling.enable(True)
        on = _graph.graph_key(("solve", 1), "cuda:0")
        profiling.enable(None)
        assert off != on and off[:2] == on[:2]
        assert _graph.graph_key(("solve", 1), "cuda:0") == off
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert _graph.graph_key(("solve", 1), "cuda:0") == on
            profiling.enable(False)
            assert _graph.graph_key(("solve", 1), "cuda:0") == off
    finally:
        profiling.enable(None)


# ------------------------------------------------------- one clock

def _events(n_calls=3):
    """Synthetic stamps of ``n_calls`` calls, each a root (site 0)
    around two children (sites 1 and 2), 1 ms apart: (code, payload,
    t_ns)."""
    out, t = [], 10_000_000
    for _ in range(n_calls):
        for code in (0, 2, 3, 4, 5, 1):
            out.append((code, profiling.NO_PAYLOAD, t))
            t += 1_000_000
    return out


def test_align_gives_the_offset_and_refuses_a_missing_stamp():
    events = _events()
    offset_us = 1234.5
    # the trace holds the last two calls' stamps, each read 0.2 us late
    traced = events[6:]
    kernels = [(f"{profiling.STAMP_KERNEL}(unsigned long long*)",
                t * 1e-3 + offset_us + 0.2 * (i % 2), t * 1e-3 + offset_us
                + 1.0) for i, (_, _, t) in enumerate(traced)]
    kernels += [("cpqr_resident_double_", 5.0, 9.0)]
    got = profiling.align(kernels, events)
    assert got.stamps == 12
    assert got.offset_us == pytest.approx(offset_us + 0.1)
    assert got.spread_us == pytest.approx(0.2)
    assert got.step_us == pytest.approx(0.2)
    # a stamp's own time maps to its kernel's start
    for (_, _, t), (_, start, _) in zip(traced, kernels):
        assert got.to_trace(t) == pytest.approx(start)
    # two clocks drifting apart: the spread grows, the map follows
    drift = [(n, s + 1e-2 * (s - kernels[0][1]), e)
             for n, s, e in kernels]
    slid = profiling.align(drift, events)
    assert slid.spread_us > 5 * slid.step_us
    t_mid = (traced[3][2] + traced[4][2]) // 2
    assert slid.to_trace(t_mid) == pytest.approx(
        0.5 * (drift[3][1] + drift[4][1]))
    for missing in (0, 5, 11):
        assert profiling.align(kernels[:missing] + kernels[missing + 1:],
                               events) is None
    assert profiling.align(kernels, events[-5:]) is None
    assert profiling.align(kernels[-1:], events) is None


# --------------------------------------------------------- readers

def _reader(name):
    from portbench import harness
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                               "test_spans_" + name.replace(".", "_"))


SOLVE = dict(entry="solve", api="api.solve", root="solve", inner="iteration",
             route="resident")
BATCH = dict(entry="batch", api="api.solve_batched", root="batch",
             inner="trip", route="b2")


def _records(kind, n_calls):
    """Set-up, window and traced calls: ``n_calls`` calls of 10 ms on the
    card (two inner spans of 4 ms, each around a 1 ms ``cpqr``) inside
    12 ms API spans on the host."""
    recs = []
    for call in range(n_calls):
        t = call * 1_000_000_000
        recs.append(Span(call, kind["api"], None, t, t + 12_000_000, "host",
                         {}, None))
    for call in range(n_calls):
        t = call * 1_000_000_000
        root = len(recs)
        recs.append(Span(call, kind["root"], None, t, t + 10_000_000,
                         "device", {}, None))
        for k in range(2):
            s = t + 1_000_000 + k * 4_000_000
            recs.append(Span(call, kind["inner"], root, s, s + 4_000_000,
                             "device", {}, None))
            recs.append(Span(call, "cpqr", len(recs) - 1, s, s + 1_000_000,
                             "device", {"route": kind["route"]}, 5))
    return recs


@pytest.mark.parametrize("name,kind,expected", [
    ("api_ms.solve", SOLVE, 2.0), ("api_ms.batch", BATCH, 2.0),
    ("iteration_ms.solve", SOLVE, 4.0), ("trip_ms.batch", BATCH, 4.0),
    ("b1_span_ms.solve", SOLVE, 2.0), ("b2_span_ms.batch", BATCH, 2.0),
    ("loop_ms.solve", SOLVE, 2.0), ("loop_ms.batch", BATCH, 2.0)])
def test_span_readers(name, kind, expected, monkeypatch):
    n_window, n_traced = 3, 1
    n_calls = 2 + n_window + n_traced
    recs = _records(kind, n_calls)
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    ctx = SimpleNamespace(entry=kind["entry"], n_calls=n_window,
                          traced_counts=[{}] * n_traced, trace=None)
    read = _reader(name).read
    assert read(ctx) == pytest.approx(expected)
    # the other entry's cells read nothing
    other = SimpleNamespace(**{**vars(ctx), "entry": "x"})
    assert read(other) is None
    # a ring that lost the oldest calls, the window's first among them
    cut = [r for r in recs if r.call > 2]
    monkeypatch.setattr(profiling, "spans", lambda: cut)
    assert read(ctx) is None
    # no span recorded at all (a program without them)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(ctx) is None
