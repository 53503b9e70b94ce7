#!/usr/bin/env python3
"""Where a solve's time goes, from the port's spans, on an NVIDIA card.

    python3 chip_spans.py table   --cell <workload> [--seconds S] [--seed N]
    python3 chip_spans.py cost    --cell <workload> [--seconds S] [--rounds R]
    python3 chip_spans.py kernels --cell <workload> [--tree DIR]

Each prints one JSON line a cell and writes it to
``chiprun_out/spans_<mode>_<cell>.json``.

``table``: a benchmark session of the cell with tracing on (its profiler
session opened before the capture, as a ``--trace 1`` run opens it), a
window of ``S`` seconds, then the cell's traced calls under the profiler.
For every span name (``cpqr`` by route) of the traced calls: spans a
call, device self ms a call (the span less its children), kernels a call
that start in its self time, and idle ms a call (self time in which no
device operation ran, on the trace's clock through ``align``).  Beside it:
the stamps a call, the ``%globaltimer`` tick seen, ``align``'s offset
spread, the ratio of the traced calls' root span to the window's (the
profiler's stretch), and the window's mean call against its API spans.

``cost``: a session without the profiler; windows of ``S`` seconds with
tracing off and on (``profiling.enable``) in turn, ``R`` rounds, each
window's seconds a call.

``kernels``: the kernels of one traced call with tracing forced off under
the profiler, from the checkout at ``--tree`` (default this one): run on
a parent checkout and on this one, the counts compare the graphs' nodes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _session(tree: Path, cell_name: str, trace: bool):
    sys.path.insert(0, str(tree))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(tree / "build" / "torch_extensions"))
    import torch
    from portbench import harness
    torch.set_num_threads(2)
    cell = harness.Cell(cell_name, manifest_path=tree / "BENCHMARK.json",
                        base=tree / "portbench")
    return cell, harness.Session(cell, "cuda", trace=trace)


def _starts(session, seed):
    from portbench import generate
    tr = session.cell.traffic
    return generate.Starts(session.prob["x0"], tr["start_noise"], seed,
                           tr.get("lanes"), tr.get("pool"),
                           tr.get("pool_seed", 0))


def _window(session, starts, seconds):
    import torch
    n, t0 = 0, time.perf_counter()
    while True:
        session.entry.call(starts.next())
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def _busy_us(ops, a, b):
    total, end = 0.0, a
    for s, e in ops:
        if e <= end:
            continue
        if s >= b:
            break
        s, e = max(s, end), min(e, b)
        if e > s:
            total += e - s
            end = e
    return total


def _key(r):
    return r.name + ("." + r.attrs["route"] if r.name == "cpqr" else "")


def _self_ms(recs, roots) -> dict:
    """Self ms a call of each span name (children left out) over the
    calls of ``roots``, from the spans alone: no profiler."""
    calls = {r.call for r in roots}
    clock = roots[0].clock
    index = {id(r): i for i, r in enumerate(recs)}
    mine = [r for r in recs if r.clock == clock and r.call in calls]
    child = defaultdict(float)
    for r in mine:
        if r.parent is not None:
            child[r.parent] += r.end_ns - r.start_ns
    out = defaultdict(float)
    for r in mine:
        out[_key(r)] += (r.end_ns - r.start_ns - child[index[id(r)]]) * 1e-6
    return {k: v / len(roots) for k, v in sorted(out.items())}


def table(args) -> dict:
    import statistics
    cell, session = _session(HERE, args.cell, True)
    from enlsip_tpu_torch.utils import profiling
    root = "solve" if session.entry.kind == "solve" else "batch"
    api = "api.solve" if root == "solve" else "api.solve_batched"
    starts = _starts(session, args.seed)
    n_win, win_s = _window(session, starts, args.seconds)
    k = int(cell.traffic["traced_calls"])
    xs = [starts.next() for _ in range(k)]
    trace = session.profiler.trace(
        lambda: [session.entry.call(x) for x in xs])
    recs = profiling.spans()
    found = profiling.align(trace.kernels)
    roots = [r for r in recs if r.name == root and r.clock == "device"]
    apis = [r for r in recs if r.name == api]
    dur = lambda r: (r.end_ns - r.start_ns) * 1e-6
    win_roots, traced = roots[-k - n_win:-k], roots[-k:]
    win_apis = apis[-k - n_win:-k]
    out = {"cell": args.cell, "calls_window": n_win,
           "call_ms_window": 1e3 * win_s / n_win,
           "api_span_ms_window": statistics.mean(map(dur, win_apis)),
           "root_span_ms_window": statistics.mean(map(dur, win_roots)),
           "root_span_ms_traced": statistics.mean(map(dur, traced)),
           "align": None if found is None else {
               k: v for k, v in found._asdict().items() if k != "pairs"}}
    out["api_ms"] = out["api_span_ms_window"] - out["root_span_ms_window"]
    out["profiler_stretch"] = (out["root_span_ms_traced"]
                               / out["root_span_ms_window"])
    events = profiling.device_events()
    ts = [t for _, _, t in events]
    steps = sorted({b - a for a, b in zip(ts, ts[1:]) if b > a})
    out["globaltimer_smallest_step_ns"] = steps[:4]
    out["globaltimer_ns_mod_32_zero_share"] = (
        sum(t % 32 == 0 for t in ts) / max(len(ts), 1))
    calls = {r.call for r in traced}
    inner = [r for r in recs if r.clock == "device" and r.call in calls]
    out["stamps_per_call"] = 2 * len(inner) / k
    out["self_ms_a_call_window"] = _self_ms(recs, win_roots)
    if found is None:
        return out
    on = found.to_trace
    ops = sorted((s, e) for _, s, e in trace.device_ops)
    kstarts = sorted(s for _, s, _ in trace.kernels)
    index = {id(r): i for i, r in enumerate(recs)}
    kids = defaultdict(list)
    for r in inner:
        if r.parent is not None:
            kids[r.parent].append(r)
    rows = defaultdict(lambda: [0, 0.0, 0, 0.0])
    for r in inner:
        a, b = on(r.start_ns), on(r.end_ns)
        gaps, at = [], a
        for c in sorted(kids[index[id(r)]], key=lambda c: c.start_ns):
            gaps.append((at, on(c.start_ns)))
            at = on(c.end_ns)
        gaps.append((at, b))
        row = rows[_key(r)]
        row[0] += 1
        for g0, g1 in gaps:
            row[1] += (g1 - g0) * 1e-3
            row[2] += sum(g0 <= s < g1 for s in kstarts)
            row[3] += ((g1 - g0) - _busy_us(ops, g0, g1)) * 1e-3
    out["rows"] = {name: {"spans_a_call": v[0] / k,
                          "self_ms_a_call": v[1] / k,
                          "kernels_a_call": v[2] / k,
                          "idle_ms_a_call": v[3] / k}
                   for name, v in sorted(rows.items())}
    out["kernels_a_call"] = len(trace.kernels) / k
    diffs = [(t, s - t) for t, s in found.pairs]
    out["align_diffs_us"] = [[round(t - diffs[0][0], 1), round(d, 3)]
                             for t, d in diffs[::max(1, len(diffs) // 60)]]
    # B1's and B2's kernels by name, in the cpqr spans and anywhere
    names = {"b1": ("cpqr_resident", "cpqr_panels"),
             "b2": ("cpqr_batched_kernel",)}
    spans_us = [(on(r.start_ns), on(r.end_ns))
                for r in inner if r.name == "cpqr"]
    for layer, kn in names.items():
        ks = [(s, e) for n, s, e in trace.kernels if any(x in n for x in kn)]
        out[layer + "_kernel_ms_a_call"] = sum(e - s for s, e in ks) / k / 1e3
        out[layer + "_kernel_ms_in_cpqr_spans_a_call"] = sum(
            e - s for s, e in ks
            if any(a <= s and e <= b for a, b in spans_us)) / k / 1e3
    return out


def cost(args) -> dict:
    import torch
    cell, session = _session(HERE, args.cell, False)
    from enlsip_tpu_torch.utils import profiling
    starts = _starts(session, args.seed)
    x0 = starts.next()
    profiling.enable(True)          # capture the traced graph, warm it
    for _ in range(2):
        session.entry.call(x0)
    torch.cuda.synchronize()
    got = {"off": [], "on": []}
    for i in range(args.rounds):
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            profiling.enable(mode == "on")
            profiling.clear()
            n, s = _window(session, starts, args.seconds)
            got[mode].append(s / n)
    profiling.enable(None)
    out = {"cell": args.cell, "seconds_a_call": got}
    med = {m: sorted(v)[len(v) // 2] for m, v in got.items()}
    out["on_over_off"] = med["on"] / med["off"]
    return out


def kernels(args) -> dict:
    tree = Path(args.tree).resolve()
    cell, session = _session(tree, args.cell, True)
    forced = False
    try:
        from enlsip_tpu_torch.utils import profiling
        if hasattr(profiling, "enable"):
            profiling.enable(False)
            forced = True
    except ImportError:
        pass
    # the session's graph was captured with tracing on: capture and warm
    # the graph without stamps before the traced call
    starts = _starts(session, args.seed)
    for _ in range(2):
        session.entry.call(starts.next())
    trace = session.profiler.trace(
        lambda: session.entry.call(starts.next()))
    by = defaultdict(int)
    for name, _, _ in trace.kernels:
        by[name[:60]] += 1
    return {"cell": args.cell, "tree": str(tree), "tracing_forced_off": forced,
            "kernels": len(trace.kernels),
            "stamps": sum(v for k, v in by.items() if "span_stamp" in k),
            "device_ops": len(trace.device_ops)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("table", "cost", "kernels"))
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 17)
    ap.add_argument("--tree", default=str(HERE))
    args = ap.parse_args()
    import subprocess
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"table": table, "cost": cost, "kernels": kernels}[args.mode](args)
    out["card"] = limit.strip()
    line = json.dumps(out)
    print(line)
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    name = f"spans_{args.mode}_{args.cell}"
    if args.mode == "kernels":
        name += "_" + Path(args.tree).resolve().name
    (dest / f"{name}.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
