"""Device memory of a captured solve against its eager loop, on one NVIDIA GPU.

Run from the repository root (one CUDA device and ``nvcc``):

    python3 chip_graph_memory.py [--tree DIR] [--label NAME]
                                 [--rows M] [--dtypes float32,float64]
                                 [--configs a,b,c,d] [--no-eager]
                                 [--trace DTYPE:CONFIG]
    python3 chip_graph_memory.py --small [--profile] [--tree DIR]
    python3 chip_graph_memory.py --pools-probe [--tree DIR]
    python3 chip_graph_memory.py --chained N [--trace float64:cr] [--tree DIR]

``--tree DIR`` imports ``enlsip_tpu_torch`` from another checkout (a
``git archive`` of another commit unpacked under ``build/``), so that two
commits are measured by the same script on the same card.

Giant-m (``problems/giant_m.py``, M x 100 x 50, data drawn on the card
from seed 3, ``max_iter = 8``) in the configurations a-d of
``chip_smoke.py`` (a: factored hooks; b: factored hooks and second
derivatives; c: dense Jacobian; d: dense, ``tall_qr="qr"``), one JSON
line each with four figures, all ``torch.cuda`` allocator counters:

- ``eager_peak_GB``: ``max_memory_allocated()`` over one solve of the
  eager loop (``graph=False``), data included;
- ``capture_peak_GB``: the same over the capturing call (the warm-up, the
  capture and the first replay);
- ``graph_held_GB``: ``memory_reserved()`` after the capturing call and an
  ``empty_cache()``, less the same before it: what the cached graph keeps
  for itself, with ``graph_segments`` splitting the graph pools' segments
  by pool and by stream (the stream named after the ``_graph`` module's
  dictionary of streams that holds it);
- ``replay_peak_GB``: ``max_memory_allocated()`` over one replay (live
  tensors only: a replay allocates nothing, its blocks are the graph's).

The line also holds ``data_GB`` (allocated before the solves: W, Y),
``static_inputs_bytes``, the ratios the targets read
(``capture_over_eager``, ``held_over_eager``), seconds, and the graph's
x, exit code and iterations against the eager loop's (equal bits).  A
configuration that runs out of memory prints ``"outcome":
"out_of_memory"`` with the allocator's message and the peak so far.

A configuration with second derivatives also gives
``newton_hessians_eager_GB``: the peak over one eager evaluation of the
Newton branch's Hessian contractions at x0 (what that branch needs,
whether or not the eager solve takes it).

``--trace DTYPE:CONFIG`` records the allocator's history
(``torch.cuda.memory._record_memory_history``, Python stacks) over that
configuration's eager solve and its capturing call, and prints the
largest blocks live at each one's peak with the innermost frames of the
port that allocated them.

``--small``: Chained Rosenbrock n=40 float64 and HS65 x 64 lanes float64,
each captured and replayed twice, x held against the eager loop's (a
short run to put under ``compute-sanitizer --tool memcheck``);
``--profile`` adds ``torch.profiler`` over two replays of each graph and
prints the device's kernel time, the busy share and the top kernels.
``--pools-probe``: where a capture's allocations land
(the default pool's growth during a capture of reverse-mode AD in a
body) and whether replays after an ``empty_cache()`` still agree.
``--chained N``: the four figures of Chained Rosenbrock n=N float64, as
``tests/test_torch_graph_memory.py`` takes them (``--trace float64:cr``
for its blocks).

Every line goes to standard output and to
``chiprun_out/graph_memory_<label>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

GIANT_N, GIANT_L = 100, 50
GIANT_CONFIGS = {                      # factored hooks, second derivatives, tall_qr
    "a": (True, False, "cholqr"),
    "b": (True, True, "cholqr"),
    "c": (False, False, "cholqr"),
    "d": (False, False, "qr"),
}
GB = 1e9


def _args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=".")
    ap.add_argument("--label", default="change")
    ap.add_argument("--rows", type=int, default=5_000_000)
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--configs", default="a,b,c,d")
    ap.add_argument("--no-eager", action="store_true")
    ap.add_argument("--trace", default="")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--pools-probe", action="store_true")
    ap.add_argument("--chained", type=int, default=0)
    return ap.parse_args()


ARGS = None
OUT = None


def emit(obj) -> None:
    line = json.dumps(obj, default=str)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _stream_labels(graph_mod) -> dict:
    """cudaStream_t (as an int) -> the name of the ``_graph`` dictionary
    entry that holds that stream."""
    labels = {}
    for attr, val in vars(graph_mod).items():
        if isinstance(val, dict):
            for key, st in val.items():
                if isinstance(st, torch.cuda.Stream):
                    labels[st.cuda_stream] = f"{attr}[{key}]"
    return labels


def graph_segments(graph_mod) -> list:
    """The graph pools' segments (pool id other than the default (0, 0))
    summed by (pool, stream): reserved and active bytes."""
    labels = _stream_labels(graph_mod)
    sums = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        if pool == (0, 0):
            continue
        key = (str(pool), labels.get(seg["stream"], str(seg["stream"])))
        s = sums.setdefault(key, {"pool": key[0], "stream": key[1],
                                  "segments": 0, "reserved_GB": 0.0,
                                  "active_GB": 0.0})
        s["segments"] += 1
        s["reserved_GB"] += seg["total_size"] / GB
        s["active_GB"] += seg["active_size"] / GB
    return sorted(sums.values(), key=lambda s: -s["reserved_GB"])


def _port_frames(frames, k=8):
    """The innermost ``k`` frames of the port (the read-back guard's
    dispatch and tree_where's recursion left out), or the innermost three
    frames of any file where the port has none."""
    name = lambda f: f"{os.path.basename(f['filename'])}:{f['line']}:" \
        f"{f['name']}"
    mine = [name(f) for f in frames
            if "enlsip_tpu_torch" in f.get("filename", "")
            and not f["filename"].endswith("_device.py")]
    mine = [m for i, m in enumerate(mine)
            if not (":tree_where" in m and i and ":tree_where" in mine[i - 1])]
    return mine[:k] or [name(f) for f in frames[:3]]


def peak_blocks(trace, streams, top=16) -> dict:
    """Replay an allocator trace: the most bytes live at once and the
    largest blocks live at that moment, with their allocating frames."""
    live, cur, best, at = {}, 0, -1, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > best:
                best, at = cur, dict(live)
        elif ev["action"] in ("free_requested",):
            old = live.pop(ev["addr"], None)
            if old is not None:
                cur -= old["size"]
    blocks = sorted(at.values(), key=lambda e: -e["size"])[:top]
    return {"peak_live_GB_in_trace": best / GB,
            "largest_live_at_peak": [
                {"GB": e["size"] / GB,
                 "stream": streams.get(e["stream"], str(e["stream"])),
                 "frames": _port_frames(e.get("frames", []))}
                for e in blocks]}


def traced(fn, graph_mod):
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc",
                                             stacks="python",
                                             max_entries=2_000_000)
    try:
        out = fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    dev = torch.cuda.current_device()
    trace = snap["device_traces"][dev]
    return out, peak_blocks(trace, _stream_labels(graph_mod))


def newton_hessians(fns, gm) -> float:
    """What the Newton branch's second-order terms take by themselves:
    the peak allocated over one eager ``hessian_contractions`` (reverse
    over reverse AD of r(x) . r(x0) and c(x) . lam at x0), less what was
    allocated before it."""
    from enlsip_tpu_torch.core.subproblem import hessian_contractions
    x = gm.x0
    rx = fns.res(x)
    lam = torch.zeros(gm.dims.l, dtype=x.dtype, device=x.device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hessian_contractions(fns.res, fns.cons, x, rx, lam)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / GB


def measure(_graph, solve, row, trace=False):
    """The four figures of ``solve(graph)`` into ``row``."""
    _graph.clear_graph_cache()
    torch.cuda.synchronize()
    row["data_GB"] = torch.cuda.memory_allocated() / GB
    stage = "eager"
    try:
        eager = None
        if not ARGS.no_eager:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            if trace:
                eager, row["eager_trace"] = traced(lambda: solve(False),
                                                   _graph)
            else:
                eager = solve(False)
            torch.cuda.synchronize()
            row["eager_seconds"] = time.time() - t0
            row["eager_peak_GB"] = torch.cuda.max_memory_allocated() / GB
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        stage = "capture"
        t0 = time.time()
        if trace:
            first, row["capture_trace"] = traced(lambda: solve(True), _graph)
        else:
            first = solve(True)
        torch.cuda.synchronize()
        row["capturing_call_seconds"] = time.time() - t0
        row["capture_seconds"] = _graph.graph_stats()["capture_s"]
        row["capture_peak_GB"] = torch.cuda.max_memory_allocated() / GB
        row["capture_peak_reserved_GB"] = \
            torch.cuda.max_memory_reserved() / GB
        torch.cuda.empty_cache()
        row["graph_held_GB"] = (torch.cuda.memory_reserved() - reserved0) / GB
        row["graph_segments"] = graph_segments(_graph)
        stage = "replay"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = solve(True)
        torch.cuda.synchronize()
        row["replay_seconds"] = time.time() - t0
        row["replay_peak_GB"] = torch.cuda.max_memory_allocated() / GB
        row["replay_peak_reserved_GB"] = \
            torch.cuda.max_memory_reserved() / GB
        row.update(outcome="solved", exit_code=res.exit_code,
                   iterations=res.n_iter,
                   first_call_equals_replay=bool(torch.equal(first.x, res.x)))
        if eager is not None:
            row.update(
                eager_exit_code=eager.exit_code,
                eager_iterations=eager.n_iter,
                x_bits_equal_eager=bool(torch.equal(eager.x, res.x)),
                capture_over_eager=row["capture_peak_GB"]
                / row["eager_peak_GB"],
                held_over_eager=row["graph_held_GB"] / row["eager_peak_GB"],
                capture_net_over_eager_net=(
                    row["capture_peak_GB"] - row["data_GB"])
                / (row["eager_peak_GB"] - row["data_GB"]),
                held_over_eager_net=row["graph_held_GB"]
                / (row["eager_peak_GB"] - row["data_GB"]))
    except torch.OutOfMemoryError as err:
        row.update(outcome="out_of_memory", stage=stage,
                   message=str(err).splitlines()[0][:400],
                   peak_so_far_GB=torch.cuda.max_memory_allocated() / GB,
                   reserved_GB=torch.cuda.memory_reserved() / GB)
    _graph.clear_graph_cache()
    return row


def _static_bytes(x0, tols) -> int:
    return x0.nbytes + sum(t.nbytes for t in tols
                           if isinstance(t, torch.Tensor))


def chained(et, core_solve, _graph, n):
    """The four figures of Chained Rosenbrock n float64 (second
    derivatives off), as ``tests/test_torch_graph_memory.py`` takes them:
    after one eager solve and ``_graph.warm_up``, so that the libraries'
    workspaces of both streams exist before either loop is measured."""
    from enlsip_tpu_torch.models.model import _solve_functions
    from enlsip_tpu_torch.problems.classic import chained_rosenbrock
    d = torch.float64
    model = et.CnlsModel(**chained_rosenbrock(n))
    fns = _solve_functions(model, d, "cuda")
    x0 = torch.as_tensor(model.starting_point, dtype=d, device="cuda")
    dims = et.Dims(n, 2 * n - 2, n - 2, n - 2)
    tols = et.Tols.for_dtype(d, "cuda")
    solve = lambda g: core_solve(fns, x0, dims, et.Options(
        second_derivatives=False), tols, dtype=d, graph=g)
    solve(False)
    _graph.warm_up("cuda")
    row = {"problem": f"chained_rosenbrock_{n}", "dtype": "float64",
           "static_inputs_bytes": _static_bytes(x0, tols)}
    emit({"graph_memory": measure(_graph, solve, row,
                                  trace=ARGS.trace == "float64:cr")})


def giant(et, core_solve, _graph):
    from enlsip_tpu_torch.problems.giant_m import giant_m
    trace = tuple(ARGS.trace.split(":")) if ARGS.trace else None
    for dt_name in ARGS.dtypes.split(","):
        dtype = getattr(torch, dt_name)
        gm = giant_m(ARGS.rows, GIANT_N, GIANT_L, seed=3, dtype=dtype)
        torch.cuda.synchronize()
        for config in ARGS.configs.split(","):
            factored, second, tall_qr = GIANT_CONFIGS[config]
            fns = gm.factored if factored else gm.dense
            opts = et.Options(second_derivatives=second, max_iter=8,
                              tall_qr=tall_qr)
            tols = et.Tols.for_dtype(dtype, "cuda")
            solve = lambda graph: core_solve(fns, gm.x0, gm.dims, opts, tols,
                                             dtype=dtype, graph=graph)
            row = {"config": config, "dtype": dt_name, "rows": gm.dims.m,
                   "static_inputs_bytes": _static_bytes(gm.x0, tols)}
            if second:
                row["newton_hessians_eager_GB"] = newton_hessians(fns, gm)
            row = measure(_graph, solve, row,
                          trace=trace == (dt_name, config))
            emit({"graph_memory": row})
            if row["outcome"] != "solved":
                return
        del gm
        _graph.clear_graph_cache()


def small(et, _graph):
    """Two graphs (one solve, one batch), each captured and replayed
    twice; x against the eager loop's."""
    import numpy as np
    from enlsip_tpu_torch.core.driver import Functions
    from enlsip_tpu_torch.core.driver import solve as core_solve
    from enlsip_tpu_torch.models.model import (_model_functions,
                                               _solve_functions)
    from enlsip_tpu_torch.parallel import solve_batched
    from enlsip_tpu_torch.problems.classic import HS65, chained_rosenbrock
    d = torch.float64
    model = et.CnlsModel(**chained_rosenbrock(40))
    fns = _solve_functions(model, d, "cuda")
    x0 = torch.as_tensor(model.starting_point, dtype=d, device="cuda")
    dims = et.Dims(40, 78, 38, 38)
    tols = et.Tols.for_dtype(d, "cuda")
    cr = lambda g: core_solve(fns, x0, dims, et.Options(
        second_derivatives=False), tols, dtype=d, graph=g)
    hm = et.CnlsModel(**HS65)
    hfns = Functions(*_model_functions(hm, d, "cuda"))
    rng = np.random.default_rng(0)
    starts = np.asarray(HS65["starting_point"])[None, :] \
        + 0.3 * rng.normal(size=(64, 3))
    hs = lambda g: solve_batched(hfns, starts, et.Dims(3, 3, 0, 7),
                                 et.Options(), et.Tols.for_dtype(d, "cuda"),
                                 dtype=d, graph=g)
    rows = []
    for name, run in (("cr40_float64", cr), ("hs65_x64_float64", hs)):
        eager = run(False)
        outs = [run(True) for _ in range(3)]     # capture, then 2 replays
        torch.cuda.synchronize()
        row = {"path": name, "x_bits_equal_eager": [
            bool(torch.equal(o.x, eager.x)) for o in outs]}
        if ARGS.profile:
            row["profile"] = profile_replays(lambda: run(True))
        rows.append(row)
        emit({"small": row})
    torch.cuda.synchronize()
    return rows


def _default_pool_reserved() -> int:
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) == (0, 0))


def pools_probe(et, core_solve, _graph):
    """Where a capture's allocations land.  (1) HS65's Newton terms
    (``hessian_contractions``: reverse over reverse AD, whose backward
    ops autograd runs on its device thread) captured in an IF body:
    the default pool's reserved bytes just before and just after them
    inside the capture (growth = blocks that left the graph's pools),
    then ``empty_cache()`` and two replays against the eager values.
    (2) The small problems of chip_smoke's ``small`` phase (second
    derivatives on), each captured, then ``empty_cache()`` and two
    replays, x against the first call's."""
    from enlsip_tpu_torch import _lanes
    from enlsip_tpu_torch.core.driver import Functions
    from enlsip_tpu_torch.core.subproblem import hessian_contractions
    from enlsip_tpu_torch.models.model import _model_functions
    from enlsip_tpu_torch.problems.classic import (HS65, OSBORNE2,
                                                   chained_wood)
    d = torch.float64
    fns = Functions(*_model_functions(et.CnlsModel(**HS65), d, "cuda"))
    x = torch.as_tensor(HS65["starting_point"], dtype=d, device="cuda")
    lam = torch.ones(7, dtype=d, device="cuda")
    rx = fns.res(x)
    hess = lambda x: hessian_contractions(fns.res, fns.cons, x, rx, lam)
    want = hess(x)
    inside = {}

    def fn(x):
        inside["before"] = _default_pool_reserved()
        out = _lanes.cond(x[0] == x[0], lambda: hess(x), lambda: hess(x))
        inside["after"] = _default_pool_reserved()
        return out

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    got = [_graph.run(("pools_probe",), fn, (x,), "cuda")]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    got += [_graph.run(("pools_probe",), None, (x,), "cuda")
            for _ in range(2)]
    torch.cuda.synchronize()
    emit({"pools_probe": {
        "case": "hessian_contractions in an IF body",
        "default_pool_growth_during_capture_bytes":
            inside["after"] - inside["before"],
        "replays_equal_eager": [all(torch.equal(a, b) for a, b in zip(g, want))
                                for g in got]}})
    _graph.clear_graph_cache()
    for name, kw, opts in (("hs65", HS65, {}), ("osborne2", OSBORNE2, {}),
                           ("chained_wood_20", chained_wood(20),
                            dict(rel_tol=1e-5, x_tol=1e-3, c_tol=1e-6))):
        models = [et.CnlsModel(**kw) for _ in range(3)]
        xs = []
        for i, model in enumerate(models):
            et.solve(model, dtype=d, **opts)
            torch.cuda.synchronize()
            if i == 0:
                torch.cuda.empty_cache()
            xs.append(et.solution(model))
        emit({"pools_probe": {"case": name, "x_equal_first_call": [
            bool((a == xs[0]).all()) for a in xs]}})
    _graph.clear_graph_cache()


def profile_replays(replay):
    from torch.profiler import ProfilerActivity, profile
    from enlsip_tpu_torch.utils import profiling
    # spans off under the profiler too, so that the replays are those of
    # the graph already captured (tracing is part of the graph's key; an
    # older ``--tree`` has no spans)
    enable = getattr(profiling, "enable", lambda flag: None)
    enable(False)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(2):
                replay()
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        enable(None)
    rows = [(e.key, getattr(e, "device_time_total", 0.0) or
             getattr(e, "cuda_time_total", 0.0), e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower()]
    total_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {"wall_seconds_under_profiler": wall,
            "device_kernel_ms": total_us / 1e3,
            "device_busy_share": total_us / 1e6 / wall if wall else None,
            "kernel_launches": sum(r[2] for r in rows),
            "top_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                            for k, us, n in rows[:8]]}


def main() -> None:
    global ARGS, OUT
    ARGS = _args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_graph_memory.py needs a CUDA device\n")
        sys.exit(1)
    sys.path.insert(0, os.path.abspath(ARGS.tree))
    os.makedirs("chiprun_out", exist_ok=True)
    OUT = os.path.join("chiprun_out", f"graph_memory_{ARGS.label}.jsonl")
    import enlsip_tpu_torch as et
    from enlsip_tpu_torch import _graph
    from enlsip_tpu_torch.core.driver import solve as core_solve
    import subprocess
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    emit({"device": {"nvidia_smi": smi, "torch": torch.__version__,
                     "cuda": torch.version.cuda,
                     "package": os.path.dirname(et.__file__),
                     "label": ARGS.label, "argv": sys.argv[1:]}})
    with torch.cuda.device(0):
        if ARGS.small:
            small(et, _graph)
        elif ARGS.pools_probe:
            pools_probe(et, core_solve, _graph)
        elif ARGS.chained:
            chained(et, core_solve, _graph, ARGS.chained)
        else:
            giant(et, core_solve, _graph)


if __name__ == "__main__":
    main()
