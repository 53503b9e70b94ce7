"""One run of one cell: set-up, the measured window, the traced calls,
the check of every answer against the plain reference, and the result.

Everything that belongs to a configuration, a traffic mix, a per-layer
metric or a cell's limits is a file found by its name in
``BENCHMARK.json`` (see the package docstring); this module holds only
what every cell shares.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import entries, generate, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "enlsip_tpu")
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """A module of the benchmark's data folders, loaded from its file
    (file names may hold dots, which an import cannot)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole (``enlsip_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


class Cell:
    """A workload of the manifest with its configuration, traffic, plain
    reference, limits and per-layer readers."""

    def __init__(self, workload: str, manifest_path: Path = ROOT / "BENCHMARK.json",
                 base: Path = HERE):
        self.manifest = load_json(manifest_path)
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in {manifest_path}")
        self.spec = cells[workload]
        self.name = workload
        cfg = self.spec["config"]
        self.config = load_json(base / "configs" / f"{cfg}.json")
        self.problem_module = load_module(base / "configs" / f"{cfg}.py",
                                          f"portbench_config_{cfg}")
        self.reference = load_module(base / "reference" / f"{cfg}.py",
                                     f"portbench_reference_{cfg}")
        self.traffic = load_json(base / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = load_json(base / "reference" / "limits" / f"{workload}.json")
        self.end_to_end = [m for m in self.manifest["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.readers = {m["name"]: load_module(
            base / "metrics" / f"{m['name']}.py",
            "portbench_metric_" + m["name"].replace(".", "_"))
            for m in self.per_layer}


class _Clock:
    """Times one call: CUDA events recorded on the caller's stream just
    before the call and just after it returns (the stream idle at both,
    so the pair spans the call on the card's clock), or the host clock on
    the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pairs = []

    def __enter__(self):
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            self.pairs.append([a, None])
        else:
            self.pairs.append([time.perf_counter(), None])
        return self

    def __exit__(self, *exc):
        if self.cuda:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            self.pairs[-1][1] = b
        else:
            self.pairs[-1][1] = time.perf_counter()
        return False

    def seconds(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) * 1e-3 for a, b in self.pairs]
        return [b - a for a, b in self.pairs]


def _collect(records):
    """Stack the answers of many calls into host arrays."""
    x = [torch.as_tensor(r["x"]) for r in records]
    f = [torch.as_tensor(r["f"]) for r in records]
    ok = [torch.as_tensor(r["ok"]) for r in records]
    return (torch.cat([t.double().cpu() for t in x]),
            torch.cat([t.double().cpu() for t in f]),
            torch.cat([t.bool().cpu() for t in ok]))


def _counts(record) -> dict:
    return {k: v for k, v in record.items() if k in ("iterations", "trips")}


class Session:
    """A cell set up once: kernels loaded, the problem built, the solve
    graph captured.  :meth:`run` measures one window on it and keeps each
    call's seconds and counts in ``calls``.

    ``dtype`` and ``sizes`` override the configuration's precision and
    the traffic's sizes (the control of the output check and the CPU
    tests); the benchmark's own runs leave them unset.  ``trace``: the
    session will be traced, so its profiler session opens before the
    capture (:class:`tracing.Profiler`)."""

    def __init__(self, cell: Cell, device="cuda", dtype: str = None,
                 sizes: dict = None, trace: bool = False):
        import enlsip_tpu_torch as et
        from enlsip_tpu_torch import _graph
        self.cell, self.dev = cell, torch.device(device)
        if self.dev.type == "cuda":
            from enlsip_tpu_torch.ops import _build
            _build.build_all()
        self.profiler = (tracing.Profiler(cuda=self.dev.type == "cuda")
                         if trace else None)
        self.dt = DTYPES[dtype or cell.config["dtype"]]
        tr = cell.traffic
        self.prob = cell.problem_module.problem(
            self.dt, self.dev, **{**tr.get("sizes", {}), **(sizes or {})})
        self.entry = entries.make(et, tr["entry"], self.prob, self.dt,
                                  self.dev, cell.config["options"],
                                  tr.get("lanes"))
        # the capturing call and one replay, from the documented start
        # (the same work whatever the seed)
        documented = generate.Starts(self.prob["x0"], 0.0, 0,
                                     tr.get("lanes")).documented()
        _graph.reset_graph_stats()
        for _ in range(2):
            self.entry.call(documented)
        self.capture_s = _graph.graph_stats()["capture_s"]

    def run(self, seed: int, seconds: float, trace: bool,
            t_process: float, log=sys.stderr) -> dict:
        from enlsip_tpu_torch import _device, _graph
        cell, dev, entry = self.cell, self.dev, self.entry
        tr = cell.traffic
        kind, lanes = entry.kind, entry.lanes
        starts = generate.Starts(self.prob["x0"], tr["start_noise"], seed,
                                 tr.get("lanes"), tr.get("pool"),
                                 tr.get("pool_seed", 0))
        captures0 = _graph.graph_stats()["captures"]

        # the measured window: one caller, closed loop
        clock = _Clock(dev)
        records = []
        rb0 = _device.readback_count()
        t0 = time.perf_counter()
        setup_s = t0 - t_process
        while True:
            x0 = starts.next()
            with clock:
                records.append(entry.call(x0))
            if time.perf_counter() - t0 >= seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        readbacks = _device.readback_count() - rb0
        captures_in_window = _graph.graph_stats()["captures"] - captures0
        call_s = clock.seconds()

        # the traced calls: k fresh starts under the profiler
        profiled, trace_obj = [], None
        if trace:
            xs = [starts.next() for _ in range(int(tr["traced_calls"]))]
            trace_obj = self.profiler.trace(
                lambda: profiled.extend(entry.call(x0) for x0 in xs))
        memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
        counts = [_counts(r) for r in records]
        traced_counts = [_counts(r) for r in profiled]

        # the check: every answer of the window and of the traced calls,
        # once the window has closed and the peak is read
        t_check = time.perf_counter()
        self.calls = list(zip(call_s, counts))
        X, F, OK = _collect(records + profiled)
        del records, profiled
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        from .reference.judge import judge
        got = judge(cell.reference, X, F, dev)
        readings = {k: float(got[k].max()) for k in ("f_gap", "c_viol",
                                                       "kkt")}
        checks = {k: {"value": v, "limit": cell.limits[k]}
                  for k, v in readings.items() if k in cell.limits}
        correct = bool(len(OK) > 0 and all(c["value"] <= c["limit"]
                                           for c in checks.values()))
        failed = int((~OK).sum())
        check_s = time.perf_counter() - t_check

        n_calls = len(call_s)
        e2e = {"setup_s": setup_s}
        if kind == "solve":
            e2e["solve_s"] = window_s / n_calls
        else:
            e2e["solves_per_s"] = lanes * n_calls / window_s

        result = {"correct": correct, "attempted": int(len(OK)),
                  "failed": failed}
        device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": 1, "memory_peak_bytes": int(memory_peak)}
        if dev.type == "cuda":
            from .work.peaks import power_limit_w
            device_info["power_limit_w"] = power_limit_w(dev.index or 0)
        if not trace:
            result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                             "unit": m["unit"]}
                                 for m in cell.end_to_end}
        else:
            # what a per-layer reader reads
            ctx = SimpleNamespace(
                problem=self.prob, entry=kind, lanes=lanes,
                itemsize=torch.empty(0, dtype=self.dt).element_size(),
                counts=counts, n_calls=n_calls, readbacks=readbacks,
                capture_s=self.capture_s, traced_counts=traced_counts,
                trace=trace_obj)
            metrics = {}
            for m in cell.per_layer:
                value = cell.readers[m["name"]].read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["metrics"] = metrics
            device_info["busy_s"] = trace_obj.busy_s()
            device_info["window_s"] = trace_obj.wall_s
            result["breakdown"] = {"device_ops": trace_obj.top_ops(),
                                   "idle_gaps": trace_obj.idle_gaps()}
        result["device"] = device_info
        result["window"] = {"calls": n_calls, "window_s": window_s,
                            "call_ms_by_quarter": [
                                1e3 * float(np.mean(part)) for part in
                                np.array_split(np.asarray(call_s), 4) if len(part)],
                            "call_ms_p95": 1e3 * float(np.percentile(call_s, 95)),
                            "captures": captures_in_window,
                            "dtype": str(self.dt).replace("torch.", ""),
                            "setup_s": setup_s, "check_s": check_s}
        result["checks"] = checks
        for k, c in checks.items():
            print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log)
        return result


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_process: float, device="cuda", dtype: str = None,
             sizes: dict = None, cell: Cell = None, log=sys.stderr) -> dict:
    """One run of ``workload``: set-up, then one window."""
    cell = cell or Cell(workload)
    session = Session(cell, device, dtype, sizes, trace)
    return session.run(seed, seconds, trace, t_process, log)
