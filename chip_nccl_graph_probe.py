#!/usr/bin/env python3
"""Can an NCCL all-reduce be captured inside a conditional node's body?

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_nccl_graph_probe.py

It starts one NCCL rank (a process group of one, joined through a file
under ``build/``), makes one eager all-reduce (the communicator is created
at the first collective), then captures with ``enlsip_tpu_torch._graph``
and replays, each held against the same arithmetic run eagerly:

* ``if``: one ``_dist.all_reduce`` in the body of an IF node, on a flag
  that holds and on one that does not;
* ``while``: a WHILE node whose flag an all-reduce in its body computes
  (a counter summed over the ranks until it reaches a bound);
* ``depth3``: an IF inside an IF inside a WHILE, the all-reduce in the
  innermost body and in the loop's flag;
* ``max``: the device form of ``mesh_any`` (an all-reduce with max) as
  the flag of a WHILE node.

Each case prints one JSON line (``ok``, the replays' values against the
eager ones, the exception if the capture or a replay was refused); then
an eager all-reduce after the replays, the card's name and power limit,
and a last line ``{"ok": ...}``.  Exits 1 when a case failed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_nccl_graph_probe.py needs a CUDA device\n")
    sys.exit(1)

from enlsip_tpu_torch import _dist, _graph, _lanes          # noqa: E402
from enlsip_tpu_torch.ops import _build                      # noqa: E402

DEV = torch.device("cuda")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def case_if(mesh):
    def fn(x):
        flag = x[0] > 0
        return _lanes.cond(flag, lambda: _dist.all_reduce(x * 2.0, mesh),
                           lambda: x - 1.0)
    return fn, [torch.arange(1.0, 5.0, device=DEV),
                -torch.arange(1.0, 5.0, device=DEV)]


def case_while(mesh):
    def fn(x):
        def go(s):
            return _dist.all_reduce(s[0], mesh) < 10.0

        def body(s):
            return (s[0] + 1.0, _dist.all_reduce(s[1] * 1.5, mesh))
        return _lanes.while_loop(go, body, (x[0], x[1:]))
    return fn, [torch.tensor([0.0, 1.0, 2.0], device=DEV),
                torch.tensor([7.0, 1.0, -1.0], device=DEV)]


def case_depth3(mesh):
    def fn(x):
        def go(s):
            return _dist.all_reduce(s[0], mesh) < 6.0

        def body(s):
            k, v = s

            def inner():
                return _lanes.cond(v[0] > -100.0,
                                   lambda: _dist.all_reduce(v + k, mesh),
                                   lambda: v)
            return k + 1.0, _lanes.cond(k >= 0.0, inner, lambda: v * 0.5)
        return _lanes.while_loop(go, body, (x[0], x[1:]))
    return fn, [torch.tensor([0.0, 1.0, 2.0], device=DEV),
                torch.tensor([3.0, -1.0, 5.0], device=DEV)]


def case_max(mesh):
    def fn(x):
        def go(s):
            glob, _ = _dist.mesh_flags(s > 0.0, mesh)
            return glob

        def body(s):
            return _dist.all_reduce(s - 1.0, mesh, "max")
        return _lanes.while_loop(go, body, x)
    return fn, [torch.tensor([3.0, -2.0, 1.0], device=DEV),
                torch.tensor([-1.0, -2.0, -3.0], device=DEV)]


CASES = {"if": case_if, "while": case_while, "depth3": case_depth3,
         "max": case_max}


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def run_case(name, make, mesh):
    fn, inputs = make(mesh)
    row = {"case": name}
    try:
        want = [[t.clone() for t in _flat(fn(x))] for x in inputs]
        got = []
        t0 = time.time()
        for x in inputs + inputs:
            out = _graph.run(("probe", name), fn, (x,), DEV)
            torch.cuda.synchronize()
            got.append([t.clone() for t in _flat(out)])
        row["seconds"] = time.time() - t0
        row["eager"] = [[t.tolist() for t in w] for w in want]
        row["replays"] = [[t.tolist() for t in g] for g in got]
        row["ok"] = all(all(torch.equal(a, b) for a, b in zip(g, w))
                        for g, w in zip(got, want + want))
        row["collectives_on_card"] = _graph.launches(_dist.all_reduce,
                                                     "collectives")
    except Exception as e:         # the probe reports every refusal
        row["ok"] = False
        row["error"] = f"{type(e).__name__}: {e}"
        row["traceback"] = traceback.format_exc()[-2000:]
    emit(row)
    return row["ok"]


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"versions": {"torch": torch.__version__, "cuda": torch.version.cuda,
                       "nccl": ".".join(map(str, torch.cuda.nccl.version()))}})
    _build.build_all(["graph_cond"])
    init = _build.build_dir() / f"probe_init_{time.time_ns()}"
    init.parent.mkdir(parents=True, exist_ok=True)
    _dist.init_process_group("nccl", f"file://{init}", 1, 0)
    mesh = _dist.make_mesh(axis="rows")
    _dist.all_reduce(torch.ones(4, device=DEV), mesh)
    torch.cuda.synchronize()
    ok = all([run_case(n, m, mesh) for n, m in CASES.items()])
    after = _dist.all_reduce(torch.full((3,), 2.0, device=DEV), mesh)
    emit({"eager_after_replays": after.tolist()})
    _graph.clear_graph_cache()
    torch.distributed.destroy_process_group()
    print(smi, flush=True)
    emit({"ok": ok})
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
