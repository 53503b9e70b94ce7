#!/usr/bin/env python3
"""The port's batched HS65, batched ODE-fit and giant-m paths, run from
several checkouts in one call, to compare them on one card.

    python3 chip_paths_ab.py DIR [DIR ...]

Each DIR holds a checkout's ``chip_smoke.py`` and ``enlsip_tpu_torch/``
(``.`` is the repository itself).  For each DIR, in the order given and
in a process of its own, the script builds that checkout's kernels (into
``DIR/build/``) and runs its ``chip_smoke.batched_hs65``,
``chip_smoke.batched_ode_fit`` and ``chip_smoke.solve_giant_m``, the
phases ``chip_smoke.py`` prints as ``batched_hs65``, ``batched_ode_fit``
and ``giant_m``.  Then, under ``bits``, it solves Chained Rosenbrock
n=1000 (float32, float64), HS65 x 4096 (float32) and the ODE fit x
10,000 (float32 and float64, every lane) by the checkout's eager loop
(``graph=False`` where the checkout has a device-resident one, which
is then run as well) and gives a SHA-256 of each result's x and exit
codes, the iterations or trips, and the ODE fit's missed lanes (f >=
1e-3): equal digests across checkouts are equal bits.  It prints one
JSON line a DIR: ``{"tree": DIR, "batched_hs65": {...},
"batched_ode_fit": {...}, "giant_m": [...], "bits": {...}}``, or
``{"tree": DIR, "rc": code}`` where that run failed (the script then
goes on, and exits 1 at the end).  Name each
tree twice in mirrored order (A B B A) to see how far the host's pace
drifts between runs.

It needs one CUDA device and ``nvcc``, and exits non-zero at once
without them.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import subprocess
import sys

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_paths_ab.py needs a CUDA device; none is available\n")
    sys.exit(1)


def run_tree(tree: str) -> None:
    root = os.path.abspath(tree)
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    cs._build.build_all()
    out = {"tree": tree, "batched_hs65": cs.batched_hs65(),
           "batched_ode_fit": cs.batched_ode_fit()}
    out["giant_m"] = cs.solve_giant_m()[0]
    out["bits"] = bits(cs)
    print(json.dumps(out), flush=True)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def bits(cs) -> dict:
    """Digests of the eager loop's results (and of the device-resident
    loop's, where the checkout has one) on the cases named above."""
    import numpy as np
    from enlsip_tpu_torch.core.driver import Functions, solve as core_solve
    from enlsip_tpu_torch.models.model import _model_functions
    from enlsip_tpu_torch.parallel import run_batch, solve_batched
    paths = {"eager": {"graph": False}, "graph": {}} \
        if "graph" in inspect.signature(core_solve).parameters \
        else {"eager": {}}
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = cs.et.CnlsModel(**cs.chained_rosenbrock(1000))
        fns = Functions(*_model_functions(model, dtype, cs.DEV))
        x0 = torch.as_tensor(model.starting_point, dtype=dtype, device=cs.DEV)
        for path, kw in paths.items():
            r = core_solve(fns, x0, cs.et.Dims(1000, 1998, 998, 998),
                           cs.et.Options(second_derivatives=False),
                           cs.et.Tols.for_dtype(dtype, cs.DEV), dtype=dtype,
                           **kw)
            out[f"cr1000_{str(dtype)[6:]}_{path}"] = {
                "x": _digest(r.x), "exit_code": r.exit_code,
                "iterations": r.n_iter}
    fns, starts = cs._hs65_batch(torch.float32, cs.HS65_LANES)
    cases = [("hs65_x4096_float32", fns, starts, cs.HS65_DIMS,
              cs.et.Options(), torch.float32, None)]
    ofns, ostarts, ys, oopts, _ = cs._ode_batch()
    for dtype in (torch.float32, torch.float64):
        cases.append((f"ode_fit_x10000_{str(dtype)[6:]}", ofns, ostarts,
                      cs.ODE_DIMS, oopts, dtype, ys))
    for name, fns, starts, dims, opts, dtype, data in cases:
        for path, kw in paths.items():
            extra = {} if data is None else {"data": data}
            r = solve_batched(fns, starts, dims, opts,
                              cs.et.Tols.for_dtype(dtype, cs.DEV),
                              dtype=dtype, **extra, **kw)
            row = {"x": _digest(r.x), "exit_codes": _digest(r.exit_code),
                   "trips": run_batch.last_trips}
            if data is not None:
                f = np.asarray(r.f.detach().cpu())
                row["missed_lanes"] = np.flatnonzero(~(f < 1e-3)).tolist()
            out[f"{name}_{path}"] = row
    return out


def main() -> None:
    if sys.argv[1:2] == ["--tree"]:
        run_tree(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    failed = []
    for tree in sys.argv[1:]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--tree", tree]).returncode
        if rc != 0:
            print(json.dumps({"tree": tree, "rc": rc}), flush=True)
            failed.append(tree)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
