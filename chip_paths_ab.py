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
and ``giant_m``.  It prints one JSON line a DIR:
``{"tree": DIR, "batched_hs65": {...}, "batched_ode_fit": {...},
"giant_m": [...]}``, or ``{"tree": DIR, "rc": code}`` where that run
failed (the script then goes on, and exits 1 at the end).  Name each
tree twice in mirrored order (A B B A) to see how far the host's pace
drifts between runs.

It needs one CUDA device and ``nvcc``, and exits non-zero at once
without them.
"""

from __future__ import annotations

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
    out["giant_m"], _ = cs.solve_giant_m()
    print(json.dumps(out), flush=True)


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
