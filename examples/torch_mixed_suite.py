"""Mixed problem families in ONE fused batch, on the PyTorch/CUDA port.

Five Hock–Schittkowski CNLS problems with different dimensions (n 2–5,
m 2–4, q 0–3, l 1–13) solve together as a single batch: each family
pads to the maxima with inert residual/constraint rows, and per-lane
dimensions (RDims) select the live slice
(``enlsip_tpu_torch/parallel/hetero.py``).  The twin of
``examples/mixed_suite.py``.

Run on a machine with an NVIDIA GPU:
    python examples/torch_mixed_suite.py
or on the host, at a smaller size:
    python examples/torch_mixed_suite.py --device cpu --per-family 16
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

from enlsip_tpu_torch._device import resolve_device
from enlsip_tpu_torch.core.types import Options, Tols
from enlsip_tpu_torch.parallel import (fuse_families, hs_scenario_batch,
                                       solve_suite_fused)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the batch runs ('cpu' to run on the host)")
    ap.add_argument("--per-family", type=int, default=512)
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)   # raises with no card

    names = ["hs14", "hs65", "hs26", "hs53", "hs79"]
    fams = hs_scenario_batch(names, per_family=args.per_family, seed=0,
                             device=args.device)
    total = sum(f.x0_batch.shape[0] for f in fams.values())
    opts = Options(max_iter=60, second_derivatives=False)
    fused = fuse_families(fams, device=args.device)

    def tols(dtype):
        return Tols.for_dtype(dtype, args.device)

    def solve():
        out = solve_suite_fused(fams, opts, tols, dtype=torch.float32,
                                fused=fused, device=args.device)
        return {k: v.f.double().cpu().numpy() for k, v in out.items()}

    solve()                                   # warm-up
    t0 = time.perf_counter()
    fvals = solve()                           # the read-back waits for it
    dt = time.perf_counter() - t0

    print(f"{total} instances across {len(names)} families in one "
          f"batch: {total / dt:.0f} solves/s")
    shares = {}
    for name, fam in fams.items():
        f = fvals[name]
        ok = np.abs(f - fam.fstar) < 1e-3 * max(1.0, abs(fam.fstar))
        shares[name] = float(ok.mean())
        print(f"  {name:6s} (n={fam.dims.n}, m={fam.dims.m}, "
              f"q={fam.dims.q}, l={fam.dims.l}): "
              f"{100 * ok.mean():5.1f}% at published optimum "
              f"f* = {fam.fstar:.6g}")
    return shares


if __name__ == "__main__":
    main()
