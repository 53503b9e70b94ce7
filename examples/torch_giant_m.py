"""Giant-m on the PyTorch/CUDA port: millions of residual rows on one
card.  The twin of ``examples/giant_m.py``.

A 100-parameter data fit with the residual axis scaled to 2,000,000
rows and inequality constraints active at the solution.  The J2 panel
factorization takes the CholeskyQR tall path (``ops/tsqr.py``,
``Options.tall_qr`` default), the Jacobian is handed over factored as
diag(rowscale) @ W (``Functions.jac_rowscale`` / ``jac_base``: J is
never built, the fused WY kernel streams W with the scale applied), and
the line search evaluates its trials along cached rays
(``Functions.res_trial``: r(x) = phi(W x), so a trial is O(m)).  The
problem is ``problems/giant_m.py`` over this example's numpy draw.

Run on a machine with an NVIDIA GPU:
    python examples/torch_giant_m.py
or on the host, at a smaller size:
    python examples/torch_giant_m.py --device cpu --rows 20000
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
from enlsip_tpu_torch.core.driver import solve as core_solve
from enlsip_tpu_torch.core.types import Options, Tols
from enlsip_tpu_torch.problems.giant_m import giant_m_from_arrays

N, L = 100, 20


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the solve runs ('cpu' to run on the host)")
    ap.add_argument("--rows", type=int, default=2_000_000)
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)   # raises with no card
    M = args.rows

    rng = np.random.default_rng(0)
    W = rng.normal(size=(M, N)).astype(np.float32) / np.sqrt(N)
    xtrue = rng.normal(size=N).astype(np.float32)
    z = W @ xtrue
    Y = z + 0.1 * np.tanh(z) + 0.01 * rng.normal(size=M).astype(np.float32)
    blo = xtrue[:5] + 0.2        # cuts off the unconstrained optimum
    gm = giant_m_from_arrays(W, Y, xtrue, blo, L, dtype=torch.float32,
                             device=args.device)
    del W, Y, z

    opts = Options(second_derivatives=False, max_iter=30)
    tols = Tols.for_dtype(torch.float32, args.device)

    def solve():
        return core_solve(gm.factored, gm.x0, gm.dims, opts, tols,
                          dtype=torch.float32, device=args.device)

    solve()                          # the first call captures on the card
    t0 = time.perf_counter()
    res = solve()                    # its read-back waits for the card
    dt = time.perf_counter() - t0
    # constraints at their bound at the solution (float32: to 1e-4)
    active = int((gm.factored.cons(res.x) <= 1e-4).sum())
    print(f"{M:,} rows x {N} params, {L} constraints: "
          f"{res.n_iter} GN iterations in {dt:.2f} s "
          f"({res.n_iter / dt:.1f} iters/s), exit {res.exit_code}, "
          f"{active} active constraints, f = {res.f:.4f}")
    err = float(torch.linalg.norm(res.x - gm.xtrue)
                / torch.linalg.norm(gm.xtrue))
    print(f"parameter recovery ||x - x_true||/||x_true|| = {err:.3f} "
          f"(constrained: the first 5 coordinates sit at their bounds)")
    return res, active


if __name__ == "__main__":
    main()
