"""Multistart solving: one problem, K perturbed starts, one batch.

Counterpart of ``enlsip_tpu/parallel/multistart.py``.  The reference is
a single-start solver, so its outcome on problems with alternate
stationary points, degenerate constraints or divergent standard starts
is whatever that one trajectory produces.  The batched framework's
counter costs one batch: solve the SAME problem from K perturbed starts
as K lanes of :func:`~enlsip_tpu_torch.parallel.batch.solve_batched` and
keep the best converged lane.

Selection rule: "best" = lowest f among lanes with ``exit_code > 0``.
The termination lattice negates exit codes at infeasible points, so a
positive code is the solver's own feasible-convergence certificate.  On
problems whose active constraint is degenerate at the optimum,
tolerance-feasible lanes can report f marginally below the exact
constrained optimum — the best-lane f is "optimum as seen at the
solver's constraint tolerance", same as any single solve.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.driver import Functions
from ..core.types import Dims, Options, Tols
from .batch import BatchResult, solve_batched


class MultistartResult(NamedTuple):
    x: torch.Tensor           # (n,) best converged solution (or lane 0's x)
    f: torch.Tensor           # scalar ||r(x)||^2 of that lane
    exit_code: torch.Tensor   # its exit code
    n_converged: int          # lanes with exit_code > 0
    best_lane: int            # index into ``batch``
    batch: BatchResult        # all K lanes


def perturbed_starts(x0, K: int, scale: float = 1.0, seed: int = 0,
                     include_x0: bool = True) -> np.ndarray:
    """(K, n) starts: ``x0 + scale*(1+|x0|)*N(0,1)`` per coordinate;
    lane 0 is the unperturbed ``x0`` when ``include_x0`` so multistart
    never does worse than the single-start solve."""
    x0 = np.asarray(x0, float)
    rng = np.random.default_rng(seed)
    starts = x0[None, :] + scale * (1.0 + np.abs(x0))[None, :] * \
        rng.normal(size=(K, x0.shape[0]))
    if include_x0:
        starts[0] = x0
    return starts


def solve_multistart(fns: Functions, x0, dims: Dims, opts: Options,
                     tols: Tols, K: int = 32, scale: float = 1.0,
                     seed: int = 0, dtype=torch.float32,
                     escalate_f64: bool = False,
                     device=None) -> MultistartResult:
    """Solve one CNLS problem from K perturbed starts in ONE batch;
    return the best converged lane (plus all lanes).  Runs on ``device``
    (default: the card; raises if there is none).

    ``escalate_f64``: additionally re-solve non-converged lanes at
    float64 before selection — the right mode when float32 evaluation
    noise is the suspected cause of misses."""
    starts = perturbed_starts(x0, K, scale=scale, seed=seed)
    res = solve_batched(fns, starts, dims, opts, tols, dtype=dtype,
                        escalate_f64=escalate_f64, device=device)
    f = res.f.detach().cpu().numpy().astype(float)
    conv = res.exit_code.cpu().numpy() > 0
    if conv.any():
        best = int(np.flatnonzero(conv)[np.argmin(f[conv])])
    else:  # nothing converged: surface lane 0's (standard-start) outcome
        best = 0
    return MultistartResult(x=res.x[best], f=res.f[best],
                            exit_code=res.exit_code[best],
                            n_converged=int(conv.sum()), best_lane=best,
                            batch=res)
