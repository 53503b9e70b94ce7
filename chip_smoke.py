#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``; with no device it exits non-zero
at once and prints no result.  It builds the CUDA kernels from
``enlsip_tpu_torch/csrc`` (into ``build/``), holds every kernel against
its plain PyTorch version on the card at the shapes the main path gives
it, drives the main paths through the public entry points —
``solve(CnlsModel)`` on Chained Rosenbrock n=1000 at float32 and
float64, ``solve_batched`` on HS65 x 4096 lanes and on the ODE
parameter fit x 10,000 lanes with per-lane observations at float32, and
the giant-m solve (5,000,000 residual rows x 100 parameters x 50
constraints, float32) in the four configurations that reach the four
fused WY kernels —
solves three small problems that take the rank-deficient, subspace and
Newton branches, checks four float64 batch lanes against their single
solves, and prints one JSON object per line.  The last line is
``{"ok": true, "device": {...}}``.  Any failed check raises.

Lines of the giant-m slice: ``wy_kernel_cases`` holds each of the four
entry points of ``ops/wy_hopper.py`` against its plain version at every
listed shape in both dtypes (relative errors, equal bits of two launches,
kernel / plain / bound times); ``giant_m`` lists the four configurations
(a: factored hooks, no second derivatives; b: factored hooks, second
derivatives; c: dense Jacobian; d: dense, ``tall_qr="qr"``) with seconds
per solve, iterations, exit code, active constraints, launches of each
kernel, read-backs per iteration and peak device memory.

Lines of the B2 phase (the batched tiny-matrix CPQR): every row of the
``kernels`` line's B2 ``cases`` has the group size ``G`` (threads a
lane), ``bits_equal`` (two launches), the wrapper's call ``ms``, the
launch alone ``kernel_only_ms`` (both as the stream sees them) and the
launch's ``device_ms`` on the card; one case feeds the kernel
``A_act.transpose(-1, -2)`` as ``factor_active`` does; the fused
scenario batches' J2, A_act^T and L11 come with each lane zero past its
family's own dimensions (its zero columns must pivot after its live
ones); the ``batched_group_sweep`` line times every G at the main paths'
shapes and the gate's edge.

Lines of the B1 phase: every ``kernel_cases`` row names its ``route``
(each case runs through the resident and the stream route of
``ops/cpqr_hopper.py``; one oversized case goes through the dispatch to
the stream route); ``grid_barrier_us`` is the measured cost of one
grid-wide barrier (the resident kernel's own and cooperative-groups
``grid.sync()``) at the block counts tried; ``build`` carries what ptxas
reported for every kernel (registers, spill).

Lines of the scenario-suite slice (``parallel/suite.py``,
``parallel/hetero.py``, ``utils/checkpoint.py``; every batched
factorization there is B2): ``hs_suite`` solves the 28 HS problems from
their standard starts in ONE fused batch at float32 and float64 (matched,
misses, seconds, trips, B2 launches), then at float32 the mask-route
float64 escalation and the fused multistart (K = 32) of what is still
missed; ``hetero_suite`` (5 families x 512 lanes), ``hetero_100k``
(x 20,000) and ``hetero_newton`` (6 families with hs42, second
derivatives on; lanes that took a Newton step) time one fused float32
batch after a warm-up of 8 lanes a family (solves/s, match rate, trips,
read-backs and launches a trip, peak memory); ``hetero_lanes_equal_bucketed``
holds the fused float64 solve against one batch a family and
``checkpoint_resume`` a stopped, saved and resumed fused batch against
the uninterrupted one (to the bit).  No padded shape may reach the
batched factorization's plain version on the card
(``cpqr_batched_packed_plain.cuda_calls`` stays 0 over these phases).  ``batched_ode_fit``
lists the lanes that miss before and after escalation.

``--kernels-only`` stops after the kernel checks.  ``--profile`` adds
``profile`` lines: one float32 solve of each main path under
``torch.profiler``, with the device's busy share and the kernels that
take most of its time (for the batched solves also B2's time, calls
and share of the device time; ``profile_hetero_suite`` is the fused
five-family batch).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py needs a CUDA device; none is available\n")
    sys.exit(1)

import numpy as np

import enlsip_tpu_torch as et
from enlsip_tpu_torch import _device
from enlsip_tpu_torch.ops import _build
from enlsip_tpu_torch.ops.blocked_qr import (cpqr_packed_plain, q_apply,
                                             unpack_packed)
from enlsip_tpu_torch.core.driver import Functions
from enlsip_tpu_torch.core.driver import solve as core_solve
from enlsip_tpu_torch.models.model import (_model_functions,
                                           build_constraint_functions,
                                           total_nb_constraints)
from enlsip_tpu_torch.ops import cpqr_batched_hopper as cb
from enlsip_tpu_torch.ops.cpqr_batched_hopper import (
    cpqr_batched_packed, cpqr_batched_packed_plain, unpack_batched)
from enlsip_tpu_torch.ops import cpqr_hopper as cpqr_mod
from enlsip_tpu_torch.ops.cpqr_hopper import (cpqr_hopper, cpqr_hopper_resident,
                                              cpqr_hopper_stream,
                                              fits_resident)
from enlsip_tpu_torch.ops import wy_hopper as wy
from enlsip_tpu_torch.ops.blocked_qr import _panels, cpqr_blocked
from enlsip_tpu_torch.core.batched import lane_functions, lane_hessians
from enlsip_tpu_torch.parallel import (escalate_lanes_f64,
                                       finalize, fuse_families,
                                       hs_scenario_batch, init_batch,
                                       run_batch, solve_batched,
                                       solve_suite_batched, solve_suite_fused)
from enlsip_tpu_torch.problems import get_problem, ode_fit, problem_names
from enlsip_tpu_torch.utils import load_carry, save_carry
from enlsip_tpu_torch.problems.giant_m import giant_m
from enlsip_tpu_torch.problems.classic import (HS65, HS65_FSTAR, OSBORNE2,
                                               chained_rosenbrock,
                                               chained_wood)

DEV = torch.device("cuda")

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, no
# sparsity, at the 700 W limit) used for the bounds below.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,      # float32 outside the tensor cores
              torch.float64: 33.5e12}    # float64 outside the tensor cores
# Matrix products (the fused WY kernels' work) may use the float64 tensor
# cores, which double the float64 rate; float32 stays at the rate above
# (the tensor cores' TF32 is another type).
PEAK_MATMUL_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}

# Objective of Chained Rosenbrock n=1000 at the solution, recorded by
# running the JAX reference package (enlsip_tpu.solve, float64, CPU) on
# the same model; it exits found_first_order_stationary_point.
CR1000_FSTAR_REFERENCE = 6.232458632437989
# The float64 optimum of HS65 is well conditioned, but the last line
# search of a solve runs on a merit that is flat to rounding, and a
# batched and a single matrix product round differently in the last bit:
# x of a lane and of its single solve agree to this, not to the bit.
LANE_SINGLE_X_ATOL = 1e-7
# Objectives of the small problems, from the JAX reference package
# (float64, CPU): Osborne-2 with default tolerances, Chained Wood n=20
# with rel_tol=1e-5, x_tol=1e-3, c_tol=1e-6 (the reference's own pinned
# value, tests/test_problems.py).
OSBORNE2_FSTAR_REFERENCE = 0.4558771931598639
CHAINED_WOOD20_FSTAR = 474.2585640745832


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase(name, fn):
    """Run one phase, print its result as ``{name: result}`` with the
    phase's wall seconds beside it, and return the result (a tuple's
    first member is the printed part)."""
    t0 = time.time()
    out = fn()
    emit({name: out[0] if isinstance(out, tuple) else out,
          "phase_seconds": time.time() - t0})
    return out


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median time of ``fn`` on the card in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms: each run is enqueued behind a
    sleep kernel, so the events bracket the work on the card and not the
    host's time to enqueue it (which ``cuda_ms`` includes when the card
    would otherwise idle)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------- bounds

def cpqr_work(rows: int, cols: int, nsteps: int, itemsize: int):
    """(least bytes, flops, streamed bytes) of a CPQR with ``nsteps``
    steps.  Least bytes: the matrix read once and the packed result
    written once, plus tau and perm.  Flops: 2 per element for the first
    norms, then per step 2 (v^T B) + 2 (rank-1 update) + 2 (next norms)
    on the trailing block.  Streamed bytes: what a step-by-step
    factorization whose matrix does not fit on chip must move — two reads
    and one write of the trailing block every step."""
    kmax = min(rows, cols)
    least = 2 * rows * cols * itemsize + kmax * itemsize + cols * 4
    flops = 2 * rows * cols
    streamed = rows * cols * itemsize
    for k in range(nsteps):
        blk = (rows - k) * (cols - k - 1)
        flops += 6 * blk
        streamed += 3 * blk * itemsize
    return least, flops, streamed


def cpqr_bound(rows, cols, nsteps, dtype):
    least, flops, streamed = cpqr_work(rows, cols, nsteps,
                                       torch.empty(0, dtype=dtype).element_size())
    t_bytes = least / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            streamed / HBM_BYTES_PER_S * 1e3)


# --------------------------------------------------------- kernel checks

def _case_matrix(kind: str, rows: int, cols: int, live: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        M = rng.normal(size=(rows, cols))
    elif kind == "trailing_live":
        # the solver's J2 buffer: dead leading columns zeroed, the live
        # ones at the end
        M = rng.normal(size=(rows, cols))
        M[:, :cols - live] = 0.0
    elif kind == "leading_live":
        M = rng.normal(size=(rows, cols))
        M[:, live:] = 0.0
    elif kind == "graded":
        # orthonormal columns times a strictly decreasing geometric
        # scale, shuffled: the pivot order is unambiguous in float32
        Q, _ = np.linalg.qr(rng.normal(size=(rows, cols)))
        scale = 0.985 ** np.arange(cols)
        M = (Q * scale)[:, rng.permutation(cols)]
    else:
        raise ValueError(kind)
    return torch.tensor(np.ascontiguousarray(M), dtype=dtype,
                        device=DEV).contiguous()


KERNEL_CASES = [
    # name, kind, rows, cols, nsteps, on the main path
    ("A_act^T cr1000", "normal", 1000, 998, 998, True),
    ("J2 cr1000", "trailing_live", 1998, 1000, 2, True),
    ("1998x1000 full", "normal", 1998, 1000, 1000, False),
    ("ragged", "normal", 257, 193, 193, False),
    ("zero columns, short nsteps", "leading_live", 300, 220, 150, False),
    ("graded pivots", "graded", 1000, 998, 998, False),
]


B1_ROUTES = {"resident": cpqr_hopper_resident, "stream": cpqr_hopper_stream}
# Too large for the card's shared memory in either type (20 columns of
# 3000 rows a block on 132 SMs: 240 KB at float32): the dispatch must take
# the stream route.  Forty live columns, so that forty steps factor it whole.
OVERSIZED_CASE = ("oversized, via dispatch", "leading_live", 3000, 2600, 40)


def _hold_against_plain(name, kind, M, nsteps, got, plain):
    """Compare one packed factorization with the plain version's; returns
    the error figures and raises on a miss."""
    rows, cols = M.shape
    dtype = M.dtype
    Bt, tau, perm = got
    Pt, ptau, pperm = plain
    perm_equal = bool(torch.equal(perm, pperm))
    scale = float(Pt.abs().max())
    packed_err = float((Bt - Pt).abs().max()) / scale if perm_equal else None
    tau_err = float((tau - ptau).abs().max()) if perm_equal else None

    f = unpack_packed(Bt, tau, perm)
    RR = torch.zeros((rows, cols), dtype=dtype, device=DEV)
    RR[:min(rows, cols)] = f.R
    recon = float(torch.linalg.norm(q_apply(f, RR) - M[:, perm])
                  / torch.linalg.norm(M))
    d = f.diag[:nsteps].abs()
    rtol = 1e-9 if dtype == torch.float64 else 1e-4
    diag_sorted = bool(torch.all(d[1:] <= d[:-1] * (1 + 10 * rtol) + 1e-30))

    if dtype == torch.float64:
        # same arithmetic in another summation order: 1e-9 relative
        assert perm_equal, f"{name} f64: perm differs from the plain version"
        assert packed_err <= 1e-9 and tau_err <= 1e-9, (name, packed_err, tau_err)
        assert recon <= 1e-12, (name, recon)
    else:
        # float32 near-ties may flip a pivot on random input, so the
        # factorization is judged by what it reconstructs ...
        assert recon <= 1e-4, (name, recon)
        if kind == "graded":   # ... and by perm where the order is unambiguous
            assert perm_equal, f"{name} f32: perm differs on graded matrix"
    assert diag_sorted, f"{name}: |diag R| not non-increasing"
    assert bool(torch.isfinite(Bt).all())
    assert perm.dtype == torch.int64 and sorted(perm.tolist()) == list(range(cols))
    return {"perm_equal": perm_equal, "max_abs_err": packed_err,
            "tau_err": tau_err, "recon_rel_err": recon}


def check_kernel_case(name, kind, rows, cols, nsteps, dtype, main_path):
    """One case through BOTH hand-written routes (a row each), each held
    against the plain version, with equal bits of two launches; the
    dispatch must take the resident route (every case fits the card)."""
    M = _case_matrix(kind, rows, cols, nsteps, dtype, seed=rows + cols + nsteps)
    before = M.clone()
    plain = cpqr_packed_plain(M, nsteps)
    torch.cuda.synchronize()
    big = rows * cols >= 500_000
    plain_ms = cuda_ms(lambda: cpqr_packed_plain(M, nsteps),
                       reps=2 if big and nsteps > 100 else 3)
    bound_ms, bound_by, stream_ms = cpqr_bound(rows, cols, nsteps, dtype)
    cpqr_hopper(M, nsteps)
    assert cpqr_hopper.last_route == "resident", (name, cpqr_hopper.last_route)
    out = []
    for route, fn in B1_ROUTES.items():
        got, again = fn(M, nsteps), fn(M, nsteps)
        torch.cuda.synchronize()
        assert cpqr_hopper.last_route == route
        assert torch.equal(M, before), f"{name} {route}: the input was modified"
        bits_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        assert bits_equal, f"{name} {route}: two launches differ"
        errs = _hold_against_plain(f"{name} [{route}]", kind, M, nsteps, got,
                                   plain)
        # the 998-step resident case runs 50 times in a row: a lost wake-up
        # of its grid barrier would hang here, in the open
        reps = 50 if route == "resident" and main_path else 5 if big else 10
        ms = cuda_ms(lambda: fn(M, nsteps), reps=reps)
        out.append({"case": name, "route": route, "shape": [rows, cols],
                    "nsteps": nsteps, "dtype": str(dtype).replace("torch.", ""),
                    "main_path": main_path, "bits_equal": bits_equal, **errs,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "streamed_bytes_over_hbm_rate_ms": stream_ms,
                    "library_ms": None})
    return out


def check_oversized_case(dtype):
    """A matrix the gate turns away, through ``cpqr_hopper``: the dispatch
    takes the stream route, and the resident entry point raises."""
    name, kind, rows, cols, nsteps = OVERSIZED_CASE
    sms, shared, _ = cpqr_mod._device_limits(DEV)
    assert not fits_resident(rows, cols, dtype, sms, shared)
    M = _case_matrix(kind, rows, cols, nsteps, dtype, seed=rows + cols)
    got = cpqr_hopper(M, nsteps)
    torch.cuda.synchronize()
    assert cpqr_hopper.last_route == "stream", cpqr_hopper.last_route
    try:
        cpqr_hopper_resident(M, nsteps)
    except ValueError:
        pass
    else:
        raise AssertionError("the resident route took a matrix that does not fit")
    plain = cpqr_packed_plain(M, nsteps)
    errs = _hold_against_plain(name, kind, M, nsteps, got, plain)
    bound_ms, bound_by, stream_ms = cpqr_bound(rows, cols, nsteps, dtype)
    return {"case": name, "route": "stream", "shape": [rows, cols],
            "nsteps": nsteps, "dtype": str(dtype).replace("torch.", ""),
            "main_path": False, **errs,
            "ms": cuda_ms(lambda: cpqr_hopper(M, nsteps), reps=5),
            "plain_ms": cuda_ms(lambda: cpqr_packed_plain(M, nsteps), reps=2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "streamed_bytes_over_hbm_rate_ms": stream_ms, "library_ms": None}


def check_shared_memory_mirrors():
    """The wrappers size shared memory in Python (their gates are pure
    functions); the sources size it again for the launch.  Both must say
    the same."""
    clib, wlib = cpqr_mod._library(), wy._library()
    for rows, cols, blocks, itemsize in [(1000, 998, 132, 4), (1998, 1000, 132, 8),
                                         (257, 193, 64, 8), (300, 7, 7, 4)]:
        assert clib.cpqr_resident_shared_bytes(rows, cols, blocks, itemsize) == \
            cpqr_mod._resident_shared_bytes(rows, cols, blocks, itemsize)
    for n, k, dtype in [(100, 50, torch.float32), (100, 50, torch.float64),
                        (128, 128, torch.float32), (7, 3, torch.float64),
                        (32, 1, torch.float32), (16, 16, torch.float64)]:
        itemsize = torch.empty(0, dtype=dtype).element_size()
        for rb, stages in wy.TILINGS:
            assert wlib.wy_gram_shared_bytes(n, k, itemsize, rb, stages) == \
                wy._shared_bytes(n, k, dtype, rb, stages), (n, k, dtype, rb)
    blib = cb._library()
    for rows, cols in [(40, 10), (10, 20), (3, 7), (64, 32), (1, 2048),
                       (2048, 1), (33, 17)]:
        for itemsize, G in [(4, 1), (8, 2), (4, 4), (8, 8), (4, 16), (8, 32)]:
            for L in (1, 3, 32 // G):
                assert blib.cpqr_batched_shared_bytes(rows, cols, itemsize, G, L) \
                    == cb._shared_bytes(rows, cols, itemsize, G, L), \
                    (rows, cols, itemsize, G, L)


def resident_by_blocks():
    """The resident kernel on 132, 64 and 32 blocks at 1000 x 998 float32
    (998 steps): its time, and equal bits whatever the block count."""
    name, kind, rows, cols, nsteps, _ = KERNEL_CASES[0]
    M = _case_matrix(kind, rows, cols, nsteps, torch.float32,
                     seed=rows + cols + nsteps)
    sms = cpqr_mod._device_limits(DEV)[0]
    ref = cpqr_mod._resident(M, nsteps)
    out = {}
    for blocks in sorted({sms, 64, 32}, reverse=True):
        got = cpqr_mod._resident(M, nsteps, blocks)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
            f"resident kernel: {blocks} blocks give other bits than {sms}"
        out[str(blocks)] = cuda_ms(lambda: cpqr_mod._resident(M, nsteps, blocks),
                                   reps=10)
    return out


def grid_barrier_us():
    """Measured cost of one grid-wide barrier at 512 threads a block: the
    resident kernel's own arrive / wait pair on an L2 counter, and
    cooperative-groups ``grid.sync()``, by block count."""
    sms = cpqr_mod._device_limits(DEV)[0]
    counts = sorted({sms, 64, 32}, reverse=True)
    return {"own_counter": {str(b): cpqr_mod._barrier_probe_us(0, b)
                            for b in counts},
            "cooperative_groups": {str(b): cpqr_mod._barrier_probe_us(1, b)
                                   for b in counts}}


def l2_copy_rate():
    """Measured copy rate (GB/s, read + write) of a buffer that fits the
    L2 cache, as a yardstick for the streamed-bytes figure."""
    x = torch.empty(1_000_000, dtype=torch.float32, device=DEV)
    y = torch.empty_like(x)
    ms = cuda_ms(lambda: y.copy_(x), reps=50, warmup=5)
    return 2 * x.numel() * 4 / (ms * 1e-3) / 1e9


def check_kernels():
    cases = []
    for dtype in (torch.float64, torch.float32):
        for (name, kind, rows, cols, nsteps, main) in KERNEL_CASES:
            cases += check_kernel_case(name, kind, rows, cols, nsteps, dtype,
                                       main)
        cases.append(check_oversized_case(dtype))
    return cases


# ------------------------------------------- batched kernel (B2) checks

HS65_DIMS = et.Dims(n=3, m=3, q=0, l=7)
ODE_DIMS = et.Dims(n=ode_fit.N_PARAMS, m=ode_fit.N_POINTS, q=0,
                   l=2 * ode_fit.N_PARAMS)
HS65_LANES = 4096
ODE_LANES = 10_000
HETERO_FAMILIES = ["hs14", "hs65", "hs26", "hs53", "hs79"]
HETERO_NEWTON_FAMILIES = HETERO_FAMILIES + ["hs42"]
# the fused scenario batches of the suite phases: (phase, families, lanes
# a family)
FUSED_SETS = [("hs_suite", None, 1), ("hetero_suite", HETERO_FAMILIES, 512),
              ("hetero_100k", HETERO_FAMILIES, 20_000),
              ("hetero_newton", HETERO_NEWTON_FAMILIES, 512)]


@functools.lru_cache(maxsize=None)
def _fused_layouts():
    """B2's three shapes on each fused batch of the suite phases, with
    each lane's live block as the solver hands it over (its family's
    true n_f, m_f, l_f; zero rows and columns past them):

    * J2 (M, N): rows < m_f, columns in [rankA, n_f) (the columns below
      rankA are masked out, those >= n_f are parameters the family does
      not have);
    * A_act^T (N, L): rows < n_f, columns < t (t active constraints of
      l_f, t = 0 included);
    * L11 = R_A^T (L, ka): lower trapezoid, rows < t, columns
      < min(t, n_f).

    rankA and t are drawn per lane (numpy, seed 0).  Returns (name, B,
    rows, cols, live mask (B, rows, cols), "padded", True) rows."""
    rng = np.random.default_rng(0)
    out = []
    for phase_name, names, per in FUSED_SETS:
        fused = fuse_families(hs_scenario_batch(
            names or problem_names(), per_family=per, scale=0.0, device=DEV),
            device=DEV)
        d, B = fused.dims, int(fused.x0.shape[0])
        n, m, l = (getattr(fused.rdims, k).cpu().numpy()[:, None, None]
                   for k in ("n", "m", "l"))
        t = rng.integers(0, l + 1)
        rank_a = rng.integers(0, np.minimum(n, t) + 1)
        i = lambda size: np.arange(size)[None, :, None]
        j = lambda size: np.arange(size)[None, None, :]
        j2 = (i(d.m) < m) & (j(d.n) >= rank_a) & (j(d.n) < n)
        act = (i(d.n) < n) & (j(d.l) < t)
        l11 = (i(d.l) < t) & (j(d.ka) < np.minimum(t, n)) & \
            (j(d.ka) <= i(d.l))
        for shape, mask in (("J2", j2), ("A_act^T", act), ("L11", l11)):
            out.append((f"{shape} {phase_name} (padded)", B, *mask.shape[1:],
                        mask, "padded", True))
    return out


def batched_kernel_cases():
    """(name, B, rows, cols, live columns, kind, on the main path).  The
    main-path shapes are read off the problems' Dims: A_act^T is
    (n, l), J2 is (m, n); the fused suites' rows are
    :func:`_fused_layouts`'s."""
    h, o = HS65_DIMS, ODE_DIMS
    return [
        ("A_act^T hs65", HS65_LANES, h.n, h.l, 2, "leading_live", True),
        ("J2 hs65", HS65_LANES, h.m, h.n, 2, "trailing_live", True),
        ("A_act^T ode_fit", ODE_LANES, o.n, o.l, 4, "leading_live", True),
        # as factor_active hands it over: A_act.transpose(-1, -2), read in
        # place through its strides
        ("A_act^T ode_fit, transposed view", ODE_LANES, o.n, o.l, 4,
         "transposed_view", True),
        ("J2 ode_fit", ODE_LANES, o.m, o.n, o.n, "normal", True),
        ("10x10 square", ODE_LANES, 10, 10, 10, "normal", False),
        ("513 lanes, 9 live of 20", 513, 16, 20, 9, "leading_live", False),
        ("1100 lanes", 1100, 6, 5, 5, "normal", False),
        ("one lane", 1, 5, 5, 5, "normal", False),
        ("gate edge 64x32", 650, 64, 32, 32, "normal", False),
        ("all-zero lanes", 700, 8, 6, 6, "zero_lanes", False),
        ("graded pivots", 2048, 24, 12, 12, "graded", False),
        *_fused_layouts(),
    ]


def _batched_case_matrix(kind, B, rows, cols, live, dtype, seed):
    rng = np.random.default_rng(seed)
    if kind == "transposed_view":
        # A_act (B, l, n): rows past the live constraints are zero
        A_act = rng.normal(size=(B, cols, rows))
        A_act[:, live:, :] = 0.0
        return torch.tensor(A_act, dtype=dtype, device=DEV).transpose(-1, -2)
    M = rng.normal(size=(B, rows, cols))
    if kind == "padded":
        M = np.where(live, M, 0.0)
    elif kind == "leading_live":
        M[:, :, live:] = 0.0
    elif kind == "trailing_live":
        M[:, :, :cols - live] = 0.0
    elif kind == "zero_lanes":
        M[::3] = 0.0
    elif kind == "graded":
        Q, _ = np.linalg.qr(M)
        scale = 0.9 ** np.arange(cols)
        order = np.argsort(rng.random(size=(B, cols)), axis=1)
        M = np.take_along_axis(Q * scale, order[:, None, :], axis=2)
    return torch.tensor(M, dtype=dtype, device=DEV)


def cpqr_batched_bound(B, rows, cols, dtype):
    """Contract bound of one batch factorization: every matrix read once
    and its packed form written once, plus tau and perm, over the memory
    rate; 6 flops per trailing element per step over the peak rate."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    kmax = min(rows, cols)
    nbytes = 2 * B * rows * cols * itemsize + B * (kmax * itemsize + 4 * cols)
    flops = 6 * B * sum((rows - k) * (cols - k) for k in range(kmax))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_batched_kernel_case(name, B, rows, cols, live, kind, main_path,
                              dtype):
    M = _batched_case_matrix(kind, B, rows, cols, live, dtype,
                             seed=B + rows + cols)
    before = M.clone()
    packed, tau, perm = cpqr_batched_packed(M)
    torch.cuda.synchronize()
    assert torch.equal(M, before), f"{name}: the input was modified"
    pp, ptau, pperm = cpqr_batched_packed_plain(M)
    torch.cuda.synchronize()
    lane_equal = (perm == pperm).all(dim=1)
    perm_equal = bool(lane_equal.all())
    scale = max(float(pp.abs().max()), 1e-300)
    packed_err = float((packed - pp)[lane_equal].abs().max()) / scale \
        if bool(lane_equal.any()) else 0.0
    tau_err = float((tau - ptau)[lane_equal].abs().max()) \
        if bool(lane_equal.any()) else 0.0

    f = unpack_batched(packed, tau, perm)
    kmax = min(rows, cols)
    RR = torch.zeros((B, rows, cols), dtype=dtype, device=DEV)
    RR[:, :kmax] = f.R
    MP = torch.gather(M, 2, perm[:, None, :].expand(B, rows, cols))
    resid = torch.linalg.matrix_norm(q_apply(f, RR) - MP)
    mnorm = torch.linalg.matrix_norm(M)
    rtol = 1e-12 if dtype == torch.float64 else 1e-4
    # (an all-zero lane has resid = mnorm = 0 and counts as exact)
    rel = torch.where(mnorm > 0, resid / mnorm.clamp(min=1e-30), resid)
    recon = float(rel.max())
    assert bool((resid <= rtol * mnorm).all()), (name, recon)
    assert bool(torch.isfinite(packed).all()) and bool(torch.isfinite(tau).all())
    if dtype == torch.float64:
        # same arithmetic in another summation order: 1e-9 relative
        assert perm_equal, f"{name} f64: perm differs from the plain version"
        assert packed_err <= 1e-9 and tau_err <= 1e-9, (name, packed_err, tau_err)
    elif kind == "graded":
        assert perm_equal, f"{name} f32: perm differs on graded matrices"
    if kind == "padded":
        # a lane's zero rows and columns (padding, masked or inactive)
        # never lead a live column: its first min(live rows, live
        # columns) pivots are live columns
        live_col = torch.as_tensor(live.any(axis=1), device=DEV)
        k_live = torch.minimum(
            torch.as_tensor(live.any(axis=2).sum(axis=1), device=DEV),
            live_col.sum(dim=1))
        pivoted = torch.gather(live_col, 1, perm)
        steps = torch.arange(cols, device=DEV)
        dead = steps >= k_live[:, None]
        assert bool((pivoted | dead).all()), \
            f"{name}: a zero column was pivoted before a live one"
        # float32 ties between live columns may break the other way in
        # another summation order; where the live pivots agree, the zero
        # columns' ties (lowest index) give the whole perm
        live_equal = ((perm == pperm) | dead).all(dim=1)
        assert bool((lane_equal | ~live_equal).all()), \
            f"{name}: zero columns tied in another order"
        assert float(lane_equal.double().mean()) >= 0.999, name
    if kind == "zero_lanes":
        assert float(packed[::3].abs().max()) == 0.0
        assert float(tau[::3].abs().max()) == 0.0

    again = cpqr_batched_packed(M)
    torch.cuda.synchronize()
    bits_equal = all(torch.equal(x, y) for x, y in
                     zip((packed, tau, perm), again))
    assert bits_equal, f"{name}: two launches differ"

    # the wrapper's call and the launch alone (into preallocated outputs)
    # as the stream sees them, host time to enqueue included where the
    # card would otherwise idle; and the launch's time on the card alone
    ms = cuda_ms(lambda: cpqr_batched_packed(M), reps=20)
    plain_ms = cuda_ms(lambda: cpqr_batched_packed_plain(M), reps=3)
    outs = [torch.empty_like(x) for x in (packed, tau, perm)]
    kernel_only_ms = cuda_ms(lambda: cb.launch(M, *outs), reps=20)
    device = device_ms(lambda: cb.launch(M, *outs), reps=20)
    G = cb.group_size(rows, cols, dtype)
    L = cb.block_lanes(rows, cols, dtype, G)
    bound_ms, bound_by = cpqr_batched_bound(B, rows, cols, dtype)
    return {"case": name, "shape": [B, rows, cols],
            "live_columns": live if kind != "padded" else "per lane",
            "dtype": str(dtype).replace("torch.", ""), "main_path": main_path,
            "strides": list(M.stride()), "G": G, "lanes_per_block": L,
            "shared_bytes": cb._shared_bytes(rows, cols, M.element_size(), G, L),
            "bits_equal": bits_equal, "perm_equal": perm_equal,
            "perm_equal_share": float(lane_equal.double().mean()),
            "max_abs_err": packed_err, "tau_err": tau_err,
            "recon_rel_err": recon, "ms": ms, "kernel_only_ms": kernel_only_ms,
            "device_ms": device, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def check_batched_kernels():
    return [check_batched_kernel_case(*case, dtype)
            for dtype in (torch.float64, torch.float32)
            for case in batched_kernel_cases()]


def batched_group_sweep():
    """The launch's time on the card at every group size G (threads a
    lane) at the four main-path shapes and the gate's edge, both dtypes,
    each result held against the plain version (float64: perm equal,
    1e-9 relative; float32: perm equal on 99 % of lanes at least).
    ``chosen`` marks the G of ``group_size``."""
    out = []
    for name, B, rows, cols, live, kind, main in batched_kernel_cases():
        if not (main or name.startswith("gate edge")) or kind == "transposed_view":
            continue
        for dtype in (torch.float32, torch.float64):
            M = _batched_case_matrix(kind, B, rows, cols, live, dtype,
                                     seed=B + rows + cols)
            pp, ptau, pperm = cpqr_batched_packed_plain(M)
            chosen = cb.group_size(rows, cols, dtype)
            scale = max(float(pp.abs().max()), 1e-300)
            for G in (1, 2, 4, 8, 16, 32):
                L = cb.block_lanes(rows, cols, dtype, G)
                outs = [torch.empty_like(x) for x in (pp, ptau, pperm)]
                cb._launch(M, *outs, G, L)
                torch.cuda.synchronize()
                lane_equal = (outs[2] == pperm).all(dim=1)
                share = float(lane_equal.double().mean())
                err = float((outs[0] - pp)[lane_equal].abs().max()) / scale \
                    if share > 0 else None
                if dtype == torch.float64:
                    assert share == 1.0 and err <= 1e-9, (name, G, share, err)
                else:
                    assert share >= 0.99, (name, G, share)
                out.append({"case": name, "shape": [B, rows, cols],
                            "dtype": str(dtype).replace("torch.", ""), "G": G,
                            "lanes_per_block": L, "chosen": G == chosen,
                            "perm_equal_share": share, "max_abs_err": err,
                            "device_ms": device_ms(
                                lambda: cb._launch(M, *outs, G, L), reps=20)})
    return out


# ------------------------------------------ fused WY kernels (B3-B6)

GIANT_M, GIANT_N, GIANT_L = 5_000_000, 100, 50
# (name, m, n, k, on the main path)
WY_CASES = [
    ("giant-m main path", GIANT_M, GIANT_N, GIANT_L, True),
    ("2M x 100, k = 20", 2_000_000, 100, 20, False),
    ("8192 x 16, k = 5", 8192, 16, 5, False),
    ("ragged 4100 x 7, k = 3", 4100, 7, 3, False),
    ("k = 1", 65_537, 32, 1, False),
    ("k = n", 8192, 16, 16, False),
]
WY_NAMES = ["wy_right_apply", "wy_gram_project", "wy_gram_project_rowscale",
            "wy_gram_project_noapply"]
# relative to max |JQ1| for JQ1 and to the norms of G and p
WY_TOL = {torch.float64: {"JQ1": 1e-11, "G": 1e-11, "p": 1e-11},
          torch.float32: {"JQ1": 5e-6, "G": 2e-5, "p": 2e-5}}


def wy_bound(name, m, n, k, dtype):
    """Contract bound of one call: J (or the base) read once, JQ1 written
    once where there is one, rx, s, V, W read, G and p written, over the
    memory rate; 4 m n k operations for the two small products plus
    m n (n + 1) for the Gram (symmetric: one triangle with its diagonal)
    and 2 m n for the projection, over the peak rate of matrix products
    of the type."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    gram = name != "wy_right_apply"
    elems = m * n + 2 * n * k
    if name != "wy_gram_project_noapply":
        elems += m * n
    if gram:
        elems += m + n * n + n
    if "rowscale" in name or "noapply" in name:
        elems += m
    flops = 4 * m * n * k + (m * n * (n + 1) + 2 * m * n if gram else 0)
    t_bytes = elems * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_MATMUL_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _rel(got, want, norm=False):
    if norm:
        return float(torch.linalg.norm(got.double() - want)
                     / torch.linalg.norm(want))
    return float((got.double() - want).abs().max() / want.abs().max())


def check_wy_case(name, m, n, k, main_path, dtype):
    """The four entry points on one set of inputs.  The reference is the
    plain version in float64 (for float64 inputs: the plain version
    itself); the row scale has entries of both signs."""
    g = torch.Generator(device=DEV).manual_seed(m + n + k)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=DEV,
                                     dtype=dtype)
    J, rx, s = rnd(m, n), rnd(m), rnd(m) + 0.5
    f = cpqr_blocked(rnd(n, k).double(), device=DEV)
    V, T = (a.to(dtype).contiguous() for a in _panels(f)[0])
    d = torch.float64
    J64 = J.to(d)
    refs = {False: wy.wy_gram_project_plain(J64, V.to(d), T.to(d), rx.to(d)),
            True: wy.wy_gram_project_plain(J64, V.to(d), T.to(d), rx.to(d),
                                           s.to(d))}
    del J64
    calls = {
        "wy_right_apply": (lambda: (wy.wy_right_apply(J, V, T),),
                           lambda: (wy.wy_right_apply_plain(J, V, T),),
                           refs[False][:1], ("JQ1",)),
        "wy_gram_project": (lambda: wy.wy_gram_project(J, V, T, rx),
                            lambda: wy.wy_gram_project_plain(J, V, T, rx),
                            refs[False], ("JQ1", "G", "p")),
        "wy_gram_project_rowscale": (
            lambda: wy.wy_gram_project(J, V, T, rx, s),
            lambda: wy.wy_gram_project_plain(J, V, T, rx, s),
            refs[True], ("JQ1", "G", "p")),
        "wy_gram_project_noapply": (
            lambda: wy.wy_gram_project_noapply(J, V, T, rx, s),
            lambda: wy.wy_gram_project_noapply_plain(J, V, T, rx, s),
            refs[True][1:], ("G", "p")),
    }
    out = []
    reps = 3 if m * n >= 10 ** 8 else 10
    for kernel, (run, plain, want, parts) in calls.items():
        got, again = run(), run()
        torch.cuda.synchronize()
        bits_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = {part: _rel(gt, w, norm=part != "JQ1")
                for part, gt, w in zip(parts, got, want)}
        assert bits_equal, f"{kernel} {name}: two launches differ"
        if "G" in parts:
            G = got[parts.index("G")]
            assert torch.equal(G, G.T), f"{kernel} {name}: G is not symmetric"
        for part, e in errs.items():
            assert e <= WY_TOL[dtype][part], (kernel, name, str(dtype), part, e)
        assert all(bool(torch.isfinite(gt).all()) for gt in got)
        del got, again
        ms = cuda_ms(run, reps=reps)
        plain_ms = cuda_ms(plain, reps=reps)
        bound_ms, bound_by = wy_bound(kernel, m, n, k, dtype)
        out.append({"kernel": kernel, "case": name, "shape": [m, n, k],
                    "dtype": str(dtype).replace("torch.", ""),
                    "main_path": main_path, "bits_equal": bits_equal,
                    "G_symmetric_to_the_bit": True if "G" in parts else None,
                    "rel_err": errs, "max_abs_err": max(errs.values()),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})
    return out


def check_wy_kernels():
    cases = []
    for dtype in (torch.float64, torch.float32):
        for case in WY_CASES:
            cases += check_wy_case(*case, dtype)
            torch.cuda.empty_cache()
    return cases


# ----------------------------------------------------- giant-m main path

# name -> (factored hooks, second_derivatives, tall_qr, the kernel it reaches)
GIANT_CONFIGS = {
    "a": (True, False, "cholqr", "wy_gram_project_noapply"),
    "b": (True, True, "cholqr", "wy_gram_project_rowscale"),
    "c": (False, False, "cholqr", "wy_gram_project"),
    "d": (False, False, "qr", "wy_right_apply"),
}


def _giant_solve(gm, config, max_iter=8):
    factored, second, tall_qr, _ = GIANT_CONFIGS[config]
    last = {}
    res = core_solve(
        gm.factored if factored else gm.dense, gm.x0, gm.dims,
        et.Options(second_derivatives=second, max_iter=max_iter,
                   tall_qr=tall_qr),
        et.Tols.for_dtype(torch.float32, DEV), dtype=torch.float32,
        on_iteration=lambda c: last.update(mask=c.active_mask))
    torch.cuda.synchronize()
    return res, int(last["mask"].sum())


def solve_giant_m():
    """The giant-m problem of the reference benchmark (5,000,000 x 100,
    50 inequalities, float32, max_iter = 8, data drawn on the card) in
    the four configurations, each after one warm-up solve.  A
    configuration is solved three times (the host's clock varies between
    solves: the median and the range are kept), with every count set to
    0 just before each solve and read just after; the counts and the
    result kept are the last solve's."""
    torch.cuda.empty_cache()
    gm = giant_m(GIANT_M, GIANT_N, GIANT_L, seed=3, dtype=torch.float32)
    out, x_a = [], None
    for config, (factored, second, tall_qr, kernel) in GIANT_CONFIGS.items():
        _giant_solve(gm, config)                          # warm-up
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        for _ in range(3):
            wy.reset_launch_counts()
            cpqr_hopper.launches = 0
            _device.reset_readback_count()
            t0 = time.time()
            res, n_active = _giant_solve(gm, config)
            seconds.append(time.time() - t0)
            launches = wy.launch_counts()
            readbacks = _device.readback_count()
        x = res.x.double()
        row = {"config": config, "factored_hooks": factored,
               "second_derivatives": second, "tall_qr": tall_qr,
               "kernel": kernel,
               "seconds_per_solve": statistics.median(seconds),
               "seconds_per_solve_min": min(seconds),
               "seconds_per_solve_max": max(seconds),
               "iterations": res.n_iter, "exit_code": res.exit_code,
               "objective": res.f, "active_constraints": n_active,
               "launches": launches,
               "launches_per_iteration": launches[kernel] / max(res.n_iter, 1),
               "host_readbacks_per_iteration": readbacks / max(res.n_iter, 1),
               "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
               "max_abs_x_minus_blo": float(
                   (res.x[:5] - gm.blo).abs().max())}
        assert res.exit_code > 0, row
        assert bool(torch.isfinite(res.x).all()) and res.x.shape == (GIANT_N,)
        assert n_active >= 5 and row["max_abs_x_minus_blo"] <= 1e-3, row
        assert launches[kernel] > 0, row
        assert all(v == 0 for name, v in launches.items()
                   if name != kernel), row
        if x_a is None:
            x_a = x
        row["rel_dx_vs_a"] = float(torch.linalg.norm(x - x_a)
                                   / torch.linalg.norm(x_a))
        assert row["rel_dx_vs_a"] <= 1e-3, row
        out.append(row)
    return out, gm


def _wy_kernel_entries(wcases, giant):
    lines = {"wy_right_apply": 52, "wy_gram_project": 60,
             "wy_gram_project_rowscale": 86, "wy_gram_project_noapply": 118}
    by_kernel = {row["kernel"]: row for row in giant}
    entries = []
    for name in WY_NAMES:
        mine = [c for c in wcases if c["kernel"] == name]
        head = next(c for c in mine if c["main_path"]
                    and c["dtype"] == "float32")
        entries.append({
            "name": name, "route": "cuda",
            "source": "enlsip_tpu_torch/csrc/wy_gram.cu",
            "replaces": f"enlsip_tpu/ops/pallas_wy.py:{lines[name]}",
            "launches": by_kernel[name]["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "tolerance": "relative to max |JQ1| (JQ1) and to the norms of G "
                         "and p: float64 vs the plain version 1e-11; float32 "
                         "vs the plain version in float64 5e-6 (JQ1), 2e-5 "
                         "(G, p); two launches give equal bits",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "timed_at": "5000000 x 100, k = 50, float32 (the giant-m main "
                        "path); plain_ms is the chain of library matrix "
                        "products, not a single call",
            "cases": mine})
    return entries


# ------------------------------------------------------------ main path

def solve_cr1000(dtype):
    """One warm-up solve, then one timed solve with the launch and
    read-back counts set to 0 just before and read just after."""
    kw = chained_rosenbrock(1000)
    et.solve(et.CnlsModel(**kw), dtype=dtype)          # warm-up
    torch.cuda.synchronize()
    model = et.CnlsModel(**kw)
    cpqr_hopper.launches = 0
    _device.reset_readback_count()
    t0 = time.time()
    et.solve(model, dtype=dtype)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = cpqr_hopper.launches
    route = cpqr_hopper.last_route
    readbacks = _device.readback_count()
    iters = len(model.model_info.iterations_detail)
    name = str(dtype).replace("torch.", "")
    c_tol = float(np.sqrt(torch.finfo(dtype).eps))
    cmax = float(np.max(np.abs(et.equality_constraints_values(model))))
    f = et.sum_sq_residuals(model)
    rel = abs(f - CR1000_FSTAR_REFERENCE) / CR1000_FSTAR_REFERENCE
    assert et.status(model) == "found_first_order_stationary_point", \
        (name, et.status(model))
    assert np.all(np.isfinite(et.solution(model)))
    assert et.solution(model).shape == (1000,)
    assert cmax <= c_tol, (name, cmax, c_tol)
    assert rel <= (1e-3 if dtype == torch.float32 else 1e-6), (name, f, rel)
    assert launches >= 2 * iters, (name, launches, iters)
    return {"dtype": name, "status": et.status(model), "objective": f,
            "objective_rel_err_vs_reference": rel, "max_abs_c": cmax,
            "c_tol": c_tol, "iterations": iters, "seconds_per_solve": seconds,
            "cpqr_hopper_launches": launches, "cpqr_route": route,
            "launches_per_iteration": launches / iters,
            "host_readbacks": readbacks,
            "host_readbacks_per_iteration": readbacks / iters}


def solve_small():
    out = []
    cases = [
        ("hs65", HS65, {}, HS65_FSTAR, 1e-6),
        ("osborne2", OSBORNE2, {}, OSBORNE2_FSTAR_REFERENCE, 1e-6),
        ("chained_wood_20", chained_wood(20),
         dict(rel_tol=1e-5, x_tol=1e-3, c_tol=1e-6), CHAINED_WOOD20_FSTAR,
         1e-6),
    ]
    for name, kw, opts, fstar, rtol in cases:
        model = et.CnlsModel(**kw)
        t0 = time.time()
        et.solve(model, dtype=torch.float64, **opts)
        torch.cuda.synchronize()
        f = et.sum_sq_residuals(model)
        rel = abs(f - fstar) / abs(fstar)
        assert et.status(model) == "found_first_order_stationary_point", \
            (name, et.status(model))
        assert rel <= rtol, (name, f, fstar)
        first = time.time() - t0
        t0 = time.time()            # a second, warm solve of the same model
        et.solve(et.CnlsModel(**kw), dtype=torch.float64, **opts)
        torch.cuda.synchronize()
        out.append({"problem": name, "status": et.status(model),
                    "objective": f, "objective_rel_err": rel,
                    "iterations": len(model.model_info.iterations_detail),
                    "seconds_first_solve": first,
                    "seconds_warm_solve": time.time() - t0})
    return out


# -------------------------------------------------- batched main paths

def _hs65_batch(dtype, B, seed=0):
    """HS65 from B perturbed starts (0.3 N(0,1) about the standard
    start), as the JAX package's batched benchmark draws them."""
    model = et.CnlsModel(**HS65)
    fns = Functions(*_model_functions(model, dtype, DEV))
    rng = np.random.default_rng(seed)
    x0 = np.asarray(HS65["starting_point"])
    return fns, x0[None, :] + 0.3 * rng.normal(size=(B, 3))


def _timed_batch(solve, warmup=None):
    """Warm-up solve (``warmup`` if given, a smaller call of the same
    path), then one solve with every count set to 0 just before it and
    read just after."""
    (warmup or solve)()
    torch.cuda.synchronize()
    cpqr_batched_packed.launches = 0
    cpqr_hopper.launches = 0
    _device.reset_readback_count()
    t0 = time.time()
    res = solve()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    trips = run_batch.last_trips
    stats = {"seconds_per_batch_solve": seconds, "trips": trips,
             "cpqr_batched_launches": cpqr_batched_packed.launches,
             "launches_per_trip": cpqr_batched_packed.launches / max(trips, 1),
             "host_readbacks": _device.readback_count(),
             "host_readbacks_per_trip": _device.readback_count() / max(trips, 1)}
    assert stats["cpqr_batched_launches"] >= 2 * trips > 0, stats
    return res, stats


def _exit_code_counts(ec):
    codes, counts = np.unique(ec, return_counts=True)
    return {int(c): int(k) for c, k in zip(codes, counts)}


def batched_hs65():
    B, dtype = HS65_LANES, torch.float32
    fns, starts = _hs65_batch(dtype, B)
    tols = et.Tols.for_dtype(dtype, DEV)
    res, stats = _timed_batch(lambda: solve_batched(
        fns, starts, HS65_DIMS, et.Options(), tols, dtype=dtype))
    f = res.f.double().cpu().numpy()
    ec = res.exit_code.cpu().numpy()
    assert res.x.shape == (B, 3) and np.all(np.isfinite(f))
    matched = np.abs(f - HS65_FSTAR) < 1e-4
    share = float(np.mean(matched & (ec > 0)))
    assert share >= 0.99, (share, _exit_code_counts(ec))
    stats.update({"problem": "hs65", "lanes": B, "dtype": "float32",
                  "share_at_optimum_and_converged": share,
                  "share_at_optimum": float(np.mean(matched)),
                  "exit_codes": _exit_code_counts(ec),
                  "max_iterations": int(res.n_iter.max()),
                  "solves_per_second": B / stats["seconds_per_batch_solve"]})
    return stats


def _ode_batch():
    """The ODE fit x 10,000 lanes at float32: (functions, starts,
    per-lane observations, options, tolerances)."""
    model = et.CnlsModel(**ode_fit.model_kwargs())
    cons, jac = build_constraint_functions(model, DEV)
    assert total_nb_constraints(model) == ODE_DIMS.l
    fns = Functions(res=ode_fit.residuals_data,
                    jac_res=torch.func.jacfwd(ode_fit.residuals_data),
                    cons=lambda x, y: cons(x), jac_cons=lambda x, y: jac(x))
    return (fns, ode_fit.perturbed_starts(ODE_LANES),
            ode_fit.scenario_observations(ODE_LANES).astype(np.float32),
            et.Options(second_derivatives=False),
            et.Tols.for_dtype(torch.float32, DEV))


def batched_ode_fit():
    B, dtype = ODE_LANES, torch.float32
    fns, starts, ys, opts, tols = _ode_batch()
    res, stats = _timed_batch(lambda: solve_batched(
        fns, starts, ODE_DIMS, opts, tols, dtype=dtype, data=ys))
    f = res.f.double().cpu().numpy()
    ec = res.exit_code.cpu().numpy()
    assert res.x.shape == (B, ODE_DIMS.n)
    miss = ~(f < 1e-3)
    share = float(np.mean(~miss))
    assert share >= 0.99, (share, _exit_code_counts(ec[miss]))
    stats.update({"problem": "ode_fit", "lanes": B, "dtype": "float32",
                  "share_f_below_1e-3": share,
                  "share_f_below_1e-3_and_converged":
                      float(np.mean(~miss & (ec > 0))),
                  "exit_codes": _exit_code_counts(ec),
                  "miss_by_exit_code": _exit_code_counts(ec[miss]),
                  "missed_lanes": np.flatnonzero(miss).tolist(),
                  "solves_per_second": B / stats["seconds_per_batch_solve"]})
    # the lanes that missed or did not converge, re-solved at float64
    esc = miss | (ec <= 0)
    t0 = time.time()
    res_e = solve_batched(fns, starts, ODE_DIMS, opts, tols, dtype=dtype,
                          data=ys, escalate_mask=torch.as_tensor(esc))
    torch.cuda.synchronize()
    f_e = res_e.f.double().cpu().numpy()
    ec_e = res_e.exit_code.cpu().numpy()
    miss_e = ~(f_e < 1e-3)
    assert int(res_e.escalated.sum()) == int(esc.sum())
    stats["escalated"] = {
        "lanes": int(esc.sum()),
        "seconds_solve_plus_escalation": time.time() - t0,
        "share_f_below_1e-3": float(np.mean(~miss_e)),
        "share_f_below_1e-3_and_converged":
            float(np.mean(~miss_e & (ec_e > 0))),
        "miss_by_exit_code": _exit_code_counts(ec_e[miss_e]),
        "escalated_lanes": np.flatnonzero(esc).tolist(),
        "missed_lanes": np.flatnonzero(miss_e).tolist()}
    return stats


def batch_lanes_equal_single():
    """Four lanes of a float64 HS65 batch against ``core_solve`` from the
    same starts, both on the card."""
    dtype = torch.float64
    fns, starts = _hs65_batch(dtype, 8, seed=1)
    tols = et.Tols.for_dtype(dtype, DEV)
    res = solve_batched(fns, starts, HS65_DIMS, et.Options(), tols,
                        dtype=dtype)
    out = []
    for i in range(4):
        one = et.core_solve(fns, torch.tensor(starts[i]), HS65_DIMS,
                            et.Options(), tols, dtype=dtype)
        row = {"lane": i, "exit_code": int(res.exit_code[i]),
               "single_exit_code": one.exit_code,
               "n_iter": int(res.n_iter[i]), "single_n_iter": one.n_iter,
               "max_abs_dx": float((res.x[i] - one.x).abs().max()),
               "abs_df": abs(float(res.f[i]) - one.f)}
        assert row["exit_code"] == row["single_exit_code"], row
        assert row["n_iter"] == row["single_n_iter"], row
        assert row["max_abs_dx"] <= LANE_SINGLE_X_ATOL, row
        out.append(row)
    return out


# ------------------------------ scenario suites (HS suite, hetero batch)

HS_MISSES_REFERENCE = {"hs2", "hs13", "hs16", "hs27"}
HS_MATCH_RTOL = 1e-5


def _tols_fn(dtype):
    return et.Tols.for_dtype(dtype, DEV)


def _hs_hit(f, fstar):
    return abs(f - fstar) <= HS_MATCH_RTOL * (1 + abs(fstar))


def _hs_misses(per, fams):
    """Families whose first lane misses f* (``per`` from :func:`_split`)."""
    return sorted(n for n in per if not _hs_hit(float(per[n][0][0]),
                                                fams[n].fstar))


def _split(res, fused):
    """A fused BatchResult's lanes by family: {name: (f, exit code)}."""
    f = res.f.double().cpu().numpy()
    ec = res.exit_code.cpu().numpy()
    return {n: (f[sl], ec[sl]) for n, sl in fused.slices.items()}


def hs_suite():
    """The 28 HS problems from their standard starts in ONE fused batch
    (benchmarks/hs_suite_bench.py), float32 and float64; at float32 the
    mask-route float64 escalation of the misses and the non-converged
    lanes, then the fused multistart of what is still missed, scored as
    the reference scores it (a family matches if any converged lane hits
    f*)."""
    names = problem_names()
    fams = hs_scenario_batch(names, per_family=1, scale=0.0)
    fused = fuse_families(fams)
    solve = lambda dtype, opts=et.Options(): solve_batched(
        fused.fns, fused.x0, fused.dims, opts, _tols_fn(dtype), dtype=dtype,
        data=fused.data, rdims=fused.rdims)
    solve(torch.float32, et.Options(max_iter=2))     # the phase's warm-up
    rows = {}
    for dtype in (torch.float32, torch.float64):
        res, stats = _timed_batch(lambda: solve(dtype), warmup=lambda: None)
        assert res.x.shape == (len(names), fused.dims.n)
        assert bool(torch.all(torch.isfinite(res.x)))
        misses = _hs_misses(_split(res, fused), fams)
        name = str(dtype).replace("torch.", "")
        rows[name] = {"matched": len(names) - len(misses), "total": len(names),
                      "misses": misses,
                      "wall_seconds": stats["seconds_per_batch_solve"],
                      "trips": stats["trips"],
                      "cpqr_batched_launches": stats["cpqr_batched_launches"],
                      "host_readbacks": stats["host_readbacks"]}
        if dtype == torch.float32:
            res32, misses32 = res, misses
    assert set(rows["float64"]["misses"]) == HS_MISSES_REFERENCE, rows

    # mask-route escalation of the float32 misses and non-converged lanes
    lanes = res32.exit_code <= 0
    for n in misses32:
        lanes[fused.slices[n]] = True
    t0 = time.time()
    esc = escalate_lanes_f64(fused.fns, fused.x0, fused.dims, et.Options(),
                             res32, data=fused.data, rdims=fused.rdims,
                             mask=lanes)
    torch.cuda.synchronize()
    still = _hs_misses(_split(esc, fused), fams)
    rows["float32"].update({"escalated_lanes": int(lanes.sum()),
                            "escalation_seconds": time.time() - t0,
                            "matched_escalated": len(names) - len(still),
                            "misses_escalated": still})
    assert set(still) <= HS_MISSES_REFERENCE, rows
    if still:
        rows["float32"].update(_hs_multistart(still, len(names)))
        assert set(rows["float32"]["misses_multistart"]) <= \
            HS_MISSES_REFERENCE, rows
    return rows


def _hs_multistart(still, total, K=32):
    """K starts a family (lane 0 the standard start, the others at
    scale 1.0) in one fused float32 batch; families still missed have
    their lanes re-solved at float64."""
    fams = hs_scenario_batch(still, per_family=K, scale=1.0)
    for n in still:
        xb = fams[n].x0_batch.clone()
        xb[0] = torch.as_tensor(get_problem(n)[0]["starting_point"],
                                dtype=xb.dtype)
        fams[n] = fams[n]._replace(x0_batch=xb)
    fused = fuse_families(fams)
    t0 = time.time()
    res = solve_batched(fused.fns, fused.x0, fused.dims, et.Options(),
                        _tols_fn(torch.float32), dtype=torch.float32,
                        data=fused.data, rdims=fused.rdims)
    trips = run_batch.last_trips

    def any_hit(per):
        return [n for n in per if not any(
            (e > 0) and _hs_hit(f, fams[n].fstar) for f, e in zip(*per[n]))]

    misses = any_hit(_split(res, fused))
    if misses:
        mask = torch.zeros(fused.x0.shape[0], dtype=torch.bool)
        for n in misses:
            mask[fused.slices[n]] = True
        res = escalate_lanes_f64(fused.fns, fused.x0, fused.dims,
                                 et.Options(), res, data=fused.data,
                                 rdims=fused.rdims, mask=mask)
        misses = [n for n in any_hit(_split(res, fused)) if n in misses]
    torch.cuda.synchronize()
    return {"matched_multistart": total - len(misses),
            "misses_multistart": misses, "multistart_k": K,
            "multistart_lanes": int(fused.x0.shape[0]),
            "multistart_trips": trips,
            "multistart_seconds": time.time() - t0}


def _hetero_match(out, fams):
    """|f - f*| < 1e-3 max(1, |f*|) on every lane (bench.py's rule)."""
    hit = [np.abs(out[n].f.double().cpu().numpy() - fams[n].fstar)
           < 1e-3 * max(1.0, abs(fams[n].fstar)) for n in fams]
    return float(np.mean(np.concatenate(hit)))


def _hetero(names, per_family, second_derivatives=False):
    """One fused float32 batch of ``per_family`` perturbed starts of each
    family (seed 0), ``Options(max_iter=60)``, after a warm-up of 8 lanes
    a family and 2 iterations (the trips, not the lanes, cost the time:
    every trip is bound by the host)."""
    fams = hs_scenario_batch(names, per_family=per_family, seed=0)
    opts = et.Options(max_iter=60, second_derivatives=second_derivatives)
    fused = fuse_families(fams)
    warm = hs_scenario_batch(names, per_family=8, seed=1)
    warm_opts = dataclasses.replace(opts, max_iter=2)
    torch.cuda.reset_peak_memory_stats()
    out, stats = _timed_batch(
        lambda: solve_suite_fused(fams, opts, _tols_fn, dtype=torch.float32,
                                  fused=fused),
        warmup=lambda: solve_suite_fused(warm, warm_opts, _tols_fn,
                                         dtype=torch.float32))
    B = int(fused.x0.shape[0])
    for n in names:
        assert torch.all(torch.isfinite(out[n].x)), n
        assert torch.all(torch.isfinite(out[n].f)), n
    match = _hetero_match(out, fams)
    assert match >= 0.99, (names, match)
    codes = torch.cat([out[n].exit_code for n in names]).cpu().numpy()
    stats.update({"families": names, "lanes": B, "dtype": "float32",
                  "second_derivatives": second_derivatives,
                  "match_rate": match,
                  "solves_per_second": B / stats["seconds_per_batch_solve"],
                  "exit_codes": _exit_code_counts(codes),
                  "max_memory_allocated_GB":
                      torch.cuda.max_memory_allocated() / 1e9})
    return stats, fams, fused, opts


def hetero_suite():
    return _hetero(HETERO_FAMILIES, 512)


def hetero_100k():
    stats, *_ = _hetero(HETERO_FAMILIES, 20_000)
    return stats


def hetero_newton():
    """The six families with second derivatives on.  The lanes' Newton
    steps are read from a second run of the same batch through
    init_batch / run_batch (the carry holds them); the Hessian
    contractions of the union closures at the final points must be
    finite on every lane."""
    stats, fams, fused, opts = _hetero(HETERO_NEWTON_FAMILIES, 512, True)
    tols = _tols_fn(torch.float32)
    carry = init_batch(fused.fns, fused.x0, fused.dims, opts, torch.float32,
                       fused.data, fused.rdims)
    carry = run_batch(carry, fused.fns, fused.dims, opts, tols,
                      data=fused.data, rdims=fused.rdims)
    newton = carry.nb_newton_steps
    r = lane_functions(fused.fns, fused.data).res(carry.x)
    lam = torch.randn(carry.x.shape[0], fused.dims.l, dtype=torch.float32,
                      device=DEV, generator=torch.Generator(DEV).manual_seed(0))
    r_mat, c_mat = lane_hessians(fused.fns, fused.data)(carry.x, r, lam)
    finite = bool(torch.all(torch.isfinite(r_mat))) and \
        bool(torch.all(torch.isfinite(c_mat))) and \
        bool(torch.all(torch.isfinite(carry.x)))
    stats.update({"newton_lanes": int((newton > 0).sum()),
                  "newton_steps": int(newton.sum()),
                  "newton_lanes_by_family": {
                      n: int((newton[sl] > 0).sum())
                      for n, sl in fused.slices.items()},
                  "hessian_contractions_finite": finite})
    assert stats["newton_lanes"] > 0, stats
    assert finite, stats
    return stats


def hetero_lanes_equal_bucketed():
    """The robust families at float64, 8 lanes each: the fused solve
    against one batch a family (codes equal, x within 1e-7); one family
    alone fused equals its bucketed solve to the bit."""
    robust = ["hs14", "hs65", "hs26", "hs53"]
    fams = hs_scenario_batch(robust, per_family=8, seed=1)
    dt = torch.float64
    buck = solve_suite_batched(fams, et.Options(), _tols_fn, dtype=dt)
    fused = solve_suite_fused(fams, et.Options(), _tols_fn, dtype=dt)
    rows = {}
    for n in robust:
        b, f = buck[n], fused[n]
        rows[n] = {"codes_equal": bool(torch.equal(b.exit_code, f.exit_code)),
                   "max_abs_dx": float((b.x - f.x).abs().max()),
                   "max_n_iter_diff": int((b.n_iter - f.n_iter).abs().max())}
        assert rows[n]["codes_equal"] and rows[n]["max_abs_dx"] <= 1e-7, rows
    one = hs_scenario_batch(["hs42"], per_family=8, seed=1)
    b = solve_suite_batched(one, et.Options(), _tols_fn, dtype=dt)["hs42"]
    f = solve_suite_fused(one, et.Options(), _tols_fn, dtype=dt)["hs42"]
    bits = bool(torch.equal(b.x, f.x) and torch.equal(b.exit_code, f.exit_code)
                and torch.equal(b.n_iter, f.n_iter))
    rows["hs42_alone_bits_equal"] = bits
    assert bits, rows
    return rows


def checkpoint_resume():
    """A fused float32 batch (the five hetero families, 512 lanes each)
    run for 3 trips, saved, loaded and resumed, against the same batch
    run without a stop: x, f, exit codes and counters equal to the bit."""
    fams = hs_scenario_batch(HETERO_FAMILIES, per_family=512, seed=0)
    fused = fuse_families(fams)
    opts, dt = et.Options(max_iter=60, second_derivatives=False), \
        torch.float32
    tols = _tols_fn(dt)
    go = lambda c, k=None: run_batch(c, fused.fns, fused.dims, opts, tols,
                                     max_steps=k, data=fused.data,
                                     rdims=fused.rdims)
    start = lambda: init_batch(fused.fns, fused.x0, fused.dims, opts, dt,
                               fused.data, fused.rdims)
    whole = finalize(go(start()))
    mid = go(start(), 3)
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    path = str(_build.build_dir() / "checkpoint_resume.npz")
    save_carry(path, mid)
    resumed = finalize(go(load_carry(path, like=mid)))
    same = {"x": bool(torch.equal(whole.x, resumed.x)),
            "f": bool(torch.equal(whole.f, resumed.f)),
            "exit_code": bool(torch.equal(whole.exit_code,
                                          resumed.exit_code)),
            "n_iter": bool(torch.equal(whole.n_iter, resumed.n_iter)),
            "counters": all(bool(torch.equal(a, b)) for a, b in
                            zip(whole.counters, resumed.counters))}
    assert all(same.values()), same
    assert bool(torch.all(whole.exit_code != 0))
    return {"lanes": int(fused.x0.shape[0]), "stopped_after_trips": 3,
            "bits_equal": same}


def profile_solve(solve, kernel=None):
    """One warm solve under torch.profiler: wall seconds, the sum of
    device kernel time, the busy share, and the top kernels by name; with
    ``kernel``, also the time, calls and share of device time of the
    kernels whose name holds that string."""
    from torch.profiler import ProfilerActivity, profile
    solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        solve()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = [(e.key, getattr(e, "device_time_total", 0.0) or
             getattr(e, "cuda_time_total", 0.0), e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower()]
    total_us = sum(r[1] for r in rows)
    if total_us <= 0:
        return {"device_time": "not measured (the profiler saw no kernels)",
                "wall_seconds_under_profiler": wall}
    rows.sort(key=lambda r: -r[1])
    mine = {}
    if kernel is not None:
        hits = [r for r in rows if kernel in r[0]]
        mine = {kernel: {"ms": sum(r[1] for r in hits) / 1e3,
                         "calls": sum(r[2] for r in hits),
                         "share_of_device_time":
                             sum(r[1] for r in hits) / total_us}}
    return {**mine, "wall_seconds_under_profiler": wall,
            "device_kernel_ms": total_us / 1e3,
            "device_busy_share": total_us / 1e6 / wall,
            "kernel_launches": sum(r[2] for r in rows),
            "top_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                            for k, us, n in rows[:12]]}


def _batched_kernel_entry(bcases, launches, launches_by_path):
    head = next(c for c in bcases if c["case"] == "J2 ode_fit"
                and c["dtype"] == "float32")
    errs = [c["max_abs_err"] for c in bcases] + \
        [c["recon_rel_err"] for c in bcases if c["dtype"] == "float32"]
    return {
        "name": "cpqr_batched_packed", "route": "cuda",
        "source": "enlsip_tpu_torch/csrc/cpqr_batched.cu",
        "replaces": "enlsip_tpu/ops/pallas_batched_qr.py:43",
        "launches": launches, "launches_by_path": launches_by_path,
        "max_abs_err": max(errs),
        "tolerance": "float64: perm equal, packed R/tails/tau within 1e-9 "
                     "relative, ||QR - M[:,perm]|| <= 1e-12 ||M|| per lane; "
                     "float32: ||QR - M[:,perm]|| <= 1e-4 ||M|| per lane, "
                     "perm equal on the graded batch; two launches give "
                     "equal bits",
        "ms": head["ms"], "kernel_only_ms": head["kernel_only_ms"],
        "device_ms": head["device_ms"], "G": head["G"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "timed_at": "10000 x 40x10 float32 (J2 of the ODE fit); ms is the "
                    "wrapper's call (three output allocations and one "
                    "launch) and kernel_only_ms the launch alone, both as "
                    "the stream sees them (host time to enqueue included); "
                    "device_ms the launch's time on the card",
        "cases": bcases}


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"device": {"nvidia_smi": smi, "torch": torch.__version__,
                     "cuda": torch.version.cuda}})

    t0 = time.time()
    _build.build_all()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    emit({"build": {"seconds": time.time() - t0,
                    "sources": [f"{n}.cu" for n in sources],
                    "ptxas": {n: _build.resource_usage(n) for n in sources}}})

    check_shared_memory_mirrors()
    emit({"grid_barrier_us": grid_barrier_us()})
    cases = check_kernels()
    emit({"resident_ms_by_blocks_1000x998_f32": resident_by_blocks()})
    bcases = check_batched_kernels()
    emit({"batched_group_sweep": batched_group_sweep()})
    wcases = check_wy_kernels()
    emit({"wy_kernel_cases": wcases})
    l2_rate = l2_copy_rate()
    if "--kernels-only" in sys.argv:
        emit({"kernel_cases": cases, "batched_kernel_cases": bcases,
              "l2_copy_GBps": l2_rate})
        return

    solves = [solve_cr1000(torch.float32)]
    launches_main = solves[0]["cpqr_hopper_launches"]
    solves.append(solve_cr1000(torch.float64))
    emit({"solve": solves})
    emit({"small": solve_small()})
    hs65_stats = batched_hs65()
    emit({"batched_hs65": hs65_stats})
    ode_stats = batched_ode_fit()
    emit({"batched_ode_fit": ode_stats})
    emit({"batch_lanes_equal_single": batch_lanes_equal_single()})
    giant, gm = solve_giant_m()
    emit({"giant_m": giant})
    cpqr_batched_packed_plain.cuda_calls = 0
    hs_rows = phase("hs_suite", hs_suite)
    hetero_stats, hfams, hfused, hopts = phase("hetero_suite", hetero_suite)
    stats_100k = phase("hetero_100k", hetero_100k)
    newton_stats = phase("hetero_newton", hetero_newton)
    phase("hetero_lanes_equal_bucketed", hetero_lanes_equal_bucketed)
    phase("checkpoint_resume", checkpoint_resume)
    plain_calls = cpqr_batched_packed_plain.cuda_calls
    assert plain_calls == 0, \
        f"{plain_calls} batched factorizations took the plain version"
    if "--profile" in sys.argv:
        emit({"profile_giant_m_a": profile_solve(
            lambda: _giant_solve(gm, "a"))})
        kw = chained_rosenbrock(1000)
        emit({"profile": profile_solve(lambda: et.solve(
            et.CnlsModel(**kw), dtype=torch.float32))})
        fns, starts = _hs65_batch(torch.float32, HS65_LANES)
        tols = et.Tols.for_dtype(torch.float32, DEV)
        emit({"profile_batched_hs65": profile_solve(lambda: solve_batched(
            fns, starts, HS65_DIMS, et.Options(), tols,
            dtype=torch.float32), kernel="cpqr_batched_kernel")})
        fns, starts, ys, opts, tols = _ode_batch()
        emit({"profile_batched_ode_fit": profile_solve(
            lambda: solve_batched(fns, starts, ODE_DIMS, opts, tols,
                                  dtype=torch.float32, data=ys),
            kernel="cpqr_batched_kernel")})
        emit({"profile_hetero_suite": profile_solve(
            lambda: solve_suite_fused(hfams, hopts, _tols_fn,
                                      dtype=torch.float32, fused=hfused),
            kernel="cpqr_batched_kernel")})

    assert launches_main > 0, "the main path never launched cpqr_hopper"
    launches_by_path = {
        "batched_hs65": hs65_stats["cpqr_batched_launches"],
        "batched_ode_fit": ode_stats["cpqr_batched_launches"],
        "hs_suite_float32": hs_rows["float32"]["cpqr_batched_launches"],
        "hetero_suite": hetero_stats["cpqr_batched_launches"],
        "hetero_100k": stats_100k["cpqr_batched_launches"],
        "hetero_newton": newton_stats["cpqr_batched_launches"]}
    assert all(v > 0 for v in launches_by_path.values()), \
        ("a batched path never launched cpqr_batched_packed", launches_by_path)
    launches_batched = sum(launches_by_path.values())
    route_main = solves[0]["cpqr_route"]
    assert route_main == "resident", route_main
    head = next(c for c in cases
                if c["main_path"] and c["dtype"] == "float32"
                and c["nsteps"] == 998 and c["route"] == route_main)
    errs = [c["max_abs_err"] if c["max_abs_err"] is not None
            else c["recon_rel_err"] for c in cases]
    emit({"kernels": [{
        "name": "cpqr_hopper", "route": "cuda",
        "kernel_route": route_main,
        "source": "enlsip_tpu_torch/csrc/cpqr.cu",
        "replaces": "enlsip_tpu/ops/pallas_qr2.py:34",
        "launches": launches_main,
        "max_abs_err": max(errs),
        "tolerance": "both routes; float64: perm equal, packed R/tails/tau "
                     "within 1e-9 relative, ||QR - M[:,perm]|| <= 1e-12 ||M||; "
                     "float32: ||QR - M[:,perm]|| <= 1e-4 ||M||, perm equal on "
                     "the graded matrix; two launches give equal bits",
        "max_err": max(errs), "kernel_ms": head["ms"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "timed_at": "1000x998 float32, nsteps 998 (A_act^T of cr1000), by "
                    "the route the main path took (kernel_route)",
        "l2_copy_GBps": l2_rate,
        "cases": cases}, _batched_kernel_entry(bcases, launches_batched,
                                              launches_by_path),
        *_wy_kernel_entries(wcases, giant)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
