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
float64 (and n = 5000, 100, 10), ``solve_batched`` on HS65 x 4096 lanes,
on Chained Rosenbrock n=1000 x 8 and n=10 x 1024 lanes and on the ODE
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
listed shape in both dtypes, and at float64 also at the edges of the
float64 kernel's tiling (relative errors, equal bits of two launches, G
symmetric to the bit, the tiling taken, kernel / plain / bound times);
the ``build`` line carries, beside ptxas' registers and spill, the count
of float64 tensor-core instructions (DMMA) in every kernel of
``wy_gram_f64.cu`` (the script fails if one has none or spills);
``giant_m`` lists the four configurations
(a: factored hooks, no second derivatives; b: factored hooks, second
derivatives; c: dense Jacobian; d: dense, ``tall_qr="qr"``) with seconds
per solve, iterations, exit code, active constraints, launches of each
kernel, read-backs per iteration and peak device memory.
``giant_m_float64`` solves the same problem at float64 and full width in
the four configurations through the eager loop and then on the captured
graph (one replay and one read-back a solve; seconds of three replays, the
capturing call's seconds, iterations, exit code, active constraints at the
solution, |x[:5] - blo|, ||x - x_a|| / ||x_a||, launches of each kernel
counted on the card at replay; the four memory figures: the eager loop's
peak, the capturing call's peak, the memory the cached graph holds and the
replay's peak) with (a)'s eager x, exit code and iterations equal to the
bit; it fails unless every exit code is > 0, >= 5 constraints are active
with x[:5] at blo to 1e-6, (b)-(d) are within 1e-9 of (a) and only the
configuration's kernel ran; its ``thin_qr`` entry times (d)'s thin QR
(``ops/tsqr.py::_householder_thin``) alone.  ``giant_m_float64_10m`` does
the same at 10,000,000 rows with one timed replay a configuration.

Every ``phase`` line carries ``graph_memory``: the phase's capturing calls
(each call of ``_graph.run`` that captured), with each one's peak
allocated and the memory its cached graph holds; rows name what a peak
covers (``capture_peak_GB``: the capturing call; ``replay_peak_GB``: a
replay, which allocates nothing and so counts live tensors only;
``eager_peak_GB``: the eager loop; ``graph_held_GB``: the cached graph's
pool).  The ``kernels`` line has a ``<name>_float64`` entry for each of
B3-B6 (source ``csrc/wy_gram_f64.cu``; times at 5,000,000 rows and
``at_200000_rows``; launches from ``giant_m_float64``).

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
(each case runs through the resident route of ``ops/cpqr_hopper.py``
against the exact-norm plain version and through its panel route against
the panel loop's plain version; one oversized case goes through the
dispatch to the panel route); ``grid_barrier_us`` is the measured cost of one
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
(``cpqr_blocked.cuda_rank1["lanes"]``, the batched rank-1 route's calls
on the card, stays 0 over these phases).  ``batched_ode_fit``
lists the lanes that miss before and after escalation.

Lines of the multi-device slice (``parallel/sharding.py``,
``parallel/rowsharded.py``): the card is one, so two gloo ranks share it
(correctness and collective counts, not scaling; each rank is a process
of this script started through ``torch.multiprocessing`` "spawn", joined
with a deadline) and one NCCL rank takes the NCCL path.
``sharded_hs65`` splits HS65 x 4096 over the ranks (float32, float64)
and holds the lanes against the one-process 4096-lane solve: exit codes
equal, float64 x within 1e-12, match share equal; trips equal on every
rank, B2 launched on every rank and never its plain version.
``sharded_hetero_suite`` does the same for the fused five-family batch
with ``mesh=`` (codes and match rate equal; float32).  The kernel checks
hold B2 and B3-B6 at the shard shapes these phases give them.
``rowsharded_giant_m`` solves the
giant-m problem with 2,500,000 rows a rank in configurations a-d
(iterations, exit code 10000 and active constraints equal to the one-card
solve, ||dx|| <= 1e-6 ||x||, each rank launching its configuration's WY
kernel and no other; collectives and read-backs an iteration, peak memory,
seconds), then ``tsqr=True`` on (c) and (a) at float64 on 200,000 rows
(||dx|| <= 1e-8 ||x||, iterations equal).  The gloo ranks run the eager
loops (``graph=False``: gloo moves the card's tensors through host
memory, which a graph cannot hold).  ``sharded_graph``: the NCCL rank
runs ``sharded_hs65`` (float32, float64), ``sharded_hetero_suite`` and
``rowsharded_giant_m`` (a)-(d) at 5,000,000 x 100 x 50 through the
captured graph (its first, capturing call and a replay) and the eager
loop on the same inputs: results equal to the bit (x, exit codes,
iterations, trips), one read-back a solve on the graph path, collectives
and B2 / B3-B6 launches counted on the card at replay, captures, capture
and wall seconds, peak memory.  The ``kernels`` line's B2
row counts the sharded paths' launches by rank and at the NCCL rank's
replays, and B3-B6 rows carry ``launches_rowsharded_by_rank`` and
``launches_rowsharded_graph_nccl_replay``.

Lines of the batches of large problems (``ops/blocked_qr.batched_route``:
a batch whose matrices have min(rows, cols) >= 192 runs B1 once a lane,
``ops/cpqr_hopper.cpqr_hopper_lanes``) and of the JAX bench's other
configurations: ``b1_panels`` holds B1 at Chained Rosenbrock
n=5000's A_act^T (5000 x 4998, 4998 steps) and J2 (9998 x 5000, 2 live
columns), float32 and float64, which the dispatch sends to the panel
route, against the panel loop's plain version (the tolerances of
``check_kernels``; two launches and two block counts give equal bits);
``b1_lanes`` holds the lane wrapper on 8 lanes of the batched cr1000
path's A_act^T (1000 x 998) and J2 (1998 x 1000, 2 steps a lane), and on
2 lanes of cr5000's J2 (the panel route), against single calls (equal
bits, both dtypes).  The ``kernels`` line has an entry of its own for the
panel kernel, ``cpqr_hopper_panels``, timed at cr5000's A_act^T float32,
its launches those of the cr5000 float32 solve.  ``batched_cr1000`` solves Chained Rosenbrock n=1000
on 8 lanes (starts x0 + 0.1 N(0, 1), numpy seed 0) at float32 and
float64 on the captured graph: seconds a batch, trips, read-backs (<= 2),
B1's lane launches by route, the capture's and the replay's peak memory,
x equal to the eager loop's to the bit, each lane's exit class equal to
its own ``et.solve`` and f within 1e-3 / 1e-9 relative.
``solve_cr5000`` solves n=5000 at float32 (``matmul_precision``
"float32" and "bfloat16") and float64: first-order stationary, max |c|
<= c_tol, B1 on the panel route, float32 within 1e-3 of float64, the
float64 objective within 1e-12 of the n=1000 reference value.  ``small_n``: single
float32 solves at n = 10 and 100 (one read-back each) and n = 10 on 1024
lanes (seconds a solve; every lane converged).  ``examples`` runs each
``examples/torch_*.py`` at its default size.  Every ``phase`` line
carries ``rank1_calls_on_card``, the rank-1 routes' calls on the card in
that phase (batched and single), and the run fails if the batched one is
not 0 in any phase, or the single one in ``solve``, ``batched_cr1000``
and ``solve_cr5000``.

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
import os
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
from enlsip_tpu_torch import _device, _dist, _graph, _lanes
from enlsip_tpu_torch.ops import _build
from enlsip_tpu_torch.ops.blocked_qr import (cpqr_packed_plain,
                                             cpqr_panels_packed_plain,
                                             q_apply, unpack_packed)
from enlsip_tpu_torch.core.driver import Functions
from enlsip_tpu_torch.core.driver import solve as core_solve
from enlsip_tpu_torch.models.model import (_model_functions,
                                           _solve_functions,
                                           build_constraint_functions,
                                           total_nb_constraints)
from enlsip_tpu_torch.ops import cpqr_batched_hopper as cb
from enlsip_tpu_torch.ops.cpqr_batched_hopper import (
    cpqr_batched_packed, cpqr_batched_packed_plain, unpack_batched)
from enlsip_tpu_torch.ops import cpqr_hopper as cpqr_mod
from enlsip_tpu_torch.ops.cpqr_hopper import (b1_route, cpqr_hopper,
                                              cpqr_hopper_lanes,
                                              cpqr_hopper_panels,
                                              cpqr_hopper_resident,
                                              fits_resident)
from enlsip_tpu_torch.ops import wy_hopper as wy
from enlsip_tpu_torch.ops.blocked_qr import _panels, cpqr_blocked
from enlsip_tpu_torch.ops.tsqr import _householder_thin
from enlsip_tpu_torch.core.batched import lane_functions, lane_hessians
from enlsip_tpu_torch.parallel import (batch_mesh, escalate_lanes_f64,
                                       finalize, fuse_families,
                                       hs_scenario_batch, init_batch,
                                       row_mesh, run_batch, solve_batched,
                                       solve_batched_sharded,
                                       solve_rowsharded,
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


def reset_launch_counts() -> None:
    """Every kernel's launch count to 0: the wrappers' own integers
    (launches made now) and the device counters (launches that replays
    of captured graphs make)."""
    cpqr_hopper.launches = cpqr_hopper_panels.launches = 0
    cpqr_hopper_lanes.launches = cpqr_hopper_lanes.panel_launches = 0
    cpqr_batched_packed.launches = 0
    wy.reset_launch_counts()          # the WY counts and every device slot


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# phases in which a rank-1 route ran on the card where it must not:
# (phase, its counts), asserted before the kernels line
RANK1_FAULTS = []

# the capturing calls of the phase in progress, as track_captures
# measures them
CAPTURES = []


def track_captures() -> None:
    """Measure every call of ``_graph.run`` that captures a graph (its
    key not yet cached): the capturing call's peak allocated (the eager
    warm-up, the capture and the first replay; the peak counter is reset
    at the call's start) and the memory its cached graph holds
    (``memory_reserved()`` after the call and an ``empty_cache()``, less
    the same before it), appended to ``CAPTURES``.  A replay is not
    touched.  The replay's own peak, which counts live tensors only (a
    replay allocates nothing: its blocks are the graph's), is what the
    rows call ``replay_peak_GB``."""
    run = _graph.run

    @functools.wraps(run)
    def tracked(key, fn, inputs, device, warm=None):
        dev = torch.device(device)
        if dev.type != "cuda" or _graph.cached(key, dev):
            return run(key, fn, inputs, device, warm)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = run(key, fn, inputs, device, warm)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
        CAPTURES.append({
            "capture_peak_GB": peak / 1e9,
            "graph_held_GB": (torch.cuda.memory_reserved(dev) - reserved)
            / 1e9})
        return out

    _graph.run = tracked


def captures_summary(captures) -> dict:
    """A phase's capturing calls: their count, the largest capturing-call
    peak and held memory, and (the first 12) each call's figures."""
    return {"captures": len(captures),
            "capture_peak_GB_max": max(
                (c["capture_peak_GB"] for c in captures), default=None),
            "graph_held_GB_max": max(
                (c["graph_held_GB"] for c in captures), default=None),
            "each": captures[:12]}


def phase(name, fn, hold=("lanes",)):
    """Run one phase, print its result as ``{name: result}`` with the
    phase's wall seconds, the rank-1 routes' calls on the card in it
    (``cpqr_blocked.cuda_rank1``, the only factorizations in which the
    card runs a plain PyTorch loop) and its capturing calls' memory
    (``graph_memory``, :func:`track_captures`), and return the result (a tuple's
    first member is the printed part).  The counts named in ``hold`` must
    be 0: by default the batched one ("lanes"), since every batch of the
    smoke fits the batched kernel's gate or takes B1 a lane; "single" too
    where every factorization has 192 pivots or more."""
    _graph.clear_graph_cache()    # a phase's graphs hold their pools
    reset_rank1_calls()
    CAPTURES.clear()
    t0 = time.time()
    out = fn()
    calls = dict(cpqr_blocked.cuda_rank1)
    emit({name: out[0] if isinstance(out, tuple) else out,
          "phase_seconds": time.time() - t0, "rank1_calls_on_card": calls,
          "graph_memory": captures_summary(CAPTURES)})
    if any(calls[k] for k in hold):
        RANK1_FAULTS.append((name, calls))
    return out


def reset_rank1_calls() -> None:
    for k in cpqr_blocked.cuda_rank1:
        cpqr_blocked.cuda_rank1[k] = 0


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


# B1's routes, each with the plain version it is held against: exact norms
# (the resident route, the Pallas kernel's function) and the JAX package's
# panel loop with downdated norms (the panel route)
B1_ROUTES = {"resident": (cpqr_hopper_resident, cpqr_packed_plain),
             "panels": (cpqr_hopper_panels, cpqr_panels_packed_plain)}
# Too large for the card's shared memory in either type (20 columns of
# 3000 rows a block on 132 SMs: 240 KB at float32): the dispatch must take
# the panel route.  Forty live columns, so that forty steps factor it whole.
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
    against its plain version, with equal bits of two launches; the
    dispatch must take the resident route (every case fits the card)."""
    M = _case_matrix(kind, rows, cols, nsteps, dtype, seed=rows + cols + nsteps)
    before = M.clone()
    big = rows * cols >= 500_000
    bound_ms, bound_by, stream_ms = cpqr_bound(rows, cols, nsteps, dtype)
    cpqr_hopper(M, nsteps)
    assert cpqr_hopper.last_route == "resident", (name, cpqr_hopper.last_route)
    out = []
    for route, (fn, plain_fn) in B1_ROUTES.items():
        plain = plain_fn(M, nsteps)
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: plain_fn(M, nsteps),
                           reps=2 if big and nsteps > 100 else 3)
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
    takes the panel route, and the resident entry point raises."""
    name, kind, rows, cols, nsteps = OVERSIZED_CASE
    sms, shared, coop = cpqr_mod._device_limits(DEV)
    assert not fits_resident(rows, cols, dtype, sms, shared)
    assert b1_route(rows, cols, dtype, sms, shared, coop) == "panels"
    M = _case_matrix(kind, rows, cols, nsteps, dtype, seed=rows + cols)
    got = cpqr_hopper(M, nsteps)
    torch.cuda.synchronize()
    assert cpqr_hopper.last_route == "panels", cpqr_hopper.last_route
    try:
        cpqr_hopper_resident(M, nsteps)
    except ValueError:
        pass
    else:
        raise AssertionError("the resident route took a matrix that does not fit")
    plain = cpqr_panels_packed_plain(M, nsteps)
    errs = _hold_against_plain(name, kind, M, nsteps, got, plain)
    bound_ms, bound_by, stream_ms = cpqr_bound(rows, cols, nsteps, dtype)
    return {"case": name, "route": "panels", "shape": [rows, cols],
            "nsteps": nsteps, "dtype": str(dtype).replace("torch.", ""),
            "main_path": False, **errs,
            "ms": cuda_ms(lambda: cpqr_hopper(M, nsteps), reps=5),
            "plain_ms": cuda_ms(lambda: cpqr_panels_packed_plain(M, nsteps),
                                reps=2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "streamed_bytes_over_hbm_rate_ms": stream_ms, "library_ms": None}


def check_shared_memory_mirrors():
    """The wrappers size shared memory in Python (their gates are pure
    functions); the sources size it again for the launch.  Both must say
    the same."""
    clib, wlib = cpqr_mod._library(), wy._library()
    plib = cpqr_mod._panels_library()
    for rows, cols, blocks, itemsize in [(1000, 998, 132, 4), (1998, 1000, 132, 8),
                                         (257, 193, 64, 8), (300, 7, 7, 4),
                                         (5000, 4998, 132, 8), (9998, 5000, 132, 4)]:
        assert clib.cpqr_resident_shared_bytes(rows, cols, blocks, itemsize) == \
            cpqr_mod._resident_shared_bytes(rows, cols, blocks, itemsize)
        nb = cpqr_mod.panel_width(min(rows, cols))[0]
        assert plib.cpqr_panels_shared_bytes(rows, cols, blocks, nb, itemsize) == \
            cpqr_mod._panels_shared_bytes(rows, cols, blocks, nb, itemsize)
    # each dtype's kernel against its own layout's mirror; the float32
    # layout sized at float64 against the gate's admission rule
    for n, k, dtype in [(100, 50, torch.float32), (100, 50, torch.float64),
                        (128, 128, torch.float32), (7, 3, torch.float64),
                        (32, 1, torch.float32), (16, 16, torch.float64),
                        (128, 64, torch.float64), (128, 84, torch.float64),
                        (100, 100, torch.float64), (13, 13, torch.float64)]:
        itemsize = torch.empty(0, dtype=dtype).element_size()
        lib = wy._library(dtype)
        for rb, stages in (wy.TILINGS_F64 if dtype == torch.float64
                           else wy.TILINGS):
            assert lib.wy_gram_shared_bytes(n, k, itemsize, rb, stages) == \
                wy._shared_bytes(n, k, dtype, rb, stages), (n, k, dtype, rb)
        for rb, stages in wy.TILINGS:
            assert wlib.wy_gram_shared_bytes(n, k, itemsize, rb, stages) == \
                wy._admission_bytes(n, k, dtype, rb, stages), (n, k, dtype, rb)
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
    ref = cpqr_mod._launch("resident", M, nsteps)
    out = {}
    for blocks in sorted({sms, 64, 32}, reverse=True):
        got = cpqr_mod._launch("resident", M, nsteps, blocks)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
            f"resident kernel: {blocks} blocks give other bits than {sms}"
        out[str(blocks)] = cuda_ms(
            lambda: cpqr_mod._launch("resident", M, nsteps, blocks), reps=10)
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
# ranks of the multi-rank phases (all on the one card)
RANKS = 2
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
            if phase_name == "hetero_suite":
                # each rank's lanes of sharded_hetero_suite
                per = B // RANKS
                out += [(f"{shape} {phase_name}, rank {r} of {RANKS} "
                         "(padded)", per, *mask.shape[1:],
                         mask[r * per:(r + 1) * per], "padded", True)
                        for r in range(RANKS)]
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
        # a rank's lanes of sharded_hs65
        (f"A_act^T hs65, a rank's {HS65_LANES // RANKS}", HS65_LANES // RANKS,
         h.n, h.l, 2, "leading_live", True),
        (f"J2 hs65, a rank's {HS65_LANES // RANKS}", HS65_LANES // RANKS,
         h.m, h.n, 2, "trailing_live", True),
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
# rows of the float64 giant-m solve, one card and row-sharded
GIANT64_M = 200_000
# the float64 giant-m solve at twice the bench's rows (giant_m_float64_10m)
GIANT64_10M_ROWS = 10_000_000
# (name, m, n, k, on the main path)
WY_CASES = [
    ("giant-m main path", GIANT_M, GIANT_N, GIANT_L, True),
    ("row-sharded giant-m, a rank's block", GIANT_M // RANKS, GIANT_N,
     GIANT_L, True),
    ("giant-m float64 solve", GIANT64_M, GIANT_N, GIANT_L, True),
    ("row-sharded float64 solve, a rank's block", GIANT64_M // RANKS,
     GIANT_N, GIANT_L, True),
    ("2M x 100, k = 20", 2_000_000, 100, 20, False),
    ("8192 x 16, k = 5", 8192, 16, 5, False),
    ("ragged 4100 x 7, k = 3", 4100, 7, 3, False),
    ("k = 1", 65_537, 32, 1, False),
    ("k = n", 8192, 16, 16, False),
]
# float64 only: the edges of the float64 kernel's mma tiling (n padded to
# 8 with a depth-4 step where n % 8 is 1..4, k padded to 8, 16 x 16 Gram
# blocks) and of its three tilings, at row counts = 1 mod 64 or 5 mod 8.
# At n = 128 the gate admits k <= 84 at float64, so k = n is taken at
# n = 7, 13 and 100.
WY_EDGE_CASES_F64 = [
    ("n = 7, k = 1", 4161, 7, 1, False),
    ("n = 7, k = 3", 4101, 7, 3, False),
    ("n = 7, k = n", 4101, 7, 7, False),
    ("n = 13, k = 1", 4101, 13, 1, False),
    ("n = 13, k = 3", 4161, 13, 3, False),
    ("n = 13, k = n", 4161, 13, 13, False),
    ("n = 128, k = 1", 8197, 128, 1, False),
    ("n = 128, k = 3", 4161, 128, 3, False),
    ("n = 128, k = 64, 32-row tiles", 4161, 128, 64, False),
    ("n = 128, k = 84, 16-row tiles", 4101, 128, 84, False),
    ("n = 100, k = n, 16-row tiles", 6401, 100, 100, False),
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
                    "tiling": wy._tiling(n, k, dtype),
                    "main_path": main_path, "bits_equal": bits_equal,
                    "G_symmetric_to_the_bit": True if "G" in parts else None,
                    "rel_err": errs, "max_abs_err": max(errs.values()),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})
    return out


def check_wy_kernels():
    cases = []
    for dtype in (torch.float64, torch.float32):
        for case in WY_CASES + (WY_EDGE_CASES_F64 if dtype == torch.float64
                                else []):
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


def _giant_solve(gm, config, max_iter=8, dtype=torch.float32):
    """One solve of a giant-m configuration.  The working set at the end
    is read through ``on_iteration``, so the graph path runs in chunks of
    one iteration (one replay and one read-back each; the ``device_loop``
    line times the one-replay solve of (a))."""
    factored, second, tall_qr, _ = GIANT_CONFIGS[config]
    last = {}
    res = core_solve(
        gm.factored if factored else gm.dense, gm.x0, gm.dims,
        et.Options(second_derivatives=second, max_iter=max_iter,
                   tall_qr=tall_qr),
        et.Tols.for_dtype(dtype, DEV), dtype=dtype,
        on_iteration=lambda c: last.update(mask=c.active_mask.clone()))
    torch.cuda.synchronize()
    return res, int(last["mask"].sum())


def solve_giant_m():
    """The giant-m problem of the reference benchmark (5,000,000 x 100,
    50 inequalities, float32, max_iter = 8, data drawn on the card) in
    the four configurations, each after one warm-up solve (which captures
    the configuration's graph).  A
    configuration is solved three times (the host's clock varies between
    solves: the median and the range are kept), with every count set to
    0 just before each solve and read just after; the counts and the
    result kept are the last solve's."""
    _graph.clear_graph_cache()
    gm = giant_m(GIANT_M, GIANT_N, GIANT_L, seed=3, dtype=torch.float32)
    out, x_a, kept = [], None, {}
    for config, (factored, second, tall_qr, kernel) in GIANT_CONFIGS.items():
        _graph.clear_graph_cache()      # the last configuration's pools
        _giant_solve(gm, config)                # warm-up: it captures
        captured = CAPTURES[-1]
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        for _ in range(3):
            reset_launch_counts()
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
               **captured,
               "replay_peak_GB": torch.cuda.max_memory_allocated() / 1e9,
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
        kept[config] = (x, res.n_iter, res.exit_code, n_active)
    return out, gm, kept


# the float64 giant-m phase: (b)-(d) against (a), and the active bounds
GIANT64_DX_RTOL = 1e-9
GIANT64_BLO_ATOL = 1e-6
# a constraint counts as active at the solution where c_i(x) <= this
ACTIVE_ATOL = 1e-8


def giant_m_float64(rows=GIANT_M, replays=3):
    """The giant-m problem at float64 and full width (``rows`` x 100, 50
    inequalities, max_iter = 8, data drawn on the card from seed 3) in the
    four configurations, each the one-replay solve of the device-resident
    loop: first the eager loop (``graph=False``), then a first call that
    captures the graph, then ``replays`` timed solves (one replay and one
    read-back each), every count set to 0 just before each and read just
    after.  Active constraints are counted at the solution (c_i(x) <=
    ACTIVE_ATOL).  (a)'s eager loop gives x, exit code and iterations
    equal to the bit.  Each row carries the four memory figures (the
    eager loop's peak allocated, the capturing call's peak, the memory
    the cached graph holds, the replay's peak; :func:`track_captures`)
    and their ratios, which the targets read: the capture within 1.5x
    the eager peak, the held memory within 1.25x of it plus the static
    inputs.  Then (d)'s thin QR (``ops/tsqr.py::_householder_thin``) of a
    (rows, 100) float64 matrix is timed alone (``thin_qr``)."""
    _graph.clear_graph_cache()
    d = torch.float64
    gm = giant_m(rows, GIANT_N, GIANT_L, seed=3, dtype=d)
    tols = et.Tols.for_dtype(d, DEV)
    static = gm.x0.nbytes + sum(t.nbytes for t in tols)
    torch.cuda.synchronize()
    data_GB = torch.cuda.memory_allocated() / 1e9
    rows_out, x_a = [], None
    for config, (factored, second, tall_qr, kernel) in GIANT_CONFIGS.items():
        _graph.clear_graph_cache()      # the last configuration's pools
        fns = gm.factored if factored else gm.dense
        opts = et.Options(second_derivatives=second, max_iter=8,
                          tall_qr=tall_qr)
        solve = lambda graph=True: core_solve(fns, gm.x0, gm.dims, opts, tols,
                                              dtype=d, graph=graph)
        reset_launch_counts()
        _device.reset_readback_count()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        eager = solve(graph=False)
        torch.cuda.synchronize()
        eager_row = {"seconds": time.time() - t0,
                     "readbacks": _device.readback_count(),
                     "launches": wy.launch_counts(),
                     "x_bits_equal": None, "exit_code": eager.exit_code,
                     "iterations": eager.n_iter}
        eager_peak = torch.cuda.max_memory_allocated() / 1e9
        _graph.reset_graph_stats()
        t0 = time.time()
        solve()
        torch.cuda.synchronize()
        first, stats = time.time() - t0, _graph.graph_stats()
        captured = CAPTURES[-1]
        torch.cuda.reset_peak_memory_stats()
        seconds, readbacks = [], []
        for _ in range(replays):
            reset_launch_counts()
            _device.reset_readback_count()
            t0 = time.time()
            res = solve()
            torch.cuda.synchronize()
            seconds.append(time.time() - t0)
            launches = wy.launch_counts()
            readbacks.append(_device.readback_count())
        x = res.x
        eager_row["x_bits_equal"] = bool(torch.equal(eager.x, x))
        n_active = int((fns.cons(x) <= ACTIVE_ATOL).sum())
        row = {"config": config, "rows": rows, "factored_hooks": factored,
               "second_derivatives": second, "tall_qr": tall_qr,
               "kernel": kernel, "dtype": "float64",
               "seconds_per_solve": statistics.median(seconds),
               "seconds_per_solve_min": min(seconds),
               "seconds_per_solve_max": max(seconds),
               "first_call_seconds": first,
               "capture_seconds": stats["capture_s"],
               "iterations": res.n_iter, "exit_code": res.exit_code,
               "objective": res.f, "active_constraints": n_active,
               "max_abs_x_minus_blo": float((x[:5] - gm.blo).abs().max()),
               "launches": launches, "readbacks_per_solve": readbacks,
               "data_GB": data_GB, "static_inputs_bytes": static,
               "eager_peak_GB": eager_peak, **captured,
               "replay_peak_GB": torch.cuda.max_memory_allocated() / 1e9}
        row["capture_over_eager"] = row["capture_peak_GB"] / eager_peak
        row["held_over_eager"] = row["graph_held_GB"] / eager_peak
        if x_a is None:
            x_a = x
        row["rel_dx_vs_a"] = float(torch.linalg.norm(x - x_a)
                                   / torch.linalg.norm(x_a))
        row["eager"] = eager_row
        rows_out.append(row)
        emit({"giant_m_float64_row": row})     # printed before it is checked
        assert res.exit_code > 0, row
        assert readbacks == [1] * replays, row
        assert bool(torch.isfinite(x).all()) and x.shape == (GIANT_N,), row
        assert n_active >= 5, row
        assert row["max_abs_x_minus_blo"] <= GIANT64_BLO_ATOL, row
        assert row["rel_dx_vs_a"] <= GIANT64_DX_RTOL, row
        assert launches[kernel] > 0, row
        assert all(v == 0 for name, v in launches.items()
                   if name != kernel), row
        if config == "a":
            e = row["eager"]
            assert e["x_bits_equal"] and e["exit_code"] == res.exit_code \
                and e["iterations"] == res.n_iter, row
    del gm
    _graph.clear_graph_cache()
    torch.cuda.empty_cache()
    return {"rows": rows_out, "thin_qr": time_thin_qr(rows)}


def time_thin_qr(rows) -> dict:
    """(d)'s thin QR alone: ``ops/tsqr.py::_householder_thin`` of a
    (rows, 100) float64 matrix drawn on the card, median of 3 (CUDA
    events), beside its bound (the matrix read once and V, R written
    once at the HBM rate; 2 m n^2 - 2 n^3 / 3 operations at the float64
    rate outside the tensor cores, the larger)."""
    n, d = GIANT_N, torch.float64
    g = torch.Generator(device=DEV).manual_seed(5)
    M = torch.randn((rows, n), generator=g, dtype=d, device=DEV)
    ms = cuda_ms(lambda: _householder_thin(M), reps=3)
    bytes_ = 2 * rows * n * 8 + n * n * 8
    flops = 2 * rows * n * n - 2 * n ** 3 / 3
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[d] * 1e3
    del M
    torch.cuda.empty_cache()
    return {"shape": [rows, n], "dtype": "float64", "ms": ms,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _wy_kernel_entries(wcases, giant, gloo, graph_rows, giant64):
    lines = {"wy_right_apply": 52, "wy_gram_project": 60,
             "wy_gram_project_rowscale": 86, "wy_gram_project_noapply": 118}
    by_kernel = {row["kernel"]: row for row in giant}
    by_kernel64 = {row["kernel"]: row for row in giant64}
    entries = []
    for name in WY_NAMES:
        mine = [c for c in wcases if c["kernel"] == name]
        mine32 = [c for c in mine if c["dtype"] == "float32"]
        mine64 = [c for c in mine if c["dtype"] == "float64"]
        at = lambda cases, m: next(c for c in cases if c["shape"][0] == m
                                   and c["main_path"])
        head, head64 = at(mine32, GIANT_M), at(mine64, GIANT_M)
        solve64 = at(mine64, GIANT64_M)
        entries.append({
            "name": f"{name}_float64", "route": "cuda",
            "source": "enlsip_tpu_torch/csrc/wy_gram_f64.cu",
            "replaces": f"enlsip_tpu/ops/pallas_wy.py:{lines[name]}",
            "launches": by_kernel64[name]["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in mine64),
            "tolerance": "relative to max |JQ1| (JQ1) and to the norms of G "
                         "and p, against the plain version at float64: "
                         "1e-11; two launches give equal bits; G symmetric "
                         "to the bit",
            "ms": head64["ms"], "plain_ms": head64["plain_ms"],
            "bound_ms": head64["bound_ms"], "bound_by": head64["bound_by"],
            "library_ms": None,
            "at_200000_rows": {k: solve64[k] for k in
                               ("ms", "plain_ms", "bound_ms", "bound_by")},
            "timed_at": "5000000 x 100, k = 50, float64 (the giant_m_float64 "
                        "path; at_200000_rows: the float64 row-sharded "
                        "check's one-card solve); plain_ms is the chain of "
                        "library matrix products, not a single call; "
                        "launches: the giant_m_float64 configuration that "
                        "reaches it, counted at its last replay",
            "cases": mine64})
        entries.append({
            "name": name, "route": "cuda",
            "source": "enlsip_tpu_torch/csrc/wy_gram.cu",
            "replaces": f"enlsip_tpu/ops/pallas_wy.py:{lines[name]}",
            "launches": by_kernel[name]["launches"][name],
            "launches_rowsharded_by_rank": [
                r["giant"][by_kernel[name]["config"]]["launches"][name]
                for r in gloo],
            "launches_rowsharded_graph_nccl_replay": next(
                row["graph"]["launches"][name] for row in graph_rows
                if row["kernel"] == name),
            "max_abs_err": max(c["max_abs_err"] for c in mine32),
            "tolerance": "relative to max |JQ1| (JQ1) and to the norms of G "
                         "and p, against the plain version in float64: 5e-6 "
                         "(JQ1), 2e-5 (G, p); two launches give equal bits",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "timed_at": "5000000 x 100, k = 50, float32 (the giant-m main "
                        "path); plain_ms is the chain of library matrix "
                        "products, not a single call",
            "cases": mine32})
    return entries


# --------------------------------------------- kernels inside a graph

def graph_kernel_cases():
    """B1 (both routes) and B2 at the main paths' shapes launched inside
    a captured graph, in the body of a conditional node as the solve
    launches them, with the step count in device memory; the graph is
    replayed twice and each replay held against the eager launch on the
    same inputs (equal bits)."""
    rows = []

    def case(name, fn, inputs):
        eager = fn(*inputs)
        first = [t.clone() for t in _graph.run(("kernel_case", name), lambda *a: _lanes.cond(
            a[0].reshape(-1)[0] == a[0].reshape(-1)[0], lambda: fn(*a),
            lambda: fn(*a)), inputs, DEV)]
        second = _graph.run(("kernel_case", name), None, inputs, DEV)
        torch.cuda.synchronize()
        eq = [all(torch.equal(a, b) for a, b in zip(eager, r))
              for r in (first, second)]
        rows.append({"case": name, "replays_equal_eager": eq})
        assert all(eq), (name, eq)

    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        M = _case_matrix("normal", 1000, 998, 998, dtype, seed=7)
        for route, (fn, _) in B1_ROUTES.items():
            for steps in (998, 2):
                case(f"B1 {route} 1000x998 {steps} steps {dt}", fn,
                     (M, torch.full((), steps, dtype=torch.int32, device=DEV)))
        J2 = _case_matrix("trailing_live", 1998, 1000, 2, dtype, seed=8)
        case(f"B1 dispatch 1998x1000 2 steps {dt}", cpqr_hopper,
             (J2, torch.full((), 2, dtype=torch.int64, device=DEV)))
        for B, r, c in ((10_000, 40, 10), (HS65_LANES, 3, 7),
                        (HS65_LANES, 3, 3)):
            Mb = torch.randn(B, r, c, dtype=dtype, device=DEV)
            case(f"B2 {B} x {r}x{c} {dt}", cpqr_batched_packed, (Mb,))
    return rows


# what the peak allocated over each mode of _run_both / _graph_vs_eager
# measures
PEAK_NAMES = {"graph_first": "capture_peak_GB", "graph": "replay_peak_GB",
              "eager": "eager_peak_GB"}


def _held(mode) -> dict:
    """The memory the graph captured by a ``graph_first`` call holds
    (:func:`track_captures`)."""
    if mode != "graph_first" or not CAPTURES:
        return {}
    return {"graph_held_GB": CAPTURES[-1]["graph_held_GB"]}


def _run_both(run, eager_run):
    """The graph path (its first call captures; timed on a second replay)
    and the eager loop on the same inputs, each with the read-back and
    launch counts set to 0 just before and read just after."""
    out = {}
    for mode, fn in (("graph_first", run), ("graph", run),
                     ("eager", eager_run)):
        reset_launch_counts()
        _device.reset_readback_count()
        _graph.reset_graph_stats()
        torch.cuda.synchronize()
        if mode != "graph":           # the graph's pools stay reserved
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        begin.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        wall = time.time() - t0
        stats = _graph.graph_stats()
        span = begin.elapsed_time(end) / 1e3
        out[mode] = {"seconds": wall,
                     # the card's span from the first enqueued work to the
                     # last, over the wall clock: a replay has no host gap
                     # inside it, so for the graph path this bounds the busy
                     # share from above (device_loop's profile measures it)
                     "device_span_seconds": span,
                     "device_span_share": span / wall,
                     "readbacks": _device.readback_count(),
                     "graph_launches": stats["replays"],
                     "captures": stats["captures"],
                     "capture_seconds": stats["capture_s"],
                     PEAK_NAMES[mode]:
                         torch.cuda.max_memory_allocated() / 1e9,
                     "peak_reserved_GB":
                         torch.cuda.max_memory_reserved() / 1e9,
                     **_held(mode),
                     "launches": {
                         "cpqr_hopper": _graph.launches(cpqr_hopper),
                         "cpqr_batched_packed":
                             _graph.launches(cpqr_batched_packed),
                         **wy.launch_counts()},
                     "result": res}
    return out


def device_loop(profile=True):
    """The device-resident solve loop against the eager loop on the same
    inputs: Chained Rosenbrock n=1000 (float32, float64), HS65 x 4096,
    the ODE fit x 10,000 (float32, with the float64 re-solve of its
    non-converged lanes) and giant-m (a).  Per path: exit codes,
    iterations or trips, x equal to the bit, read-backs a solve, graph
    launches, capture and replay seconds, the card's span over the wall
    clock (CUDA events), the busy share of the eager loop and of the
    graph's replay (profiler, one more solve each; beside it the replay's
    share estimated from the eager loop's kernel time), the capturing
    call's and the replay's peak memory and the memory the graph holds."""
    rows = []
    cpqr_blocked.cuda_rank1["lanes"] = 0
    kw = chained_rosenbrock(1000)
    for dtype in (torch.float32, torch.float64):
        model = et.CnlsModel(**kw)
        fns = _solve_functions(model, dtype, DEV)
        dims = et.Dims(1000, 1998, 998, 998)
        opts = et.Options(second_derivatives=False)
        tols = et.Tols.for_dtype(dtype, DEV)
        x0 = torch.as_tensor(model.starting_point, dtype=dtype, device=DEV)
        run = lambda: core_solve(fns, x0, dims, opts, tols, dtype=dtype)
        eager = lambda: core_solve(fns, x0, dims, opts, tols, dtype=dtype,
                                   graph=False)
        rows.append(_single_row(f"cr1000_{str(dtype)[6:]}", run, eager,
                                profile))
    fns, starts = _hs65_batch(torch.float32, HS65_LANES)
    tols = et.Tols.for_dtype(torch.float32, DEV)
    rows.append(_batch_row(
        "hs65_x4096", lambda g: solve_batched(
            fns, starts, HS65_DIMS, et.Options(), tols, dtype=torch.float32,
            graph=g), profile))
    fns, starts, ys, opts, tols = _ode_batch()
    # (not profiled: the eager ODE fit's ~500,000 launches take the
    # profiler minutes to sort; its busy share is in PERF.md)
    rows.append(_batch_row(
        "ode_fit_x10000", lambda g: solve_batched(
            fns, starts, ODE_DIMS, opts, tols, dtype=torch.float32, data=ys,
            escalate_f64=True, graph=g), False))
    _graph.clear_graph_cache()
    gm = giant_m(GIANT_M, GIANT_N, GIANT_L, seed=3, dtype=torch.float32)
    gopts = et.Options(second_derivatives=False, max_iter=8)
    gtols = et.Tols.for_dtype(torch.float32, DEV)
    rows.append(_single_row(
        "giant_m_a", lambda: core_solve(gm.factored, gm.x0, gm.dims, gopts,
                                        gtols, dtype=torch.float32),
        lambda: core_solve(gm.factored, gm.x0, gm.dims, gopts, gtols,
                           dtype=torch.float32, graph=False), profile))
    del gm
    _graph.clear_graph_cache()
    return rows


def _busy(fn):
    prof = profile_solve(fn)
    return {k: prof.get(k) for k in ("device_busy_share", "device_kernel_ms",
                                     "wall_seconds_under_profiler",
                                     "kernel_launches", "device_time")
            if k in prof}


def _busy_estimate(row):
    """The device's kernel time of the same work (the eager loop's profile:
    the graph runs the same kernels) over the replay's wall time."""
    kernel_ms = row["eager"]["profile"].get("device_kernel_ms")
    return None if kernel_ms is None else \
        kernel_ms / 1e3 / row["graph"]["seconds"]


def _single_row(name, run, eager, profile):
    both = _run_both(run, eager)
    g, e = both["graph"]["result"], both["eager"]["result"]
    row = {"path": name, "exit_code": [g.exit_code, e.exit_code],
           "iterations": [g.n_iter, e.n_iter],
           "x_bits_equal": bool(torch.equal(g.x, e.x)),
           **{m: {k: v for k, v in both[m].items() if k != "result"}
              for m in both}}
    if profile:
        row["eager"]["profile"] = _busy(eager)
        row["graph"]["profile"] = _busy(run)
        row["graph"]["busy_share_estimate"] = _busy_estimate(row)
    assert g.exit_code == e.exit_code and g.n_iter == e.n_iter, row
    assert row["x_bits_equal"], row
    assert both["graph"]["readbacks"] == 1, row
    return row


def _batch_row(name, solve, profile):
    trips = {}

    def run(g):
        res = solve(g)
        trips["graph" if g else "eager"] = run_batch.last_trips
        return res

    both = _run_both(lambda: run(True), lambda: run(False))
    g, e = both["graph"]["result"], both["eager"]["result"]
    lanes_equal = (g.x == e.x).all(dim=-1)
    row = {"path": name, "lanes": int(g.x.shape[0]),
           "trips_last_solve": trips,
           "exit_codes_equal": bool(torch.equal(g.exit_code, e.exit_code)),
           "x_bits_equal": bool(lanes_equal.all()),
           "lanes_x_bits_equal": int(lanes_equal.sum()),
           "lanes_differing": torch.nonzero(~lanes_equal)[:, 0].tolist()[:50],
           "rank1_lanes_on_card": cpqr_blocked.cuda_rank1["lanes"],
           **{m: {k: v for k, v in both[m].items() if k != "result"}
              for m in both}}
    if profile:
        row["eager"]["profile"] = _busy(lambda: run(False))
        row["graph"]["profile"] = _busy(lambda: run(True))
        row["graph"]["busy_share_estimate"] = _busy_estimate(row)
    assert row["exit_codes_equal"] and row["x_bits_equal"], row
    assert trips["graph"] == trips["eager"], row
    assert both["graph"]["readbacks"] <= 2, row
    assert row["rank1_lanes_on_card"] == 0, row
    return row


# ------------------------------------------------------------ main path

def _lane_launches():
    total = _graph.launches(cpqr_hopper_lanes)
    panels = _graph.launches(cpqr_hopper_lanes, "panel_launches")
    return {"resident": total - panels, "panels": panels}


def _counted(fn, reset_peak=True):
    """``fn()`` with every count set to 0 just before it and read just
    after: (result, {seconds, read-backs, B1 launches single / by lane
    route, B2 launches, peak GB}); the peak since ``fn`` began, or since
    the caller's own reset with ``reset_peak=False``."""
    torch.cuda.synchronize()
    reset_launch_counts()
    _device.reset_readback_count()
    if reset_peak:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = fn()
    torch.cuda.synchronize()
    return res, {"seconds": time.time() - t0,
                 "readbacks": _device.readback_count(),
                 "cpqr_hopper_launches": _graph.launches(cpqr_hopper),
                 "cpqr_hopper_panels_launches":
                     _graph.launches(cpqr_hopper_panels),
                 "cpqr_hopper_lanes_launches": _lane_launches(),
                 "cpqr_batched_launches": _graph.launches(cpqr_batched_packed),
                 "peak_GB": torch.cuda.max_memory_allocated() / 1e9}


def solve_cr1000(dtype):
    """One warm-up solve, then one timed solve with the launch and
    read-back counts set to 0 just before and read just after."""
    kw = chained_rosenbrock(1000)
    et.solve(et.CnlsModel(**kw), dtype=dtype)          # warm-up
    model = et.CnlsModel(**kw)
    _, stats = _counted(lambda: et.solve(model, dtype=dtype))
    seconds = stats["seconds"]
    launches = stats["cpqr_hopper_launches"]
    route = cpqr_hopper.last_route
    readbacks = stats["readbacks"]
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
    read just after (:func:`_counted`; the caller's peak memory reset
    stands)."""
    (warmup or solve)()
    res, counts = _counted(solve, reset_peak=False)
    trips = run_batch.last_trips
    launches, readbacks = counts["cpqr_batched_launches"], counts["readbacks"]
    stats = {"seconds_per_batch_solve": counts["seconds"], "trips": trips,
             "cpqr_batched_launches": launches,
             "launches_per_trip": launches / max(trips, 1),
             "host_readbacks": readbacks,
             "host_readbacks_per_trip": readbacks / max(trips, 1)}
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
    return stats, fams, fused, opts, out


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
    stats, fams, fused, opts, _ = _hetero(HETERO_NEWTON_FAMILIES, 512, True)
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


# ------------------------------- multi-rank phases (batch and row sharding)
#
# The card is one: the two-rank phases run two gloo ranks on it (NCCL
# refuses two ranks on one device), which measures correctness and the
# collectives' count, not scaling; one phase also runs one NCCL rank so
# that the NCCL path is taken on the card.  Each rank is a process of
# this script started through torch.multiprocessing "spawn"; it joins the
# group through a file under build/, and a rank that raises, or a spawn
# that outlives RANK_DEADLINE_S, fails the phase.

RANK_DEADLINE_S = 420


def _reset_counts():
    reset_launch_counts()
    cpqr_blocked.cuda_rank1["lanes"] = 0
    _device.reset_readback_count()
    _dist.reset_collective_count()


def _rank_hs65(rank, world):
    """HS65 x 4096 lanes split over the ranks, float32 and float64, after
    a warm-up solve of the same lanes; counts set to 0 just before the
    timed solve.  gloo ranks take the eager loop (``graph=False``: gloo
    moves the card's tensors through host memory)."""
    mesh = batch_mesh()
    out = {}
    for dtype in (torch.float32, torch.float64):
        fns, starts = _hs65_batch(dtype, HS65_LANES)
        tols = et.Tols.for_dtype(dtype, DEV)

        def solve(x0):
            res = solve_batched_sharded(fns, x0, HS65_DIMS, et.Options(),
                                        tols, mesh=mesh, dtype=dtype,
                                        graph=False)
            torch.cuda.synchronize()
            return res

        solve(starts)
        _reset_counts()
        t0 = time.time()
        res = solve(starts)
        out[str(dtype).replace("torch.", "")] = {
            "seconds": time.time() - t0, "trips": run_batch.last_trips,
            "exit_code": res.exit_code.cpu(), "x": res.x.double().cpu(),
            "f": res.f.double().cpu(),
            "cpqr_batched_launches": _graph.launches(cpqr_batched_packed),
            "rank1_lanes_on_card": cpqr_blocked.cuda_rank1["lanes"],
            "collectives": _dist.collective_count(),
            "host_readbacks": _device.readback_count()}
    return out


def _rank_hetero(rank, world):
    """The five-family fused float32 batch (2,560 lanes) with mesh=, after
    a warm-up of 8 lanes a family; counts set to 0 just before."""
    mesh = batch_mesh()
    fams = hs_scenario_batch(HETERO_FAMILIES, per_family=512, seed=0)
    opts = et.Options(max_iter=60)
    warm = hs_scenario_batch(HETERO_FAMILIES, per_family=8, seed=1)
    solve_suite_fused(warm, dataclasses.replace(opts, max_iter=2), _tols_fn,
                      mesh=mesh, dtype=torch.float32, graph=False)
    fused = fuse_families(fams)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.time()
    res = solve_suite_fused(fams, opts, _tols_fn, mesh=mesh,
                            dtype=torch.float32, fused=fused, graph=False)
    torch.cuda.synchronize()
    return {"seconds": time.time() - t0, "trips": run_batch.last_trips,
            "cpqr_batched_launches": _graph.launches(cpqr_batched_packed),
            "rank1_lanes_on_card": cpqr_blocked.cuda_rank1["lanes"],
            "collectives": _dist.collective_count(),
            "lanes": {n: {"exit_code": r.exit_code.cpu(), "x": r.x.cpu(),
                          "f": r.f.double().cpu()} for n, r in res.items()}}


def _rowsharded_solve(gm, config, mesh, tsqr=False, dtype=torch.float32,
                      graph=False):
    factored, second, tall_qr, _ = GIANT_CONFIGS[config]
    carry = solve_rowsharded(
        gm.factored if factored else gm.dense, gm.x0, gm.dims,
        et.Options(second_derivatives=second, max_iter=8, tall_qr=tall_qr),
        et.Tols.for_dtype(dtype, DEV), mesh=mesh, dtype=dtype, tsqr=tsqr,
        graph=graph)
    torch.cuda.synchronize()
    return carry


def _rank_giant(rank, world):
    """This rank's rows of the giant-m problem (the same draw as
    solve_giant_m), the four configurations: a warm-up, then three
    solves with the counts set to 0 before each (the last one's kept);
    then tsqr=True on (c) and (a) at float64 on GIANT64_M rows."""
    mesh = row_mesh()
    out = {}
    torch.cuda.empty_cache()
    gm = giant_m(GIANT_M, GIANT_N, GIANT_L, seed=3, dtype=torch.float32,
                 shard=(rank, world))
    for config in GIANT_CONFIGS:
        _rowsharded_solve(gm, config, mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        for _ in range(3):
            _reset_counts()
            t0 = time.time()
            carry = _rowsharded_solve(gm, config, mesh)
            seconds.append(time.time() - t0)
            counts = (wy.launch_counts(), _dist.collective_count(),
                      _device.readback_count(), _graph.launches(cpqr_hopper))
        iters = int(carry.nb_iter)
        out[config] = {
            "x": carry.x.double().cpu(), "iterations": iters,
            "exit_code": int(carry.exit_code),
            "active_constraints": int(carry.active_mask.sum()),
            "seconds": seconds, "launches": counts[0],
            "collectives_per_iteration": counts[1] / max(iters, 1),
            "host_readbacks_per_iteration": counts[2] / max(iters, 1),
            "cpqr_hopper_launches": counts[3],
            "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    carry = _rowsharded_solve(gm, "c", mesh, tsqr=True)
    out["c_tsqr"] = {"x": carry.x.double().cpu(),
                     "iterations": int(carry.nb_iter),
                     "exit_code": int(carry.exit_code)}
    del gm
    torch.cuda.empty_cache()
    gm64 = giant_m(GIANT64_M, GIANT_N, GIANT_L, seed=3, dtype=torch.float64,
                   shard=(rank, world))
    carry = _rowsharded_solve(gm64, "a", mesh, dtype=torch.float64)
    out["a_float64"] = {"x": carry.x.cpu(), "iterations": int(carry.nb_iter),
                        "exit_code": int(carry.exit_code)}
    return out


def _graph_vs_eager(solve, keep):
    """``solve(graph)`` three times on the same inputs: the graph path's
    first call (capture and replay), its second (a replay alone) and the
    eager loop, each with every count set to 0 just before it and read
    just after: read-backs, collectives (the eager ones and those that
    replays made, counted on the card), kernel launches (replays
    included), captures, replays and capture seconds, wall seconds, peak
    memory, and ``keep(result)``."""
    out = {}
    for mode, graph in (("graph_first", True), ("graph", True),
                        ("eager", False)):
        _reset_counts()
        _graph.reset_graph_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = solve(graph)
        torch.cuda.synchronize()
        wall = time.time() - t0
        stats = _graph.graph_stats()
        out[mode] = {
            "seconds": wall, "readbacks": _device.readback_count(),
            "collectives": _graph.launches(_dist.all_reduce, "collectives"),
            "collectives_made_by_the_host": _dist.collective_count(),
            "launches": {"cpqr_batched_packed":
                         _graph.launches(cpqr_batched_packed),
                         **wy.launch_counts()},
            "rank1_lanes_on_card": cpqr_blocked.cuda_rank1["lanes"],
            "captures": stats["captures"], "replays": stats["replays"],
            "capture_seconds": stats["capture_s"],
            PEAK_NAMES[mode]: torch.cuda.max_memory_allocated() / 1e9,
            **_held(mode), "result": keep(res)}
    return out


def _batch_keep(res):
    return {"exit_code": res.exit_code.cpu(), "x": res.x.cpu(),
            "n_iter": res.n_iter.cpu(), "f": res.f.double().cpu(),
            "trips": run_batch.last_trips}


def _rank_graph(rank, world):
    """One NCCL rank: every sharded entry point through its captured graph
    and its eager loop on the same inputs (``_graph_vs_eager``):
    ``sharded_hs65`` (4096 lanes, float32 and float64),
    ``sharded_hetero_suite`` (the five-family fused float32 batch) and
    ``rowsharded_giant_m`` (a)-(d) at 5,000,000 x 100 x 50.  The graph
    replay of HS65 also fills the ``hs65`` rows of this backend."""
    mesh = batch_mesh()
    out, hs65 = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        fns, starts = _hs65_batch(dtype, HS65_LANES)
        tols = et.Tols.for_dtype(dtype, DEV)
        both = _graph_vs_eager(lambda g: solve_batched_sharded(
            fns, starts, HS65_DIMS, et.Options(), tols, mesh=mesh,
            dtype=dtype, graph=g), _batch_keep)
        out[f"sharded_hs65_{name}"] = both
        g = both["graph"]
        hs65[name] = {
            "seconds": g["seconds"], "trips": g["result"]["trips"],
            "exit_code": g["result"]["exit_code"],
            "x": g["result"]["x"].double(), "f": g["result"]["f"],
            "cpqr_batched_launches": g["launches"]["cpqr_batched_packed"],
            "rank1_lanes_on_card": g["rank1_lanes_on_card"],
            "collectives": g["collectives"],
            "host_readbacks": g["readbacks"]}
        _graph.clear_graph_cache()
    fams = hs_scenario_batch(HETERO_FAMILIES, per_family=512, seed=0)
    fused = fuse_families(fams)
    opts = et.Options(max_iter=60)

    def hetero(g):
        res = solve_suite_fused(fams, opts, _tols_fn, mesh=mesh,
                                dtype=torch.float32, fused=fused, graph=g)
        return res, run_batch.last_trips

    out["sharded_hetero_suite"] = _graph_vs_eager(hetero, lambda r: {
        "trips": r[1], "lanes": {n: {"exit_code": v.exit_code.cpu(),
                                     "x": v.x.cpu(), "n_iter": v.n_iter.cpu()}
                                 for n, v in r[0].items()}})
    _graph.clear_graph_cache()
    torch.cuda.empty_cache()
    gm = giant_m(GIANT_M, GIANT_N, GIANT_L, seed=3, dtype=torch.float32,
                 shard=(rank, world))
    for config in GIANT_CONFIGS:
        out[f"rowsharded_giant_m_{config}"] = _graph_vs_eager(
            lambda g: _rowsharded_solve(gm, config, mesh, graph=g),
            lambda c: {"x": c.x.cpu(), "exit_code": int(c.exit_code),
                       "n_iter": int(c.nb_iter),
                       "active_constraints": int(c.active_mask.sum())})
        _graph.clear_graph_cache()
    del gm
    torch.cuda.empty_cache()
    return {"paths": out, "hs65": hs65}


RANK_JOBS = {"hs65": _rank_hs65, "hetero": _rank_hetero,
             "giant": _rank_giant, "graph": _rank_graph}


def _rank_main(rank, world, backend, init_file, out_dir, jobs):
    """One rank: join the group, run ``jobs`` in order, save the results
    (the ``graph`` job's ``hs65`` rows under ``hs65``)."""
    _dist.init_process_group(backend, f"file://{init_file}", world, rank)
    track_captures()
    out = {job: RANK_JOBS[job](rank, world) for job in jobs}
    if "graph" in out:
        out["hs65"] = out["graph"]["hs65"]
    torch.distributed.destroy_process_group()
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def run_ranks(world, backend, jobs):
    """Start ``world`` ranks on the card, wait for them with a deadline
    (killing them all past it) and return each rank's results."""
    tag = f"{backend}{world}_{os.getpid()}_{time.time_ns()}"
    out_dir = _build.build_dir() / "ranks" / tag
    out_dir.mkdir(parents=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, backend, str(out_dir / "init"), str(out_dir), jobs))
        for r in range(world)]
    for p in procs:
        p.start()
    end = time.time() + RANK_DEADLINE_S
    try:
        for p in procs:
            p.join(max(0.0, end - time.time()))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not late, f"ranks {late} outlived the {RANK_DEADLINE_S} s deadline"
    codes = [p.exitcode for p in procs]
    assert all(c == 0 for c in codes), f"rank exit codes {codes}"
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _hs65_rows(ranks, backend, fails):
    """Per dtype: the sharded lanes against the one-process solve of all
    4096 lanes: exit codes equal, float64 x within 1e-12, match share
    equal."""
    out = {}
    D = len(ranks)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        fns, starts = _hs65_batch(dtype, HS65_LANES)
        whole = solve_batched(fns, starts, HS65_DIMS, et.Options(),
                              et.Tols.for_dtype(dtype, DEV), dtype=dtype)
        mine = ranks[0]["hs65"][name]
        x1 = whole.x.double().cpu()
        match = float(np.mean(np.abs(mine["f"].numpy() - HS65_FSTAR) < 1e-4))
        match1 = float(np.mean(np.abs(whole.f.double().cpu().numpy()
                                      - HS65_FSTAR) < 1e-4))
        row = {"backend": backend, "ranks": D, "dtype": name,
               "lanes": HS65_LANES,
               "codes_equal_to_one_process": bool(torch.equal(
                   mine["exit_code"], whole.exit_code.cpu())),
               "lanes_bits_equal_share": float(
                   (mine["x"] == x1).all(dim=-1).double().mean()),
               "max_abs_dx": float((mine["x"] - x1).abs().max()),
               "match_share": match, "one_process_match_share": match1,
               "exit_codes": _exit_code_counts(mine["exit_code"].numpy()),
               "trips_by_rank": [r["hs65"][name]["trips"] for r in ranks],
               "seconds_by_rank": [r["hs65"][name]["seconds"]
                                   for r in ranks],
               "cpqr_batched_launches_by_rank": [
                   r["hs65"][name]["cpqr_batched_launches"] for r in ranks],
               "collectives_per_trip": mine["collectives"] / mine["trips"],
               "host_readbacks_per_trip":
                   mine["host_readbacks"] / mine["trips"]}
        ok = row["codes_equal_to_one_process"] and match == match1 \
            and len(set(row["trips_by_rank"])) == 1 \
            and (dtype == torch.float32 or row["max_abs_dx"] <= 1e-12)
        ok = ok and all(
            r["hs65"][name]["cpqr_batched_launches"] > 0
            and r["hs65"][name]["rank1_lanes_on_card"] == 0
            and torch.equal(r["hs65"][name]["x"], mine["x"]) for r in ranks)
        if not ok:
            fails.append(("sharded_hs65", row))
        out[f"{backend}_{D}_{name}"] = row
    return out


def _hetero_row(gloo, hetero_out, fails):
    """The fused five-family batch with mesh= against the one-process
    fused solve of all 2,560 lanes (the hetero_suite phase's): exit codes
    equal, match rate equal."""
    D = len(gloo)
    mine = gloo[0]["hetero"]["lanes"]
    codes_eq = all(torch.equal(mine[n]["exit_code"],
                               hetero_out[n].exit_code.cpu()) for n in mine)
    dx = max(float((mine[n]["x"] - hetero_out[n].x.cpu()).abs().max())
             for n in mine)
    bits = float(np.mean(np.concatenate([
        (mine[n]["x"] == hetero_out[n].x.cpu()).all(dim=-1).numpy()
        for n in mine])))
    fstar = {n: get_problem(n)[1] for n in HETERO_FAMILIES}
    hit = lambda f, n: np.abs(f - fstar[n]) < 1e-3 * max(1.0, abs(fstar[n]))
    match = float(np.mean(np.concatenate(
        [hit(mine[n]["f"].numpy(), n) for n in mine])))
    match1 = float(np.mean(np.concatenate(
        [hit(hetero_out[n].f.double().cpu().numpy(), n) for n in mine])))
    h0 = gloo[0]["hetero"]
    row = {"backend": "gloo", "ranks": D, "dtype": "float32",
           "lanes": sum(int(v["x"].shape[0]) for v in mine.values()),
           "codes_equal_to_one_process": codes_eq,
           "lanes_bits_equal_share": bits, "max_abs_dx": dx,
           "match_rate": match, "one_process_match_rate": match1,
           "trips_by_rank": [r["hetero"]["trips"] for r in gloo],
           "seconds_by_rank": [r["hetero"]["seconds"] for r in gloo],
           "cpqr_batched_launches_by_rank": [
               r["hetero"]["cpqr_batched_launches"] for r in gloo],
           "collectives_per_trip": h0["collectives"] / h0["trips"]}
    ok = codes_eq and match == match1 and match >= 0.99 \
        and len(set(row["trips_by_rank"])) == 1 \
        and all(r["hetero"]["cpqr_batched_launches"] > 0
                and r["hetero"]["rank1_lanes_on_card"] == 0 for r in gloo)
    if not ok:
        fails.append(("sharded_hetero_suite", row))
    return row


def _giant_rows(gloo, giant_kept, one64, fails):
    rows = []
    for config, (factored, second, tall_qr, kernel) in GIANT_CONFIGS.items():
        x1, it1, ec1, act1 = giant_kept[config]
        g0 = gloo[0]["giant"][config]
        row = {"config": config, "kernel": kernel, "ranks": len(gloo),
               "backend": "gloo", "rows_per_rank": GIANT_M // len(gloo),
               "iterations": g0["iterations"], "one_card_iterations": it1,
               "exit_code": g0["exit_code"], "one_card_exit_code": ec1,
               "active_constraints": g0["active_constraints"],
               "rel_dx_vs_one_card": float(torch.linalg.norm(
                   g0["x"] - x1.cpu()) / torch.linalg.norm(x1.cpu())),
               "by_rank": [{
                   **{k: v for k, v in r["giant"][config].items()
                      if k not in ("x", "seconds")},
                   "seconds_per_solve": statistics.median(
                       r["giant"][config]["seconds"]),
                   "seconds_per_solve_min": min(r["giant"][config]["seconds"]),
                   "seconds_per_solve_max": max(r["giant"][config]["seconds"])}
                   for r in gloo]}
        ok = (row["iterations"], row["exit_code"]) == (it1, ec1) \
            and row["exit_code"] == 10000 \
            and row["active_constraints"] == act1 >= 5 \
            and row["rel_dx_vs_one_card"] <= 1e-6
        for r in gloo:
            g = r["giant"][config]
            ok = ok and torch.equal(g["x"], g0["x"]) \
                and g["launches"][kernel] > 0 \
                and all(v == 0 for k, v in g["launches"].items()
                        if k != kernel)
        if not ok:
            fails.append(("rowsharded_giant_m", row))
        rows.append(row)
    ct, c = gloo[0]["giant"]["c_tsqr"], gloo[0]["giant"]["c"]
    tsqr = {"config": "c", "tsqr": True, "iterations": ct["iterations"],
            "exit_code": ct["exit_code"],
            "bits_equal_to_tsqr_false": bool(torch.equal(ct["x"], c["x"]))}
    if (tsqr["iterations"], tsqr["exit_code"]) != (c["iterations"],
                                                   c["exit_code"]):
        fails.append(("rowsharded_giant_m tsqr", tsqr))
    a64, x64 = gloo[0]["giant"]["a_float64"], one64.x.cpu()
    f64row = {"config": "a", "dtype": "float64", "m": GIANT64_M,
              "iterations": a64["iterations"],
              "one_card_iterations": one64.n_iter,
              "exit_code": a64["exit_code"],
              "one_card_exit_code": one64.exit_code,
              "rel_dx_vs_one_card": float(torch.linalg.norm(a64["x"] - x64)
                                          / torch.linalg.norm(x64))}
    if f64row["iterations"] != one64.n_iter or \
            f64row["rel_dx_vs_one_card"] > 1e-8:
        fails.append(("rowsharded_giant_m float64", f64row))
    return rows, tsqr, f64row


def _equal_results(a, b) -> bool:
    """Two results of ``_graph_vs_eager``'s ``keep`` equal to the bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_results(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _graph_rows(nccl, fails):
    """The ``sharded_graph`` line: for each sharded path of the NCCL rank,
    its graph against its eager loop on the same inputs: results equal to
    the bit (x, exit codes, iterations, trips), one read-back a solve on
    the graph path (the batch's gather adds none), the path's kernel
    launched at replay, no plain batched factorization on the card."""
    rows = []
    for path, both in nccl[0]["graph"]["paths"].items():
        g, e = both["graph"]["result"], both["eager"]["result"]
        kernel = "cpqr_batched_packed" if not path.startswith("rowsharded") \
            else GIANT_CONFIGS[path[-1]][3]
        row = {"path": path, "backend": "nccl", "ranks": 1,
               "results_equal_to_the_bit": _equal_results(g, e),
               "kernel": kernel,
               **{m: {k: v for k, v in both[m].items() if k != "result"}
                  for m in both}}
        if "trips" in g:
            row["trips"] = [g["trips"], e["trips"]]
        if "n_iter" in g and not isinstance(g["n_iter"], torch.Tensor):
            row["iterations"] = [g["n_iter"], e["n_iter"]]
            row["exit_code"] = [g["exit_code"], e["exit_code"]]
            row["active_constraints"] = g["active_constraints"]
        ok = row["results_equal_to_the_bit"]
        for m in ("graph_first", "graph"):
            ok = ok and both[m]["readbacks"] == 1 \
                and both[m]["launches"][kernel] > 0 \
                and both[m]["rank1_lanes_on_card"] == 0 \
                and both[m]["collectives"] > 0
            ok = ok and all(v == 0 for k, v in both[m]["launches"].items()
                            if k != kernel)
        ok = ok and both["graph"]["captures"] == 0 \
            and both["graph_first"]["captures"] >= 1
        if path.startswith("rowsharded"):
            ok = ok and g["exit_code"] == 10000 \
                and g["active_constraints"] >= 5
        if not ok:
            fails.append(("sharded_graph", row))
        rows.append(row)
    return rows


def multi_rank_phases(hetero_out, giant_kept):
    """sharded_hs65 (two gloo ranks, then one NCCL rank),
    sharded_hetero_suite and rowsharded_giant_m (two gloo ranks, eager
    loops), each held against one-process / one-card solves of the same
    inputs; then ``sharded_graph``: the NCCL rank's sharded paths through
    their captured graphs against their eager loops.  Every line is
    printed before a failed check fails the script."""
    t0 = time.time()
    gm64 = giant_m(GIANT64_M, GIANT_N, GIANT_L, seed=3, dtype=torch.float64)
    one64, _ = _giant_solve(gm64, "a", dtype=torch.float64)
    del gm64
    torch.cuda.empty_cache()
    gloo = run_ranks(RANKS, "gloo", ["hs65", "hetero", "giant"])
    t_nccl = time.time()
    nccl = run_ranks(1, "nccl", ["graph"])
    t_nccl = time.time() - t_nccl
    fails = []
    hs = {**_hs65_rows(gloo, "gloo", fails), **_hs65_rows(nccl, "nccl", fails)}
    emit({"sharded_hs65": hs, "phase_seconds": time.time() - t0})
    het = _hetero_row(gloo, hetero_out, fails)
    emit({"sharded_hetero_suite": het})
    rows, tsqr, f64row = _giant_rows(gloo, giant_kept, one64, fails)
    emit({"rowsharded_giant_m": rows, "tsqr_c": tsqr, "float64": f64row,
          "phase_seconds": time.time() - t0})
    graph_rows = _graph_rows(nccl, fails)
    emit({"sharded_graph": graph_rows, "nccl_rank_seconds": t_nccl})
    assert not fails, fails
    return hs, het, gloo, graph_rows


# ------------------------------------- batches of large problems, B1 lanes

# Chained Rosenbrock n=5000, the JAX bench's cr5000 configuration: its
# A_act^T (5000 x 4998) and J2 (9998 x 5000) exceed the resident route's
# shared memory, so B1 takes the panel route (the JAX package's
# _cpqr_xla_panels, as the TPU takes it above its VMEM gate).
CR5000 = 5000
PANEL_CASES = [
    # name, kind, rows, cols, nsteps, dtype: cr5000's A_act^T (every
    # step) and J2 (2 live columns at the end, as the solver hands it
    # over; the panels past the count are skipped)
    ("A_act^T cr5000, graded", "graded", 5000, 4998, 4998, torch.float32),
    ("A_act^T cr5000, graded", "graded", 5000, 4998, 4998, torch.float64),
    ("J2 cr5000", "trailing_live", 9998, 5000, 2, torch.float32),
    ("J2 cr5000", "trailing_live", 9998, 5000, 2, torch.float64),
]
LANES = 8


def _graded_matrix(rows, cols, dtype, seed):
    """Orthonormal columns times a geometric scale from 1 down to 1e-3,
    shuffled: every trailing norm is its column's own scale (the columns
    are orthogonal), 0.14 % apart at 4998 columns, so the pivot order is
    unambiguous in float32 through the last step."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn(rows, cols, generator=g,
                                       dtype=torch.float64, device=DEV))
    scale = torch.logspace(0, -3, cols, dtype=torch.float64, device=DEV)
    order = torch.randperm(cols, generator=g, device=DEV)
    return (Q * scale)[:, order].to(dtype).contiguous()


def check_b1_panels():
    """B1 at cr5000's two shapes in both dtypes through the dispatch,
    which must take the panel route, each against the panel loop's plain
    version (``_hold_against_plain``: float64 perm equal, packed R / tails
    / tau within 1e-9 relative, ||QR - M[:, perm]|| <= 1e-12 ||M||;
    float32 ||QR - M[:, perm]|| <= 1e-4 ||M||, perm equal on the graded
    matrix), with equal bits of two launches and of a launch on half the
    blocks; each row's ``launches`` is what one call counted.  The first
    row, A_act^T at float32, is the one the kernels line reports."""
    sms, shared, coop = cpqr_mod._device_limits(DEV)
    out = []
    for name, kind, rows, cols, nsteps, dtype in PANEL_CASES:
        assert b1_route(rows, cols, dtype, sms, shared, coop) == "panels", name
        M = (_graded_matrix(rows, cols, dtype, seed=11) if kind == "graded"
             else _case_matrix(kind, rows, cols, nsteps, dtype, seed=12))
        before = M.clone()
        torch.cuda.synchronize()
        reset_launch_counts()
        got = cpqr_hopper(M, nsteps)
        torch.cuda.synchronize()
        launches = {"cpqr_hopper": _graph.launches(cpqr_hopper),
                    "cpqr_hopper_panels": _graph.launches(cpqr_hopper_panels)}
        assert cpqr_hopper.last_route == "panels", (name, cpqr_hopper.last_route)
        assert launches == {"cpqr_hopper": 1, "cpqr_hopper_panels": 1}, launches
        again = cpqr_hopper(M, nsteps)
        half = cpqr_mod._launch("panels", M, nsteps, max(1, sms // 2))
        torch.cuda.synchronize()
        assert torch.equal(M, before), f"{name}: the input was modified"
        bits_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        blocks_equal = all(torch.equal(a, b) for a, b in zip(got, half))
        assert bits_equal and blocks_equal, (name, bits_equal, blocks_equal)
        del again, half
        plain = cpqr_panels_packed_plain(M, nsteps)
        errs = _hold_against_plain(f"{name} [panels]", kind, M, nsteps, got,
                                   plain)
        del got, plain
        bound_ms, bound_by, stream_ms = cpqr_bound(rows, cols, nsteps, dtype)
        out.append({
            "case": name, "route": "panels", "shape": [rows, cols],
            "nsteps": nsteps, "dtype": str(dtype).replace("torch.", ""),
            "main_path": True, "bits_equal": bits_equal,
            "bits_equal_half_the_blocks": blocks_equal, "launches": launches,
            **errs,
            "ms": cuda_ms(lambda: cpqr_hopper(M, nsteps), reps=3),
            "plain_ms": cuda_ms(lambda: cpqr_panels_packed_plain(M, nsteps),
                                reps=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "streamed_bytes_over_hbm_rate_ms": stream_ms, "library_ms": None})
        del M
    return out


LANE_CASES = [
    # name, kind, rows, cols, per-lane steps, route: the batched cr1000
    # path's A_act^T (uneven counts) and J2 (2 live columns a lane), and
    # lanes too large for shared memory (cr5000's J2)
    ("A_act^T batched cr1000", "normal", 1000, 998,
     [998, 998, 500, 2, 0, 998, 700, 998], "resident"),
    ("J2 batched cr1000", "trailing_live", 1998, 1000, [2] * LANES,
     "resident"),
    ("J2 cr5000 lanes", "trailing_live", 9998, 5000, [2, 1], "panels"),
]


def check_b1_lanes():
    """``cpqr_hopper_lanes`` on the lanes of the batched cr1000 path's two
    shapes (8 lanes) and of cr5000's J2 (2 lanes, the panel route), with
    per-lane step counts in device memory, against single ``cpqr_hopper``
    calls (held against the plain versions at these shapes by
    ``check_kernels`` and ``check_b1_panels``): equal bits, in both
    dtypes; the lanes' time against the single calls'."""
    out = []
    for name, kind, rows, cols, steps, want_route in LANE_CASES:
        lanes = len(steps)
        for dtype in (torch.float32, torch.float64):
            M = torch.stack([_case_matrix(kind, rows, cols, max(steps), dtype,
                                          seed=20 + b) for b in range(lanes)])
            ns = torch.tensor(steps, dtype=torch.int32, device=DEV)
            got = cpqr_hopper_lanes(M, ns)
            route = cpqr_hopper_lanes.last_route
            singles = [cpqr_hopper(M[b], ns[b]) for b in range(lanes)]
            torch.cuda.synchronize()
            equal = all(torch.equal(a[b], w) for b in range(lanes)
                        for a, w in zip(got, singles[b]))
            assert route == want_route and equal, (name, str(dtype), route,
                                                   equal)
            out.append({"case": name, "dtype": str(dtype).replace("torch.", ""),
                        "lanes": lanes, "shape": [rows, cols], "nsteps": steps,
                        "route": route, "bits_equal_single_calls": equal,
                        "ms": cuda_ms(lambda: cpqr_hopper_lanes(M, ns), reps=5),
                        "single_calls_ms": cuda_ms(
                            lambda: [cpqr_hopper(M[b], ns[b])
                                     for b in range(lanes)], reps=5)})
            del M, got, singles
    return out


def _cr_batch(n, B, dtype, seed=0):
    """Chained Rosenbrock(n) from B starts x0 + 0.1 N(0, 1) drawn by
    ``numpy.random.default_rng(seed)`` (the JAX bench's
    ``_small_n_batched`` recipe): (functions, starts, dims, tolerances)."""
    kw = chained_rosenbrock(n)
    model = et.CnlsModel(**kw)
    fns = _solve_functions(model, dtype, DEV)
    rng = np.random.default_rng(seed)
    x0 = np.asarray(kw["starting_point"], float)
    starts = x0[None, :] + 0.1 * rng.normal(size=(B, n))
    dims = et.Dims(n=n, m=model.nb_residuals, q=model.nb_eqcons,
                   l=total_nb_constraints(model))
    return fns, starts, dims, et.Tols.for_dtype(dtype, DEV)


# f of a batch lane against its own single solve on the card
LANE_F_RTOL = {torch.float32: 1e-3, torch.float64: 1e-9}


def batched_cr1000():
    """``solve_batched`` of Chained Rosenbrock n=1000 on 8 lanes at float32
    and float64 through the captured graph (its first call captures; the
    second is timed), then the eager loop on the same starts (x equal to
    the bit) and each lane's own ``et.solve`` from its start on the card
    (the same exit class, f within 1e-3 / 1e-9 relative).  Second
    derivatives are off, as ``et.solve`` turns them off from n + m = 1000
    on (the reference's rule).  Every lane's A_act^T (1000 x 998) and J2
    (1998 x 1000) is B1 once a lane."""
    rows = []
    kw = chained_rosenbrock(1000)
    for dtype in (torch.float32, torch.float64):
        fns, starts, dims, tols = _cr_batch(1000, LANES, dtype)
        opts = et.Options(second_derivatives=False)
        run = lambda g: solve_batched(fns, starts, dims, opts, tols,
                                      dtype=dtype, graph=g)
        _, first = _counted(lambda: run(True))
        held = CAPTURES[-1]["graph_held_GB"]
        res, timed = _counted(lambda: run(True))
        trips = run_batch.last_trips
        eager, eager_stats = _counted(lambda: run(False))
        eager_trips = run_batch.last_trips
        launches = timed["cpqr_hopper_lanes_launches"]
        row = {"dtype": str(dtype).replace("torch.", ""), "lanes": LANES,
               "seconds_per_batch_solve": timed["seconds"],
               "capturing_call_seconds": first["seconds"],
               "eager_seconds": eager_stats["seconds"], "trips": trips,
               "eager_trips": eager_trips, "readbacks": timed["readbacks"],
               "eager_readbacks": eager_stats["readbacks"],
               "cpqr_hopper_lanes_launches_by_route": launches,
               "launches_per_trip": sum(launches.values()) / max(trips, 1),
               "cpqr_hopper_single_launches": timed["cpqr_hopper_launches"],
               "capture_peak_GB": first["peak_GB"],
               "graph_held_GB": held,
               "replay_peak_GB": timed["peak_GB"],
               "eager_peak_GB": eager_stats["peak_GB"],
               "exit_codes": res.exit_code.tolist(),
               "iterations": res.n_iter.tolist(),
               "objective": res.f.double().tolist(),
               "x_bits_equal_eager": bool(torch.equal(res.x, eager.x)),
               "exit_codes_equal_eager": bool(torch.equal(res.exit_code,
                                                          eager.exit_code))}
        singles = []
        for b in range(LANES):
            one = et.solve(et.CnlsModel(**{**kw, "starting_point": starts[b]}),
                           dtype=dtype)
            f = et.sum_sq_residuals(one)
            singles.append({
                "status": et.status(one),
                "iterations": len(one.model_info.iterations_detail),
                "f_rel_diff": abs(float(res.f[b]) - f) / abs(f)})
            assert one.status_code == \
                et.convert_exit_code(int(res.exit_code[b])), (row, singles)
            assert singles[-1]["f_rel_diff"] <= LANE_F_RTOL[dtype], \
                (row, singles)
        row["single_solves"] = singles
        assert row["x_bits_equal_eager"] and row["exit_codes_equal_eager"], row
        assert trips == eager_trips and timed["readbacks"] <= 2, row
        assert launches["resident"] >= 2 * LANES * trips and \
            launches["panels"] == 0, row
        assert bool(torch.isfinite(res.x).all()) and \
            res.x.shape == (LANES, 1000), row
        rows.append(row)
    return rows


def solve_cr5000():
    """``et.solve`` of Chained Rosenbrock n=5000 (the JAX bench's
    ``bench_cr5000``) at float32 with ``matmul_precision`` "float32" and
    "bfloat16", and at float64: one warm-up (it captures), then one timed
    solve with the counts set to 0 just before it.  Every solve is
    first-order stationary with max |c| <= c_tol, one read-back, every B1
    factorization on the panel route; the float64 objective lies within
    1e-12 of the n=1000 reference value (f* does not depend on n), the
    float32 ones within 1e-3 of it."""
    kw = chained_rosenbrock(CR5000)
    sms, shared, coop = cpqr_mod._device_limits(DEV)
    rows = []
    for dtype, prec in ((torch.float64, "float32"), (torch.float32, "float32"),
                        (torch.float32, "bfloat16")):
        for shape in ((CR5000, CR5000 - 2), (2 * (CR5000 - 1), CR5000)):
            assert b1_route(*shape, dtype, sms, shared, coop) == "panels", shape
        et.solve(et.CnlsModel(**kw), dtype=dtype, matmul_precision=prec)
        model = et.CnlsModel(**kw)
        _, stats = _counted(lambda: et.solve(model, dtype=dtype,
                                             matmul_precision=prec))
        iters = len(model.model_info.iterations_detail)
        c_tol = float(np.sqrt(torch.finfo(dtype).eps))
        cmax = float(np.max(np.abs(et.equality_constraints_values(model))))
        row = {"dtype": str(dtype).replace("torch.", ""),
               "matmul_precision": prec, "status": et.status(model),
               "objective": et.sum_sq_residuals(model), "max_abs_c": cmax,
               "c_tol": c_tol, "iterations": iters,
               "seconds_per_solve": stats["seconds"],
               "readbacks": stats["readbacks"],
               "cpqr_route": cpqr_hopper.last_route,
               "cpqr_hopper_launches": stats["cpqr_hopper_launches"],
               "cpqr_hopper_panels_launches":
                   stats["cpqr_hopper_panels_launches"],
               "replay_peak_GB": stats["peak_GB"]}
        assert row["status"] == "found_first_order_stationary_point", row
        assert cmax <= c_tol and row["cpqr_route"] == "panels", row
        assert row["readbacks"] == 1, row
        assert row["cpqr_hopper_launches"] >= 2 * iters, row
        assert row["cpqr_hopper_panels_launches"] == \
            row["cpqr_hopper_launches"], row
        assert np.all(np.isfinite(et.solution(model)))
        rows.append(row)
    f64 = rows[0]["objective"]
    for row in rows:
        row["objective_rel_diff_vs_float64"] = abs(row["objective"] - f64) / f64
        assert row["objective_rel_diff_vs_float64"] <= 1e-3, rows
    assert abs(f64 - CR1000_FSTAR_REFERENCE) <= 1e-12 * CR1000_FSTAR_REFERENCE, f64
    return {"solves": rows, "float64_objective": f64,
            "cr1000_fstar_reference": CR1000_FSTAR_REFERENCE,
            "float64_rel_diff_vs_cr1000_reference":
                abs(f64 - CR1000_FSTAR_REFERENCE) / CR1000_FSTAR_REFERENCE}


SMALL_N_LANES = 1024


def small_n():
    """The JAX bench's ``bench_small_n``: single float32 solves of Chained
    Rosenbrock at n = 10 and n = 100 (warm: the first call captures; one
    read-back a solve), and n = 10 on 1024 lanes in one batch (seconds a
    solve and the converged share, which must be 1.0)."""
    out = {}
    dtype = torch.float32
    for n in (10, 100):
        kw = chained_rosenbrock(n)
        et.solve(et.CnlsModel(**kw), dtype=dtype)
        model = et.CnlsModel(**kw)
        _, stats = _counted(lambda: et.solve(model, dtype=dtype))
        out[f"n{n}"] = {"status": et.status(model),
                        "objective": et.sum_sq_residuals(model),
                        "iterations": len(model.model_info.iterations_detail),
                        "seconds_per_solve": stats["seconds"],
                        "readbacks": stats["readbacks"]}
        assert et.status(model) == "found_first_order_stationary_point", out
        assert stats["readbacks"] == 1, out
    fns, starts, dims, tols = _cr_batch(10, SMALL_N_LANES, dtype)
    run = lambda: solve_batched(fns, starts, dims, et.Options(), tols,
                                dtype=dtype)
    run()
    res, stats = _counted(run)
    share = float((res.exit_code > 0).double().mean())
    out["n10_batched"] = {
        "lanes": SMALL_N_LANES, "seconds_per_batch_solve": stats["seconds"],
        "seconds_per_solve": stats["seconds"] / SMALL_N_LANES,
        "trips": run_batch.last_trips, "readbacks": stats["readbacks"],
        "cpqr_batched_launches": stats["cpqr_batched_launches"],
        "converged_share": share,
        "exit_codes": _exit_code_counts(res.exit_code.cpu().numpy())}
    assert share == 1.0 and stats["cpqr_batched_launches"] > 0, out
    return out


EXAMPLES = ["torch_single_solve", "torch_batched_scenarios",
            "torch_multistart", "torch_checkpoint_resume", "torch_giant_m",
            "torch_mixed_suite"]


def examples():
    """Each torch example at its default size on the card, its output
    captured (the last lines kept) and its outcome held."""
    import contextlib
    import importlib.util
    import io
    out = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        _graph.clear_graph_cache()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            got = mod.main([])
        torch.cuda.synchronize()
        out[name] = {"seconds": time.time() - t0,
                     "output": buf.getvalue().strip().splitlines()[-4:]}
        if name == "torch_single_solve":
            assert et.status(got) == "found_first_order_stationary_point"
        elif name == "torch_batched_scenarios":
            assert got >= 0.95, (name, got)
        elif name == "torch_giant_m":
            res, active = got
            assert res.exit_code > 0 and active >= 5, (name, out[name])
        elif name == "torch_mixed_suite":
            assert min(got.values()) >= 0.95, (name, got)
        # torch_multistart and torch_checkpoint_resume assert their own
    return out


def profile_solve(solve, kernel=None):
    """One warm solve under torch.profiler, with spans off (the warm
    call's graph, replayed): wall seconds, the sum of
    device kernel time, the busy share, and the top kernels by name; with
    ``kernel``, also the time, calls and share of device time of the
    kernels whose name holds that string."""
    from torch.profiler import ProfilerActivity, profile
    from enlsip_tpu_torch.utils import profiling
    solve()
    torch.cuda.synchronize()
    # spans off under the profiler too, so that the profiled call replays
    # the warm call's graph (tracing is part of the graph's key)
    profiling.enable(False)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            solve()
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        profiling.enable(None)
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


def _panels_kernel_entry(pcases, cases, cr5000, lanes):
    """The ``kernels`` entry of B1's panel route: timed at cr5000's A_act^T
    float32 (``b1_panels``' first row), its launches those of the cr5000
    float32 solve (``solve_cr5000``, counts set to 0 just before it)."""
    head = pcases[0]
    mine = pcases + [c for c in cases if c["route"] == "panels"]
    errs = [c["max_abs_err"] if c["max_abs_err"] is not None
            else c["recon_rel_err"] for c in mine]
    by_path = {f"single_solve_cr5000_{r['dtype']}_{r['matmul_precision']}":
               r["cpqr_hopper_panels_launches"] for r in cr5000["solves"]}
    assert all(v > 0 for v in by_path.values()), \
        ("the cr5000 path never launched the panel kernel", by_path)
    return {
        "name": "cpqr_hopper_panels", "route": "cuda",
        "source": "enlsip_tpu_torch/csrc/cpqr_panels.cu",
        "replaces": "enlsip_tpu/ops/pallas_qr2.py:34",
        "computes": "enlsip_tpu/ops/blocked_qr.py:192 (_cpqr_xla_panels, what "
                    "the JAX package runs where the Pallas kernel's VMEM gate "
                    "turns a matrix away)",
        "launches": by_path["single_solve_cr5000_float32_float32"],
        "launches_by_path": by_path,
        "max_abs_err": max(errs),
        "tolerance": "against the panel loop's plain version; float64: perm "
                     "equal, packed R/tails/tau within 1e-9 relative, "
                     "||QR - M[:,perm]|| <= 1e-12 ||M||; float32: ||QR - "
                     "M[:,perm]|| <= 1e-4 ||M||, perm equal on the graded "
                     "matrix; two launches and two block counts give equal "
                     "bits",
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "timed_at": "5000x4998 float32, nsteps 4998 (A_act^T of cr5000, "
                    "graded)",
        "lanes": [row for row in lanes if row["route"] == "panels"],
        "cases": pcases}


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

    track_captures()
    t0 = time.time()
    _build.build_all()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    ptxas = {n: _build.resource_usage(n) for n in sources}
    dmma = _build.sass_opcodes(_build.library_path("wy_gram_f64"), "DMMA")
    emit({"build": {"seconds": time.time() - t0,
                    "sources": [f"{n}.cu" for n in sources],
                    "ptxas": ptxas, "sass_dmma_wy_gram_f64": dmma}})
    # the float64 WY kernel's products are float64 tensor-core mma, and
    # none of its instantiations spills
    f64_kernels = [r for r in ptxas["wy_gram_f64"]
                   if "wy_gram_f64_kernel" in r["kernel"]]
    assert f64_kernels and all(dmma.get(r["kernel"], 0) > 0
                               and r.get("spill_bytes") == [0, 0]
                               for r in f64_kernels), (f64_kernels, dmma)

    check_shared_memory_mirrors()
    emit({"grid_barrier_us": grid_barrier_us()})
    cases = check_kernels()
    emit({"resident_ms_by_blocks_1000x998_f32": resident_by_blocks()})
    bcases = check_batched_kernels()
    emit({"batched_group_sweep": batched_group_sweep()})
    wcases = check_wy_kernels()
    emit({"wy_kernel_cases": wcases})
    emit({"graph_kernel_cases": graph_kernel_cases()})
    _graph.clear_graph_cache()
    panels5000 = check_b1_panels()
    emit({"b1_panels": panels5000})
    lanes = check_b1_lanes()
    emit({"b1_lanes": lanes})
    l2_rate = l2_copy_rate()
    if "--kernels-only" in sys.argv:
        emit({"kernel_cases": cases, "batched_kernel_cases": bcases,
              "l2_copy_GBps": l2_rate})
        return

    large = ("lanes", "single")     # every factorization has >= 192 pivots
    solves = phase("solve", lambda: [solve_cr1000(torch.float32),
                                     solve_cr1000(torch.float64)], large)
    launches_main = solves[0]["cpqr_hopper_launches"]
    phase("small", solve_small)
    hs65_stats = phase("batched_hs65", batched_hs65)
    ode_stats = phase("batched_ode_fit", batched_ode_fit)
    phase("batch_lanes_equal_single", batch_lanes_equal_single)
    cr1000_rows = phase("batched_cr1000", batched_cr1000, large)
    cr5000 = phase("solve_cr5000", solve_cr5000, large)
    phase("small_n", small_n)
    giant, gm, giant_kept = phase("giant_m", solve_giant_m)
    _graph.clear_graph_cache()
    giant64 = phase("giant_m_float64", giant_m_float64)["rows"]
    phase("giant_m_float64_10m",
          lambda: giant_m_float64(GIANT64_10M_ROWS, replays=1))
    phase("device_loop", device_loop)
    hs_rows = phase("hs_suite", hs_suite)
    hetero_stats, hfams, hfused, hopts, hetero_out = phase("hetero_suite",
                                                          hetero_suite)
    stats_100k = phase("hetero_100k", hetero_100k)
    newton_stats = phase("hetero_newton", hetero_newton)
    phase("hetero_lanes_equal_bucketed", hetero_lanes_equal_bucketed)
    phase("checkpoint_resume", checkpoint_resume)
    phase("examples", examples)
    _graph.clear_graph_cache()
    sharded_hs, sharded_het, gloo, graph_rows = multi_rank_phases(
        hetero_out, giant_kept)
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

    assert not RANK1_FAULTS, ("a rank-1 route ran on the card", RANK1_FAULTS)
    assert launches_main > 0, "the main path never launched cpqr_hopper"
    launches_by_path = {
        "batched_hs65": hs65_stats["cpqr_batched_launches"],
        "batched_ode_fit": ode_stats["cpqr_batched_launches"],
        "hs_suite_float32": hs_rows["float32"]["cpqr_batched_launches"],
        "hetero_suite": hetero_stats["cpqr_batched_launches"],
        "hetero_100k": stats_100k["cpqr_batched_launches"],
        "hetero_newton": newton_stats["cpqr_batched_launches"],
        **{f"sharded_hs65_{k}_rank{r}": n for k, row in sharded_hs.items()
           for r, n in enumerate(row["cpqr_batched_launches_by_rank"])},
        **{f"sharded_hetero_suite_rank{r}": n for r, n in
           enumerate(sharded_het["cpqr_batched_launches_by_rank"])},
        **{f"sharded_graph_{row['path']}_nccl_replay":
           row["graph"]["launches"]["cpqr_batched_packed"]
           for row in graph_rows
           if row["kernel"] == "cpqr_batched_packed"}}
    assert all(v > 0 for v in launches_by_path.values()), \
        ("a batched path never launched cpqr_batched_packed", launches_by_path)
    launches_batched = sum(launches_by_path.values())
    route_main = solves[0]["cpqr_route"]
    assert route_main == "resident", route_main
    head = next(c for c in cases
                if c["main_path"] and c["dtype"] == "float32"
                and c["nsteps"] == 998 and c["route"] == route_main)
    errs = [c["max_abs_err"] if c["max_abs_err"] is not None
            else c["recon_rel_err"] for c in cases + panels5000]
    b1_by_path = {
        "single_solve_cr1000_float32": launches_main,
        "single_solve_cr1000_float64": solves[1]["cpqr_hopper_launches"],
        **{f"single_solve_cr5000_{r['dtype']}_{r['matmul_precision']}":
           r["cpqr_hopper_launches"] for r in cr5000["solves"]},
        **{f"batched_cr1000_{r['dtype']}_lanes":
           r["cpqr_hopper_lanes_launches_by_route"] for r in cr1000_rows}}
    assert all(sum(r["cpqr_hopper_lanes_launches_by_route"].values()) > 0
               for r in cr1000_rows), b1_by_path
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
        "launches_by_path": b1_by_path,
        "panels_5000x4998": {k: panels5000[0][k] for k in (
            "perm_equal", "recon_rel_err", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "streamed_bytes_over_hbm_rate_ms")},
        "lanes_8": lanes,
        "l2_copy_GBps": l2_rate,
        "cases": cases + panels5000}, _panels_kernel_entry(
            panels5000, cases, cr5000, lanes),
        _batched_kernel_entry(bcases, launches_batched,
                                              launches_by_path),
        *_wy_kernel_entries(wcases, giant, gloo, graph_rows, giant64)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
