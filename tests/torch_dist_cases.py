"""Rank side of the port's multi-device tests: gloo ranks on the CPU.

``spawn_ranks(suite, world, out_dir)`` starts ``world`` processes of this
file (``python torch_dist_cases.py SUITE RANK WORLD DIR``), each one rank
of a gloo process group created with a timeout, and returns every rank's
results; a rank that fails, or a spawn that outlives its deadline, fails
the caller.  The ranks run every case of the suite (``sharding`` or
``rows``) and save their results with ``torch.save``.  This module
imports torch and the port only, so the spawned ranks stay light; the
test files compare the results with the JAX package.

With four ranks, the two-rank cases run on two groups at once, {0, 1}
and {2, 3} (each a mesh of D = 2), and the four-rank cases on all four.
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
GROUP_TIMEOUT_S = 60
DEADLINE_S = 120


def spawn_ranks(suite: str, world: int, out_dir) -> list:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(world), str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    end = time.time() + DEADLINE_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, end - time.time()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:])
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    return [torch.load(out_dir / f"{suite}_rank{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------ problems

def hs65_starts(B: int, seed: int) -> np.ndarray:
    """HS65 starts as ``torch_port_helpers.hs65_batch_setup`` draws them."""
    from enlsip_tpu_torch.problems import classic
    rng = np.random.default_rng(seed)
    x0 = np.asarray(classic.HS65["starting_point"])
    return x0[None, :] + 0.3 * rng.normal(size=(B, 3))


def hs65_functions(device="cpu"):
    import enlsip_tpu_torch as et
    from enlsip_tpu_torch.models.model import _model_functions
    from enlsip_tpu_torch.problems import classic
    return et.Functions(*_model_functions(et.CnlsModel(**classic.HS65),
                                          torch.float64, device))


# Lanes of the batch the card-side case (tests marked gpu) splits.
CARD_LANES = 512


HS65_DIMS = (3, 3, 0, 7)
SUITE_FAMILIES = ["hs14", "hs65", "hs26", "hs53", "hs79"]

# The row-sharded problem of tests/test_rowsharded.py: N = 8 parameters,
# M = 512 residual rows, L = 4 inequalities, the same numpy draws.
ROWS_N, ROWS_M, ROWS_L = 8, 512, 4


def rows_problem():
    """(Functions, Dims, Options, Tols) of tests/test_rowsharded.py's
    problem on the port, float64 on the CPU."""
    import enlsip_tpu_torch as et
    rng = np.random.default_rng(0)
    T = np.linspace(0.0, 1.0, ROWS_M)
    W = torch.tensor(rng.normal(size=(ROWS_M, ROWS_N)) / np.sqrt(ROWS_N))
    Y = torch.tensor(np.sin(3 * T) + 0.1 * rng.normal(size=ROWS_M))

    def res(x):
        z = W @ x
        return Y - (z + 0.1 * torch.tanh(z))

    def ineq(x):
        return torch.cat([x[:ROWS_L - 1] + 1.0, (4.0 - x @ x)[None]])

    fns = et.Functions(res=res, jac_res=torch.func.jacfwd(res), cons=ineq,
                       jac_cons=torch.func.jacfwd(ineq))
    rel = float(np.sqrt(np.finfo(float).eps))
    tols = et.Tols(*(torch.tensor(v, dtype=torch.float64)
                     for v in (1e-10, rel, rel, rel, rel)))
    return (fns, et.Dims(n=ROWS_N, m=ROWS_M, q=0, l=ROWS_L),
            et.Options(second_derivatives=False, max_iter=30), tols)


# The tall cases: the giant-m problem at 8192 x 16, 3 inequalities.
TALL = dict(m=8192, n=16, l=3, seed=3)
TALL_CASES = {"dense_cholqr": (False, False, "cholqr"),
              "dense_qr": (False, False, "qr"),
              "factored": (True, False, "cholqr"),
              "factored_second_derivatives": (True, True, "cholqr")}


def tall_solve_args(case: str, shard=None):
    import enlsip_tpu_torch as et
    from enlsip_tpu_torch.problems.giant_m import giant_m
    factored, second, tall_qr = TALL_CASES[case]
    gm = giant_m(**TALL, dtype=torch.float64, device="cpu", shard=shard)
    opts = et.Options(second_derivatives=second, tall_qr=tall_qr)
    return (gm.factored if factored else gm.dense, gm.x0, gm.dims, opts,
            et.Tols.for_dtype(torch.float64))


def trace_of(carry) -> tuple:
    """(method code, t, rankA) of the iteration that just ran."""
    p = carry.prev
    return int(p.code), int(p.t), int(p.rankA)


def _batch_result(res) -> dict:
    return {"exit_code": res.exit_code, "x": res.x, "f": res.f,
            "n_iter": res.n_iter}


# ---------------------------------------------------------- rank cases

def _meshes(rank, world, axis):
    """{D: mesh}: D = 2 on the pair holding ``rank``, D = world on all."""
    import torch.distributed as dist
    from enlsip_tpu_torch._dist import make_mesh
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])] \
        if world == 4 else []
    out = {world: make_mesh(device="cpu", axis=axis)}
    if pairs:
        out[2] = make_mesh(pairs[rank // 2], device="cpu", axis=axis)
    return out


def sharding_cases(rank, world) -> dict:
    from enlsip_tpu_torch import _dist
    from enlsip_tpu_torch.core.types import Dims, Options, Tols
    from enlsip_tpu_torch.parallel import (fuse_families,
                                           global_from_process_local,
                                           hs_scenario_batch,
                                           local_lanes, run_batch,
                                           solve_batched_sharded,
                                           solve_batched_sharded_mp,
                                           solve_suite_batched,
                                           solve_suite_fused)
    fns, dims = hs65_functions(), Dims(*HS65_DIMS)
    tols = Tols.for_dtype(torch.float64)
    f64 = torch.float64
    out = {}
    for D, mesh in _meshes(rank, world, "batch").items():
        for B, seed in ((8, 1), (10, 2)):
            _dist.reset_collective_count()
            res = solve_batched_sharded(fns, hs65_starts(B, seed), dims,
                                        Options(), tols, mesh=mesh, dtype=f64,
                                        graph=False)
            out[f"hs65_B{B}_D{D}"] = dict(
                _batch_result(res), trips=run_batch.last_trips,
                collectives=_dist.collective_count())
        mine = local_lanes(torch.as_tensor(hs65_starts(8, 1)), mesh)
        for every in (1, 3):
            res = solve_batched_sharded_mp(fns, mine, dims, Options(), tols,
                                           mesh=mesh, dtype=f64,
                                           check_every=every, graph=False)
            out[f"mp_D{D}_every{every}"] = dict(
                _batch_result(res), local_x=local_lanes(res.x, mesh),
                mine=mine,
                regathered=global_from_process_local(mesh, {"x0": mine}))
        fams = hs_scenario_batch(SUITE_FAMILIES, per_family=4, seed=1,
                                 device="cpu")
        opts = Options(max_iter=60, second_derivatives=False)
        fused = solve_suite_fused(fams, opts, Tols.for_dtype, mesh=mesh,
                                  dtype=f64, fused=fuse_families(fams, "cpu"),
                                  graph=False)
        bucketed = solve_suite_batched(fams, opts, Tols.for_dtype, mesh=mesh,
                                       dtype=f64, graph=False)
        out[f"suite_D{D}"] = {
            "fused": {k: _batch_result(v) for k, v in fused.items()},
            "bucketed": {k: _batch_result(v) for k, v in bucketed.items()}}
    return out


def _weight_case(seed, l=6, m=8):
    """tests/test_torch_core_small.py's random weight-update state, with m
    rows that divide over four ranks."""
    rng = np.random.default_rng(seed)
    t = int(rng.integers(0, l + 1))
    dimA = int(rng.integers(0, t + 1))
    perm = rng.permutation(l)
    ag = np.concatenate([np.sort(perm[:t]), np.sort(perm[t:])])
    valid = np.arange(l) < t
    w_old = rng.uniform(0.01, 0.2, l)
    K = np.sort(rng.uniform(0.01, 0.3, (4, l)), axis=0)[::-1].copy()
    Jp, rx = rng.normal(size=m), rng.normal(size=m)
    cx, aAp = rng.normal(size=l), rng.normal(size=l) * valid
    if seed % 5 == 0:
        cx[:] = 0.0
    tt = lambda a: torch.tensor(np.asarray(a))
    return [tt(v) for v in (w_old, Jp, aAp, K, rx, cx, ag, valid, t, dimA)]


# (seed, scale, alpha_prev) of tests/test_torch_linesearch.py's STPLNG
# cases, on the twin problem with n = 5, m = 8, q = 2, two inequalities
# and two bounds.
STEP_CASES = [(0, 1.0, 1.0), (1, 1.0, 1.0), (2, 1.0, 0.05), (3, 8.0, 1.0),
              (4, 8.0, 0.3), (5, 30.0, 1.0)]


def _max_diff(a, b) -> float:
    """Largest |a - b| / (1 + |a|) over the pairs of outputs."""
    pairs = zip(a, b) if isinstance(a, (tuple, list)) else [(a, b)]
    f64 = lambda u: torch.as_tensor(u, dtype=torch.float64)
    return max(float(((f64(u) - f64(v)).abs() / (1.0 + f64(u).abs())).max())
               for u, v in pairs)


def unit_cases(mesh) -> dict:
    """Each solver function that contracts the residual rows, on this
    rank's rows inside the row scope, against the same function on all
    rows outside it: the largest relative difference of its outputs
    (``inf`` where a count or code differs)."""
    from enlsip_tpu_torch import _dist
    from enlsip_tpu_torch.core import linesearch as tls, subproblem as tsp
    from enlsip_tpu_torch.core import weights as tw
    from enlsip_tpu_torch.core.types import (Counters, Dims, PrevIter, Tols,
                                             working_view)
    from enlsip_tpu_torch.ops.qr import pseudo_rank
    from torch_port_helpers import twin_data, twin_torch_functions

    def mine(v):
        rows = v.shape[0] // mesh.size
        return v[mesh.rank * rows:(mesh.rank + 1) * rows]

    out = {}
    for seed in range(12):
        for code in (0, 2):
            w_old, Jp, aAp, K, rx, cx, ag, valid, t, dimA = _weight_case(seed)
            dims = Dims(4, rx.shape[0], 0, cx.shape[0])
            full = tw.penalty_weight_update(w_old, Jp, aAp, K, rx, cx, ag,
                                            valid, t, dimA, code, dims, 16)
            with _dist.row_scope(mesh):
                shard = tw.penalty_weight_update(w_old, mine(Jp), aAp, K,
                                                 mine(rx), cx, ag, valid, t,
                                                 dimA, code, dims, 16)
            out[f"weights_{seed}_{code}"] = _max_diff(full, shard)
    eps_rank = Tols.for_dtype(torch.float64).eps_rank
    for seed, scale, alpha_prev in STEP_CASES:
        d, x0 = twin_data(seed, 5, 8, 2, 2, (0, 3), (), scale=scale)
        res, jac, cons, jac_cons = twin_torch_functions(d, (0, 3), ())
        x = torch.tensor(x0)
        rx, J, cx, A = res(x), jac(x), cons(x), jac_cons(x)
        dims = Dims(5, 8, 2, cx.shape[0])
        mask = torch.arange(dims.l) < dims.q
        view = working_view(mask)
        act = tsp.gather_active(A, cx, view, dims, False)
        F_A = tsp.factor_active(act, J.T @ rx, view.t, dims)
        rankA = pseudo_rank(F_A.diag, view.t, eps_rank)
        l11 = tsp.factor_l11(F_A, act, view.t)
        z11 = tsp.zeros_factor_l11(dims, torch.float64, "cpu")

        def gn(J, rx, axis=None):
            return tsp.gn_search_direction(J, rx, act, F_A, z11, rankA,
                                           view.t, eps_rank, dims,
                                           tsqr_axis=axis)

        full = gn(J, rx)
        with _dist.row_scope(mesh):
            for axis in (None, "rows"):
                sh = gn(mine(J), mine(rx), axis)
                # d past rankJ2 is a rotation of the complement, which
                # depends on the factorization: its norm is what compares
                k = int(full.rankJ2)
                out[f"gn_{seed}_{axis}"] = max(
                    _max_diff((full.p, full.y, full.rankJ2),
                              (sh.p, sh.y, sh.rankJ2)),
                    _max_diff(full.d[:k].abs(), sh.d[:k].abs()),
                    _max_diff(full.d.norm(), sh.d.norm()))
        lam = torch.tensor(np.random.default_rng(seed).normal(size=dims.tmax))
        full_nt = tsp.newton_search_direction(res, cons, x, rx, lam, view,
                                              act, F_A, l11, full.JQ1, rankA,
                                              view.t, dims)
        with _dist.row_scope(mesh):
            sh_nt = tsp.newton_search_direction(
                lambda z: mine(res(z)), cons, x, mine(rx), lam, view, act,
                F_A, l11, mine(full.JQ1), rankA, view.t, dims)
        out[f"newton_{seed}"] = _max_diff(full_nt, sh_nt)
        prev = PrevIter(
            x=x, rx_sum=torch.tensor(1.0, dtype=torch.float64),
            cx_sum=torch.tensor(1.0, dtype=torch.float64),
            t=torch.tensor(2), alpha=torch.tensor(alpha_prev,
                                                  dtype=torch.float64),
            beta=torch.tensor(0.0, dtype=torch.float64), code=torch.tensor(1),
            w=torch.clamp(cx.abs() + 0.01, max=0.1),
            progress=torch.tensor(0.0, dtype=torch.float64),
            predicted_reduction=torch.tensor(0.0, dtype=torch.float64),
            rankA=torch.tensor(0), rankJ2=torch.tensor((seed % 2) * 9),
            dimA=torch.tensor(0), dimJ2=torch.tensor(0))
        K = torch.full((4, dims.l), 0.1, dtype=torch.float64)
        for flip in (False, True):
            for code in (1, 2):
                p = full.p * (-1.0 if flip else 1.0)

                def step(trial, rx, J):
                    return tls.compute_steplength(
                        trial, cons, x, rx, J, cx, A, act, view, view.t, p,
                        view.t, full.rankJ2, code, torch.tensor(-1), prev,
                        K, mask, dims, 2, Counters.zeros(), 30, 60, 16,
                        False)

                a = step(lambda xx, pp: (lambda al: res(xx + al * pp)), rx, J)
                with _dist.row_scope(mesh):
                    b = step(lambda xx, pp: (lambda al: mine(res(xx + al * pp))),
                             mine(rx), mine(J))
                same = (tuple(a.counters) == tuple(b.counters)
                        and int(a.psi_error) == int(b.psi_error)
                        and int(a.index_alpha_upp) == int(b.index_alpha_upp))
                out[f"steplength_{seed}_{flip}_{code}"] = (
                    _max_diff((a.alpha, a.w, a.K, a.predicted_reduction,
                               a.progress),
                              (b.alpha, b.w, b.K, b.predicted_reduction,
                               b.progress)) if same else float("inf"))
    return out


def rows_cases(rank, world) -> dict:
    from enlsip_tpu_torch import _dist
    from enlsip_tpu_torch.ops.blocked_qr import cpqr_blocked
    from enlsip_tpu_torch.ops.rows_qr import cpqr_rows, qt_apply_rows
    from enlsip_tpu_torch.ops.tsqr import (cholqr_cpqr, qt_apply_cholqr,
                                           qt_apply_tsqr, tsqr_cpqr)
    from enlsip_tpu_torch.parallel import local_functions, solve_rowsharded
    out = {}
    fns, dims, opts, tols = rows_problem()
    rng = np.random.default_rng(1)
    M = torch.tensor(rng.normal(size=(256, 8)))
    v = torch.tensor(rng.normal(size=256))
    for D, mesh in _meshes(rank, world, "rows").items():
        def solve(f, x0, d, o, t, tsqr=False):
            trace = []
            _dist.reset_collective_count()
            c = solve_rowsharded(f, x0, d, o, t, mesh=mesh, tsqr=tsqr,
                                 on_iteration=lambda c: trace.append(
                                     trace_of(c)), graph=False)
            with _dist.row_scope(mesh):
                f_val = _dist.rows_dot(c.rx, c.rx)
            return {"x": c.x, "f": f_val, "exit_code": int(c.exit_code),
                    "n_iter": int(c.nb_iter), "trace": trace,
                    "active": c.active_mask,
                    "collectives": _dist.collective_count()}

        lf = local_functions(fns, dims, mesh)
        x0 = torch.zeros(ROWS_N, dtype=torch.float64)
        for tsqr in (False, True):
            out[f"rows_D{D}_tsqr{tsqr}"] = solve(lf, x0, dims, opts, tols,
                                                tsqr)
        out[f"rows_D{D}_tsqr_qr"] = solve(
            lf, x0, dims, dataclasses.replace(opts, tall_qr="qr"), tols, True)
        for case in TALL_CASES:
            out[f"tall_{case}_D{D}"] = solve(
                *tall_solve_args(case, (mesh.rank, D)))
        rows = 256 // D
        sl = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
        with _dist.row_scope(mesh):
            f = tsqr_cpqr(M[sl], nsteps=8, axis="rows")
            d = qt_apply_tsqr(f, v[sl])
            g = cpqr_rows(M[sl], 8, mesh)
            dg = qt_apply_rows(g, v[sl])
            c = cholqr_cpqr(M[sl], nsteps=8)
            dc = qt_apply_cholqr(c, v[sl])
        out[f"tsqr_D{D}"] = {"perm": f.perm, "R": f.R, "d": d}
        out[f"pivot_loop_D{D}"] = {"perm": g.perm, "R": g.R, "d": dg}
        out[f"cholqr_D{D}"] = {"perm": c.perm, "R": c.R, "d": dc}
        out[f"units_D{D}"] = unit_cases(mesh)
    direct = cpqr_blocked(M, nsteps=8, device="cpu")
    out["direct"] = {"perm": direct.perm, "R": direct.R}
    return out


def card_cases(rank, world) -> dict:
    """HS65 x CARD_LANES float64 split over ranks sharing the card (gloo),
    with the batched kernel's launches on this rank."""
    from enlsip_tpu_torch.core.types import Dims, Options, Tols
    from enlsip_tpu_torch.ops.blocked_qr import cpqr_blocked
    from enlsip_tpu_torch.ops.cpqr_batched_hopper import cpqr_batched_packed
    from enlsip_tpu_torch.parallel import batch_mesh, solve_batched_sharded
    mesh = batch_mesh()
    cpqr_batched_packed.launches = 0
    cpqr_blocked.cuda_rank1["lanes"] = 0
    res = solve_batched_sharded(
        hs65_functions(mesh.device), hs65_starts(CARD_LANES, 4),
        Dims(*HS65_DIMS), Options(), Tols.for_dtype(torch.float64,
                                                     mesh.device),
        mesh=mesh, dtype=torch.float64, graph=False)
    return {"exit_code": res.exit_code.cpu(), "x": res.x.cpu(),
            "launches": cpqr_batched_packed.launches,
            "rank1_lanes": cpqr_blocked.cuda_rank1["lanes"]}


# The row-sharded pivot loop at kmax >= 192 (the reference's sharded
# cpqr_blocked takes the downdated-norm panel loop there): a 400 x 200
# buffer built so that the exact-norm and the downdated-norm rules pick
# different pivots at step 1, by exact arithmetic rather than rounding.
# Column 0 (2^28 e_0) pivots first and its reflector negates row 0
# exactly.  Column 5 is 2^27 e_0 + e_300: its norm^2 2^54 + 1 rounds to
# 2^54 at the panel start, so the downdate by R's row 0 leaves exactly 0
# although 1 remains; column 7 (0.5 e_10 + 0.5 e_250, norm^2 0.5) beats
# every other column (0.01 N(0, 1) entries).  Exact norms pivot column 5
# at step 1, downdated ones column 7.
LARGE_QR = dict(m=400, n=200, seed=5)


def large_qr_matrix() -> np.ndarray:
    rng = np.random.default_rng(LARGE_QR["seed"])
    M = 0.01 * rng.normal(size=(LARGE_QR["m"], LARGE_QR["n"]))
    M[:, 0], M[0, 0] = 0.0, 2.0 ** 28
    M[:, 5], M[0, 5], M[300, 5] = 0.0, 2.0 ** 27, 1.0
    M[:, 7], M[10, 7], M[250, 7] = 0.0, 0.5, 0.5
    return M


def _readbacks(fn):
    """(fn(), the read-backs it took)."""
    from enlsip_tpu_torch import _device
    _device.reset_readback_count()
    out = fn()
    return out, _device.readback_count()


def _raises(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def graph_cases(rank, world) -> dict:
    """Every sharded entry point with graph=True (on the CPU: the
    rehearsal of the device-resident code under forbid_readbacks) and
    graph=False on the same inputs, with the read-backs of each solve and
    the refusals of graph=True."""
    from enlsip_tpu_torch import _dist, _graph
    from enlsip_tpu_torch._dist import Mesh
    from enlsip_tpu_torch.core.types import Dims, Options, Tols
    from enlsip_tpu_torch.ops.rows_qr import cpqr_rows
    from enlsip_tpu_torch.parallel import (fuse_families, hs_scenario_batch,
                                           local_functions, local_lanes,
                                           run_batch, solve_batched_sharded,
                                           solve_batched_sharded_mp,
                                           solve_rowsharded,
                                           solve_suite_fused)
    fns, dims = hs65_functions(), Dims(*HS65_DIMS)
    tols = Tols.for_dtype(torch.float64)
    f64 = torch.float64
    out = {}
    for D, mesh in _meshes(rank, world, "batch").items():
        for graph in (True, False):
            tag = f"D{D}_graph{graph}"
            res, rb = _readbacks(lambda: solve_batched_sharded(
                fns, hs65_starts(8, 1), dims, Options(), tols, mesh=mesh,
                dtype=f64, graph=graph))
            out[f"hs65_{tag}"] = dict(_batch_result(res), readbacks=rb,
                                      trips=run_batch.last_trips)
            mine = local_lanes(torch.as_tensor(hs65_starts(8, 1)), mesh)
            for every in (1, 3):
                res, rb = _readbacks(lambda: solve_batched_sharded_mp(
                    fns, mine, dims, Options(), tols, mesh=mesh, dtype=f64,
                    check_every=every, graph=graph))
                out[f"mp_{tag}_every{every}"] = dict(
                    _batch_result(res), readbacks=rb,
                    trips=run_batch.last_trips)
            fams = hs_scenario_batch(SUITE_FAMILIES, per_family=4, seed=1,
                                     device="cpu")
            fused = solve_suite_fused(
                fams, Options(max_iter=60, second_derivatives=False),
                Tols.for_dtype, mesh=mesh, dtype=f64,
                fused=fuse_families(fams, "cpu"), graph=graph)
            out[f"suite_{tag}"] = {k: _batch_result(v)
                                   for k, v in fused.items()}
        # a gloo group with tensors off the CPU (a meta device stands in
        # for the card) refuses the device-resident path
        off = Mesh(mesh.group, mesh.size, mesh.rank, torch.device("meta"),
                   mesh.axis)
        with _graph._mode("emulate"):
            gloo_collective = _raises(lambda: _dist.all_reduce(
                torch.zeros(2, device="meta"), mesh))
        out[f"refusals_batch_D{D}"] = {
            "gloo_collective_device_resident": gloo_collective,
            "gloo_off_cpu_sharded": _raises(lambda: solve_batched_sharded(
                fns, hs65_starts(8, 1), dims, Options(), tols, mesh=off,
                dtype=f64))}

    rfns, rdims, ropts, rtols = rows_problem()
    M = torch.tensor(large_qr_matrix())
    for D, mesh in _meshes(rank, world, "rows").items():
        lf = local_functions(rfns, rdims, mesh)
        x0 = torch.zeros(ROWS_N, dtype=f64)
        problems = {"dense": (lf, x0, rdims, ropts, rtols, False),
                    "tsqr": (lf, x0, rdims, ropts, rtols, True),
                    "factored": (*tall_solve_args("factored", (mesh.rank, D)),
                                 False)}
        for name, (f, x, d, o, t, tsqr) in problems.items():
            for graph in (True, False):
                _dist.reset_collective_count()
                c, rb = _readbacks(lambda: solve_rowsharded(
                    f, x, d, o, t, mesh=mesh, tsqr=tsqr, graph=graph))
                with _dist.row_scope(mesh):
                    f_val = _dist.rows_dot(c.rx, c.rx)
                out[f"rows_{name}_D{D}_graph{graph}"] = {
                    "x": c.x, "f": f_val, "exit_code": int(c.exit_code),
                    "n_iter": int(c.nb_iter), "readbacks": rb,
                    "collectives": _dist.collective_count(),
                    "last": solve_rowsharded.last if graph else None}
        off = Mesh(mesh.group, mesh.size, mesh.rank, torch.device("meta"),
                   mesh.axis)
        out[f"refusals_rows_D{D}"] = {
            "on_iteration": _raises(lambda: solve_rowsharded(
                lf, x0, rdims, ropts, rtols, mesh=mesh,
                on_iteration=lambda c: None)),
            "gloo_off_cpu": _raises(lambda: solve_rowsharded(
                lf, x0, rdims, ropts, rtols, mesh=off))}
        rows = LARGE_QR["m"] // D
        block = M[mesh.rank * rows:(mesh.rank + 1) * rows]
        with _dist.row_scope(mesh):
            f = _graph.run(None, lambda b: cpqr_rows(
                b, torch.tensor(LARGE_QR["n"]), mesh), (block,), "cpu")
        out[f"large_qr_D{D}"] = {"perm": f.perm, "R": f.R, "V": f.V,
                                 "T": f.T, "tau": f.tau}
    return out


CASES = {"sharding": sharding_cases, "rows": rows_cases, "card": card_cases,
         "graph": graph_cases}


def main(suite, rank, world, out_dir):
    import datetime
    import torch.distributed as dist
    from enlsip_tpu_torch._dist import init_process_group
    torch.set_num_threads(1)
    init_process_group("gloo", f"file://{Path(out_dir) / (suite + '.init')}",
                       world, rank,
                       timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        out = CASES[suite](rank, world)
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(out_dir) / f"{suite}_rank{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
