"""Batched solves: B independent same-shaped CNLS instances advance
together in lockstep on one device.

Counterpart of ``enlsip_tpu/parallel/batch.py``.  This is the
data-parallel layer the reference solver does not have: thousands of
scenario instances of one problem shape (shared residual/constraint
closures, per-lane scenario data through ``data=``) take one iteration
per trip of a host loop; converged lanes are frozen
(``core/batched.batched_guarded_body``) and the loop ends when every
lane has terminated.

On the card every tensor operation of a trip covers all B lanes, and the
two factorizations every lane needs per trip (A_act^T and J2) are one
launch each of the batched CPQR kernel (``ops/cpqr_batched_hopper.py``).

The loop is device-resident, as the JAX package's is: on a CUDA device
:func:`solve_batched` runs init, the loop of lockstep trips and the
result as ONE captured CUDA graph (``_graph``; the trips a WHILE node,
the body's branches IF nodes), replayed once, with the trip count and
the exit codes read back in one transfer.  A finite time limit follows
the JAX package's chunk schedule on a captured chunk graph.  With a
``mesh`` (the batch-sharded solves of ``parallel/sharding.py``) the
WHILE node's flag is "is any lane of ANY rank running", one
``all_reduce`` (max) inside the loop, as the reference's while predicate
becomes under GSPMD, so every rank runs the same trips; a rank whose own
lanes are done skips the body through an IF node on its local flag.  The
eager loop (:func:`run_batch` with ``graph=False``) reads the same check
back once per ``check_every`` trips and the clock every trip.  As in the
JAX package, the factored-Jacobian hook (``Functions.jac_rowscale`` /
``jac_base``) is a single-solve feature and ``init_batch`` rejects it.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from .. import _graph
from .._device import resolve_device, to_host_list
from .._dist import (Mesh, check_capturable, mesh_any, mesh_flags,
                     mesh_key)
from .._dist import warm as warm_collectives
from .._lanes import cond, dot, while_loop
from ..core.batched import (batched_guarded_body, has_data, lane_functions,
                            lane_hessians)
from ..core.driver import Functions, init_carry
from ..core.types import (Carry, Counters, Dims, Options, Tols,
                          matmul_precision_scope)
from ..utils.profiling import span


class BatchResult(NamedTuple):
    """Stacked per-lane results."""

    exit_code: torch.Tensor   # (B,) raw internal exit codes
    x: torch.Tensor           # (B, n)
    f: torch.Tensor           # (B,) ||r(x)||^2
    n_iter: torch.Tensor      # (B,)
    counters: Counters        # each (B,)
    escalated: Optional[torch.Tensor] = None  # (B,) bool when escalation ran


def _to_device(tree, dev, dtype=None):
    def conv(a):
        a = torch.as_tensor(a).to(dev)
        return a.to(dtype) if dtype is not None and a.is_floating_point() \
            else a
    return pytree.tree_map(conv, tree)


def _lane_rdims(rdims, dev):
    if rdims is None:
        return None
    return type(rdims)(*(torch.as_tensor(v, dtype=torch.int64, device=dev)
                         for v in rdims))


def init_batch(fns: Functions, x0_batch, dims: Dims, opts: Options, dtype,
               data=None, rdims=None, device=None) -> Carry:
    """:func:`core.driver.init_carry` over a (B, n) batch of starting
    points.

    ``data``: optional nest (tensor, tuple, dict) of per-lane problem
    data with a leading batch axis on every leaf; when given, the
    ``fns`` closures take ``(x, data_lane)`` and each lane sees its own
    slice.  ``rdims``: optional per-lane RDims (fields shaped (B,)) for
    heterogeneous fused batches."""
    if fns.jac_base is not None or fns.jac_rowscale is not None:
        raise ValueError(
            "the factored-Jacobian hook (Functions.jac_rowscale/jac_base) "
            "is a single-solve feature (init_carry/iterate_body/solve); the "
            "batched bodies would silently treat the (m, 1) scale as a "
            "dense Jacobian")
    dev = resolve_device(device)
    data = _to_device(data, dev, dtype) if has_data(data) else None
    x0 = torch.as_tensor(x0_batch).to(device=dev, dtype=dtype)
    if x0.ndim != 2:
        raise ValueError(f"x0_batch must be (B, n), got {tuple(x0.shape)}")
    return init_carry(lane_functions(fns, data), x0, dims, opts, dtype,
                      _lane_rdims(rdims, dev), device=dev)


def _batch_trips(carry: Carry, fns: Functions, dims: Dims, opts: Options,
                 tols: Tols, chunk, data=None, rdims=None,
                 check_every: int = 1, mesh: Optional[Mesh] = None):
    """Lockstep trips while any lane runs and fewer than ``chunk`` (an int
    or a 0-d device tensor) have run, ``check_every`` bodies between two
    checks (JAX: a ``fori_loop`` inside the ``while_loop``): one WHILE
    node when captured.  ``data`` / ``rdims`` are on the device already.
    With a ``mesh`` the check is global (one ``all_reduce`` a check, in
    the WHILE node's flag) and a trip's bodies run only where this rank
    has a lane running (an IF node on the local flag, no collective in
    its body).  Returns (carry, trips)."""
    lfns = lane_functions(fns, data)
    hess = lane_hessians(fns, data) if opts.second_derivatives else None

    def go(st):
        c, trips = st
        some, _ = mesh_flags(c.exit_code == 0, mesh)
        return some & (trips < chunk)

    def bodies(c):
        for _ in range(check_every):
            c = batched_guarded_body(c, lfns, dims, opts, tols, rdims, hess)
        return c

    def step(st):
        c, trips = st
        with span("trip", c.x.device):
            if mesh is not None:
                c = cond(torch.any(c.exit_code == 0), lambda: bodies(c),
                         lambda: c)
            else:
                c = bodies(c)
            return c, trips + check_every

    return while_loop(go, step, (carry, torch.zeros(
        (), dtype=torch.int64, device=carry.x.device)))


def _batch_key(kind, fns, dims, opts, dtype, tree, mesh=None):
    return (kind, fns, dims, opts, dtype) + mesh_key(mesh) + \
        _graph.shapes_key(tree)


def _run_batch_chunk_graph(carry: Carry, tols: Tols, chunk: torch.Tensor,
                           data, rdims, fns: Functions, dims: Dims,
                           opts: Options, check_every: int = 1,
                           mesh: Optional[Mesh] = None):
    """Up to ``chunk`` lockstep trips as a captured graph (JAX
    ``_run_batch_chunk_jit``; ``chunk`` is a device scalar, so one graph
    serves every chunk size).  Returns the graph's (carry, trips)."""
    def trips_fn(carry, tols, chunk, data, rdims):
        with span("batch", carry.x.device):
            return _batch_trips(carry, fns, dims, opts, tols, chunk, data,
                                rdims, check_every, mesh)

    def warm():
        warm_collectives(mesh, carry.x.device)
        init_carry(lane_functions(fns, data), carry.x, dims, opts, dtype,
                   rdims, device=carry.x.device)

    dtype = carry.x.dtype
    key = _batch_key(("batch_chunk", check_every), fns, dims, opts, dtype,
                     (carry, data, rdims), mesh)
    return _graph.run(key, trips_fn, (carry, tols, chunk, data, rdims),
                      carry.x.device, warm=warm)


def run_batch(carry: Carry, fns: Functions, dims: Dims, opts: Options,
              tols: Tols, max_steps: Optional[int] = None, data=None,
              rdims=None, check_every: int = 1,
              time_limit: Optional[float] = None,
              start_time: Optional[float] = None,
              mesh: Optional[Mesh] = None,
              graph: bool = True) -> Carry:
    """Advance every unconverged lane until all lanes terminate (or
    ``max_steps`` loop trips).

    ``graph`` (default): the trips run device-resident, as a captured
    chunk graph on a CUDA device (one replay and one read-back of the
    trip count when the time is unlimited; a finite ``time_limit`` takes
    the chunk schedule of :func:`solve_batched`).  ``graph=False`` runs
    the eager loop; a ``mesh`` over a gloo group with a card's tensors
    needs it (``graph=True`` raises there).

    ``check_every``: body steps per convergence check (eagerly one
    read-back a check).  Checking every k trips costs up to k-1 extra
    lockstep trips at the tail (harmless: terminated lanes are frozen);
    per-lane results are unchanged for any value.

    ``time_limit`` (seconds since ``start_time``): the loop reads the
    clock before every trip; once the limit has run out, the lanes still
    running exit -11.

    ``mesh``: this rank's lanes are a slice of a batch sharded over the
    mesh's ranks; the check becomes "is any lane of ANY rank running" (one
    ``all_reduce``), so every rank runs the same trips as the reference's
    global loop does and ``run_batch.last_trips`` is global.  A rank
    whose own lanes have all terminated skips the body (it would change
    nothing: terminated lanes are frozen).  Every rank's clock differs,
    so a sharded batch has no ``time_limit`` on the device-resident path
    (the reference's sharded loop has none).

    Cap invariant: all lanes step in lockstep (a lane's nb_iter only
    advances while its exit_code == 0 and it records), so loop trips
    >= any lane's iteration count; max_iter + 2 trips suffice for every
    lane to reach its own -2 exit."""
    dev = carry.x.device
    dtype = carry.x.dtype
    data = _to_device(data, dev, dtype) if has_data(data) else None
    rdims = _lane_rdims(rdims, dev)
    tols = Tols(*(torch.as_tensor(v).to(device=dev, dtype=dtype)
                  for v in tols))
    cap = max_steps if max_steps is not None else opts.max_iter + 2
    start = time.time() if start_time is None else start_time
    if graph:
        if mesh is not None:
            check_capturable(mesh, dev)
            if time_limit is not None:
                raise ValueError("a sharded batch has no time limit on the "
                                 "device-resident path: every rank's clock "
                                 "differs (pass graph=False)")
        with _graph.linalg_scope(dev):
            carry, trips = _chunk_schedule(carry, tols, data, rdims, fns,
                                           dims, opts, cap, time_limit, start,
                                           check_every, mesh)
        run_batch.last_trips = trips
        return carry
    lfns = lane_functions(fns, data)
    hess = lane_hessians(fns, data) if opts.second_derivatives else None
    trips = 0
    with _graph.linalg_scope(dev):
        while trips < cap:
            some, mine = mesh_any(carry.exit_code == 0, mesh)
            if not some:
                break
            for _ in range(check_every):
                if time_limit is not None and \
                        time.time() - start >= time_limit:
                    run_batch.last_trips = trips
                    return _timed_out(carry)
                if mine:
                    carry = batched_guarded_body(carry, lfns, dims, opts,
                                                 tols, rdims, hess)
                trips += 1
    run_batch.last_trips = trips
    return carry


run_batch.last_trips = 0


def _timed_out(carry: Carry) -> Carry:
    ec = carry.exit_code
    return carry._replace(exit_code=torch.where(
        ec == 0, torch.full_like(ec, -11), ec))


def _chunk_schedule(carry, tols, data, rdims, fns, dims, opts, cap: int,
                    time_limit, start: float, check_every: int = 1,
                    mesh: Optional[Mesh] = None):
    """The JAX package's chunk schedule over the chunk graph: all ``cap``
    trips at once when the time is unlimited, else one measured trip and
    then chunks of half the remaining budget.  Each chunk is one replay
    and one read-back (the trip count and whether a lane still runs).
    Returns (carry, trips) with the carry cloned out of the graph."""
    dev = carry.x.device
    trips, per_trip = 0, None
    while True:
        if time_limit is None:
            chunk = cap - trips
        else:
            remaining = time_limit - (time.time() - start)
            if remaining <= 0:
                carry = _timed_out(carry)
                break
            chunk = 1 if per_trip is None else max(
                1, min(cap - trips, int(0.5 * remaining / per_trip)))
        t0 = time.time()
        carry, done = _run_batch_chunk_graph(
            carry, tols, torch.full((), chunk, dtype=torch.int64, device=dev),
            data, rdims, fns, dims, opts, check_every, mesh)
        done, alive = to_host_list(torch.stack(
            [done, torch.any(carry.exit_code == 0).to(torch.int64)]))
        trips += done
        measured = (time.time() - t0) / max(done, 1)
        per_trip = measured if per_trip is None else max(0.5 * per_trip,
                                                         measured)
        if not alive or trips >= cap or time_limit is None:
            break
    carry = pytree.tree_map(
        lambda a: a.clone() if isinstance(a, torch.Tensor) else a, carry)
    return carry, trips


def finalize(carry: Carry) -> BatchResult:
    return BatchResult(exit_code=carry.exit_code, x=carry.x,
                       f=dot(carry.rx, carry.rx), n_iter=carry.nb_iter,
                       counters=carry.counters)


def escalate_lanes_f64(fns: Functions, x0_batch, dims: Dims, opts: Options,
                       res: BatchResult, data=None, rdims=None,
                       tols64: Optional[Tols] = None, mask=None,
                       device=None, exit_codes=None,
                       graph: bool = True) -> BatchResult:
    """Re-solve a lane subset of a batched float32 solve at float64 in
    ONE follow-up batch and merge.

    Default subset: lanes with exit_code <= 0 (aborted/unconverged);
    pass ``mask`` (B,)-bool to escalate e.g. known-miss lanes instead.
    Escalated lanes restart from their ORIGINAL x0 — the merged result
    is what an all-float64 solve of those lanes would produce, not a
    warm start from the float32 iterate.  Counters on escalated lanes
    are the SUM of both attempts (total evaluations actually spent).
    Merged x/f are reported at float64.  ``exit_codes``: the exit codes
    as a host list when the caller has read them already (the solve's
    one read-back), else they are read back here.  ``graph``: as in
    :func:`solve_batched`, for the float64 re-solve."""
    dev = res.x.device
    B = res.exit_code.shape[0]
    if mask is None:
        codes = exit_codes if exit_codes is not None \
            else to_host_list(res.exit_code)
        mask = [c <= 0 for c in codes]
    sel_mask = torch.as_tensor(mask, dtype=torch.bool).to(dev)
    sel = torch.as_tensor([i for i, m in enumerate(
        torch.as_tensor(mask, dtype=torch.bool).tolist()) if m],
        dtype=torch.int64).to(dev)
    if sel.shape[0] == 0:
        return res._replace(escalated=torch.zeros(B, dtype=torch.bool,
                                                  device=dev))
    f64 = torch.float64

    def slice_cast(a):
        a = torch.as_tensor(a).to(dev)[sel]
        return a.to(f64) if a.is_floating_point() else a

    x0_sel = slice_cast(x0_batch)
    data_sel = pytree.tree_map(slice_cast, data) if has_data(data) else None
    rdims_sel = None if rdims is None else type(rdims)(
        *(torch.as_tensor(v).to(dev)[sel] for v in rdims))
    tols64 = tols64 if tols64 is not None else Tols.for_dtype(f64, dev)
    res64 = solve_batched(fns, x0_sel, dims, opts, tols64, dtype=f64,
                          data=data_sel, rdims=rdims_sel, device=dev,
                          graph=graph)

    def merge(old, new):
        return old.to(new.dtype).index_copy(0, sel, new)

    cnt = Counters(*(old.index_add(0, sel, new) for old, new in
                     zip(res.counters, res64.counters)))
    return BatchResult(
        exit_code=merge(res.exit_code, res64.exit_code),
        x=merge(res.x, res64.x), f=merge(res.f, res64.f),
        n_iter=merge(res.n_iter, res64.n_iter), counters=cnt,
        escalated=sel_mask)


def _solve_batched_graph(x0, tols: Tols, data, rdims, fns: Functions,
                         dims: Dims, opts: Options, dtype, cap: int,
                         check_every: int = 1, mesh: Optional[Mesh] = None,
                         gather=None):
    """Init, every lockstep trip and the result as ONE device program
    (JAX ``_solve_batched_jit``; with a ``mesh`` the sharded
    ``_run_sharded_jit``, the check an ``all_reduce`` inside the loop and
    ``gather(result, mesh)``, the exact merge of the ranks' lanes, at the
    graph's end).  Returns the graph's (BatchResult, head): ``head`` =
    [trips, exit codes...] int64, the one buffer read back."""
    def full(x0, tols, data, rdims):
        with span("batch", x0.device):
            carry = init_batch(fns, x0, dims, opts, dtype, data, rdims,
                               device=x0.device)
            carry, trips = _batch_trips(carry, fns, dims, opts, tols, cap,
                                        data, rdims, check_every, mesh)
            res = finalize(carry)
            if gather is not None:
                res = gather(res, mesh)
            return res, torch.cat([trips[None], res.exit_code])

    def warm():
        warm_collectives(mesh, x0.device)
        init_batch(fns, x0, dims, opts, dtype, data, rdims, device=x0.device)

    key = _batch_key(("batch_solve", check_every, gather is not None), fns,
                     dims, opts, dtype, (x0, data, rdims), mesh)
    return _graph.run(key, full, (x0, tols, data, rdims), x0.device,
                      warm=warm)


def solve_batched(fns: Functions, x0_batch, dims: Dims, opts: Options,
                  tols: Tols, dtype=None, data=None, rdims=None,
                  time_limit: Optional[float] = None,
                  escalate_f64: bool = False, escalate_mask=None,
                  device=None, graph: bool = True) -> BatchResult:
    """One-call batched solve of B same-shaped CNLS instances.

    Runs on ``device`` (default: the card; raises if there is none).
    ``fns`` holds the per-lane closures on tensors: ``res(x)`` (m,),
    ``jac_res(x)`` (m, n), ``cons(x)`` (l,), ``jac_cons(x)`` (l, n); they
    are mapped over the lane axis with ``torch.func.vmap``, so they must
    be free of data-dependent Python control flow (and, on the card,
    capture-safe: tensor code only, no host data made into tensors at a
    call).  ``data`` is an optional nest of per-lane problem data
    (scenario observations, targets, ...) whose leaves all carry a
    leading batch axis of size B; when given, every closure in ``fns``
    takes ``(x, data)`` and lane i is called with ``data`` sliced at i.
    ``rdims``: per-lane RDims (fields shaped (B,)) for heterogeneous
    fused batches.

    Device-resident: with the time unlimited (``None`` / ``inf``) the
    whole solve is ONE replay of a captured graph and ONE read-back (the
    trip count and the exit codes); a finite ``time_limit`` runs the
    chunk schedule (:func:`run_batch`) and lanes still running when the
    budget expires exit -11, exactly like the single-solve driver.
    ``graph=False`` runs the eager loop instead (the comparison).

    ``escalate_f64``: opt-in hybrid precision — after the solve, lanes
    with exit_code <= 0 are re-solved from their original x0 at float64
    in one follow-up batch (see :func:`escalate_lanes_f64`; its solve is
    a second replay and read-back).
    ``escalate_mask``: explicit (B,)-bool lane subset to escalate
    instead of the exit-code rule (implies escalation)."""
    dev = resolve_device(device)
    start_time = time.time()
    if dtype is None:
        dtype = x0_batch.dtype if isinstance(x0_batch, torch.Tensor) \
            and x0_batch.is_floating_point() else torch.float64
    if time_limit is not None and time_limit == float("inf"):
        time_limit = None
    codes = None
    with span("api.solve_batched"), matmul_precision_scope(opts), \
            _graph.linalg_scope(dev):
        if graph and time_limit is None:
            with span("prepare"):
                x0 = torch.as_tensor(x0_batch).to(device=dev, dtype=dtype)
                dd = _to_device(data, dev, dtype) if has_data(data) else None
                tt = Tols(*(torch.as_tensor(v).to(device=dev, dtype=dtype)
                            for v in tols))
                rd = _lane_rdims(rdims, dev)
            with span("replay"):
                out, head = _solve_batched_graph(
                    x0, tt, dd, rd, fns, dims, opts, dtype,
                    opts.max_iter + 2)
            with span("result"):
                res = pytree.tree_map(
                    lambda a: a.clone() if isinstance(a, torch.Tensor)
                    else a, out)
            with span("readback"):
                head = to_host_list(head)
            run_batch.last_trips, codes = head[0], head[1:]
        else:
            carry = init_batch(fns, x0_batch, dims, opts, dtype, data, rdims,
                               device=dev)
            carry = run_batch(carry, fns, dims, opts, tols, data=data,
                              rdims=rdims, time_limit=time_limit,
                              start_time=start_time, graph=graph)
            res = finalize(carry)
        if escalate_f64 or escalate_mask is not None:
            res = escalate_lanes_f64(fns, x0_batch, dims, opts, res,
                                     data=data, rdims=rdims,
                                     mask=escalate_mask, device=dev,
                                     exit_codes=codes, graph=graph)
    return res
