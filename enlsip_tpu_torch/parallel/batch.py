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

Differences from the JAX package, all deliberate: the loop is a host
loop that reads "is any lane still running" back once per
``check_every`` trips and the clock every trip, so there is no adaptive
chunk schedule (that answered XLA dispatch cost).  With a ``mesh`` (the
batch-sharded solves of ``parallel/sharding.py``) that check is one
``all_reduce`` over the ranks, so every rank runs the same trips.  As there, the
factored-Jacobian hook (``Functions.jac_rowscale`` / ``jac_base``) is a
single-solve feature and ``init_batch`` rejects it.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from .._device import resolve_device
from .._dist import Mesh, mesh_any
from .._lanes import dot
from ..core.batched import (batched_guarded_body, has_data, lane_functions,
                            lane_hessians)
from ..core.driver import Functions, init_carry
from ..core.types import (Carry, Counters, Dims, Options, Tols,
                          matmul_precision_scope)


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


def run_batch(carry: Carry, fns: Functions, dims: Dims, opts: Options,
              tols: Tols, max_steps: Optional[int] = None, data=None,
              rdims=None, check_every: int = 1,
              time_limit: Optional[float] = None,
              start_time: Optional[float] = None,
              mesh: Optional[Mesh] = None) -> Carry:
    """Advance every unconverged lane until all lanes terminate (or
    ``max_steps`` loop trips).

    ``check_every``: body steps per convergence check (one read-back a
    check).  Checking every k trips costs up to k-1 extra lockstep trips
    at the tail (harmless: terminated lanes are frozen); per-lane
    results are unchanged for any value.

    ``time_limit`` (seconds since ``start_time``): the loop reads the
    clock before every trip; once the limit has run out, the lanes still
    running exit -11.

    ``mesh``: this rank's lanes are a slice of a batch sharded over the
    mesh's ranks; the check becomes "is any lane of ANY rank running" (one
    ``all_reduce``), so every rank runs the same trips as the reference's
    global loop does and ``run_batch.last_trips`` is global.  A rank
    whose own lanes have all terminated skips the body (it would change
    nothing: terminated lanes are frozen).

    Cap invariant: all lanes step in lockstep (a lane's nb_iter only
    advances while its exit_code == 0 and it records), so loop trips
    >= any lane's iteration count; max_iter + 2 trips suffice for every
    lane to reach its own -2 exit."""
    dev = carry.x.device
    dtype = carry.x.dtype
    data = _to_device(data, dev, dtype) if has_data(data) else None
    rdims = _lane_rdims(rdims, dev)
    lfns = lane_functions(fns, data)
    hess = lane_hessians(fns, data) if opts.second_derivatives else None
    tols = Tols(*(torch.as_tensor(v).to(device=dev, dtype=dtype)
                  for v in tols))
    cap = max_steps if max_steps is not None else opts.max_iter + 2
    start = time.time() if start_time is None else start_time
    trips = 0
    while trips < cap:
        some, mine = mesh_any(carry.exit_code == 0, mesh)
        if not some:
            break
        for _ in range(check_every):
            if time_limit is not None and time.time() - start >= time_limit:
                ec = carry.exit_code
                run_batch.last_trips = trips
                return carry._replace(exit_code=torch.where(
                    ec == 0, torch.full_like(ec, -11), ec))
            if mine:
                carry = batched_guarded_body(carry, lfns, dims, opts, tols,
                                             rdims, hess)
            trips += 1
    run_batch.last_trips = trips
    return carry


# Lockstep trips of the most recent run_batch call (for measurement
# scripts; a plain integer like the kernels' launch counts).
run_batch.last_trips = 0


def finalize(carry: Carry) -> BatchResult:
    return BatchResult(exit_code=carry.exit_code, x=carry.x,
                       f=dot(carry.rx, carry.rx), n_iter=carry.nb_iter,
                       counters=carry.counters)


def escalate_lanes_f64(fns: Functions, x0_batch, dims: Dims, opts: Options,
                       res: BatchResult, data=None, rdims=None,
                       tols64: Optional[Tols] = None, mask=None,
                       device=None) -> BatchResult:
    """Re-solve a lane subset of a batched float32 solve at float64 in
    ONE follow-up batch and merge.

    Default subset: lanes with exit_code <= 0 (aborted/unconverged);
    pass ``mask`` (B,)-bool to escalate e.g. known-miss lanes instead.
    Escalated lanes restart from their ORIGINAL x0 — the merged result
    is what an all-float64 solve of those lanes would produce, not a
    warm start from the float32 iterate.  Counters on escalated lanes
    are the SUM of both attempts (total evaluations actually spent).
    Merged x/f are reported at float64."""
    dev = res.x.device
    B = res.exit_code.shape[0]
    sel_mask = (res.exit_code <= 0) if mask is None else \
        torch.as_tensor(mask, dtype=torch.bool).to(dev)
    sel = torch.nonzero(sel_mask)[:, 0]      # the shape read is a read-back
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
                          data=data_sel, rdims=rdims_sel, device=dev)

    def merge(old, new):
        return old.to(new.dtype).index_copy(0, sel, new)

    cnt = Counters(*(old.index_add(0, sel, new) for old, new in
                     zip(res.counters, res64.counters)))
    return BatchResult(
        exit_code=merge(res.exit_code, res64.exit_code),
        x=merge(res.x, res64.x), f=merge(res.f, res64.f),
        n_iter=merge(res.n_iter, res64.n_iter), counters=cnt,
        escalated=sel_mask)


def solve_batched(fns: Functions, x0_batch, dims: Dims, opts: Options,
                  tols: Tols, dtype=None, data=None, rdims=None,
                  time_limit: Optional[float] = None,
                  escalate_f64: bool = False, escalate_mask=None,
                  device=None) -> BatchResult:
    """One-call batched solve of B same-shaped CNLS instances.

    Runs on ``device`` (default: the card; raises if there is none).
    ``fns`` holds the per-lane closures on tensors: ``res(x)`` (m,),
    ``jac_res(x)`` (m, n), ``cons(x)`` (l,), ``jac_cons(x)`` (l, n); they
    are mapped over the lane axis with ``torch.func.vmap``, so they must
    be free of data-dependent Python control flow.  ``data`` is an
    optional nest of per-lane problem data (scenario observations,
    targets, ...) whose leaves all carry a leading batch axis of size B;
    when given, every closure in ``fns`` takes ``(x, data)`` and lane i
    is called with ``data`` sliced at i.  ``rdims``: per-lane RDims
    (fields shaped (B,)) for heterogeneous fused batches.

    ``time_limit``: wall-clock budget in seconds (``None`` / ``inf``:
    unlimited).  The loop reads the clock every trip; lanes still
    running when the budget expires exit -11, exactly like the
    single-solve driver.

    ``escalate_f64``: opt-in hybrid precision — after the solve, lanes
    with exit_code <= 0 are re-solved from their original x0 at float64
    in one follow-up batch (see :func:`escalate_lanes_f64`).
    ``escalate_mask``: explicit (B,)-bool lane subset to escalate
    instead of the exit-code rule (implies escalation)."""
    dev = resolve_device(device)
    start_time = time.time()
    if dtype is None:
        dtype = x0_batch.dtype if isinstance(x0_batch, torch.Tensor) \
            and x0_batch.is_floating_point() else torch.float64
    if time_limit is not None and time_limit == float("inf"):
        time_limit = None
    with matmul_precision_scope(opts):
        carry = init_batch(fns, x0_batch, dims, opts, dtype, data, rdims,
                           device=dev)
        carry = run_batch(carry, fns, dims, opts, tols, data=data,
                          rdims=rdims, time_limit=time_limit,
                          start_time=start_time)
        res = finalize(carry)
        if escalate_f64 or escalate_mask is not None:
            res = escalate_lanes_f64(fns, x0_batch, dims, opts, res,
                                     data=data, rdims=rdims,
                                     mask=escalate_mask, device=dev)
    return res
