"""Batched solves with the batch axis sharded over ranks.

Counterpart of ``enlsip_tpu/parallel/sharding.py`` on
``torch.distributed``, in its SPMD idiom: one process a rank, every rank
calls the same function.  Each rank solves its contiguous slice of the
lanes with the one-device batch machinery (``init_batch``, the lockstep
trips, ``finalize``; on the card every batched factorization is one
launch of the batched CPQR kernel on the rank's lanes).  The lockstep
"is any lane still running" check becomes one ``all_reduce`` over the
ranks, so every rank runs the same trips, as the reference's global
``while_loop`` does; the global result is assembled once at the end by
an exact gather (``_dist.gather_lanes``).

Device-resident, as the reference's ``_run_sharded_jit`` (init, the loop
and ``finalize`` in one jit): with ``graph=True`` (the default) a solve is
ONE captured graph on every rank, the check's ``all_reduce`` in its WHILE
node's flag and the gather at its end, replayed once with one read-back
(the trip count).  NCCL collectives are captured; a
gloo group with a card's tensors is not (``graph=True`` raises there:
pass ``graph=False`` for the eager loop).

Lanes are ordered rank-major, as in a mesh built from ``jax.devices()``
with one device a process: rank r holds lanes [r B_l, (r + 1) B_l).

Launch one process a rank and initialise ``torch.distributed`` first
(``torchrun --nproc-per-node=<cards>``, or ``_dist.init_process_group``
with a ``tcp://`` or ``file://`` address): NCCL with one card a rank, or
gloo for CPU ranks (``device="cpu"``) and for ranks that share a card.
Without an initialised process group the mesh has one rank and these
functions solve the whole batch in this process.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from .. import _graph
from .._device import to_host_list
from .._dist import (Mesh, all_reduce, check_capturable, gather_lanes,
                     make_mesh)
from ..core.batched import has_data
from ..core.driver import Functions
from ..core.types import (Counters, Dims, Options, Tols,
                          matmul_precision_scope)
from .batch import (BatchResult, _lane_rdims, _solve_batched_graph,
                    _to_device, finalize, init_batch, run_batch)


def batch_mesh(group=None, device=None, axis: str = "batch") -> Mesh:
    """The 1-D mesh over the batch axis: every rank of ``group`` (default:
    all ranks of the initialised process group; one rank without one).
    ``device``: this rank's device (default: its card, see
    ``_dist.make_mesh``)."""
    return make_mesh(group, device, axis)


def _default_dtype(x0) -> torch.dtype:
    return x0.dtype if isinstance(x0, torch.Tensor) and \
        x0.is_floating_point() else torch.float64


def _solve_local(fns, x0, dims, opts, tols, dtype, data, rdims, mesh,
                 check_every=1, graph=True) -> BatchResult:
    """This rank's lanes solved in lockstep with the other ranks' and the
    global result gathered: one graph replay and one read-back
    (``graph``), or the eager loop and an eager gather."""
    dev = mesh.device
    with matmul_precision_scope(opts), _graph.linalg_scope(dev):
        if not graph:
            carry = init_batch(fns, x0, dims, opts, dtype, data, rdims,
                               device=dev)
            carry = run_batch(carry, fns, dims, opts, tols, data=data,
                              rdims=rdims, check_every=check_every,
                              mesh=mesh, graph=False)
            return _gather_result(finalize(carry), mesh)
        check_capturable(mesh, dev)
        x0 = torch.as_tensor(x0).to(device=dev, dtype=dtype)
        data = _to_device(data, dev, dtype) if has_data(data) else None
        tols = Tols(*(torch.as_tensor(v).to(device=dev, dtype=dtype)
                      for v in tols))
        out, head = _solve_batched_graph(
            x0, tols, data, _lane_rdims(rdims, dev), fns, dims, opts, dtype,
            opts.max_iter + 2, check_every, mesh, _gather_result)
        res = pytree.tree_map(
            lambda a: a.clone() if isinstance(a, torch.Tensor) else a, out)
        run_batch.last_trips = to_host_list(head[:1])[0]
        return res


def _gather_result(res: BatchResult, mesh: Mesh) -> BatchResult:
    g = lambda a: gather_lanes(a, mesh)
    return BatchResult(exit_code=g(res.exit_code), x=g(res.x), f=g(res.f),
                       n_iter=g(res.n_iter),
                       counters=Counters(*(g(c) for c in res.counters)))


def solve_batched_sharded(fns: Functions, x0_batch, dims: Dims,
                          opts: Options, tols: Tols,
                          mesh: Optional[Mesh] = None, axis: str = "batch",
                          dtype=None, data=None, rdims=None,
                          graph: bool = True) -> BatchResult:
    """Batched solve with the batch axis sharded over ``mesh``.  Every
    rank passes the GLOBAL batch (``x0_batch`` (B, n), per-lane ``data``
    and ``rdims`` as in ``solve_batched``) and gets the global result.

    B is padded up to a multiple of D with copies of the last lane (a
    converged duplicate costs one frozen lane) and the padding dropped
    from the result.  There is no ``time_limit``: the reference's
    sharded loop has none.  ``graph``: device-resident (one replay and
    one read-back a solve), or ``graph=False`` for the eager loop (which
    a gloo group with a card's tensors needs)."""
    mesh = mesh or batch_mesh(axis=axis)
    x0 = torch.as_tensor(x0_batch)
    dtype = dtype or _default_dtype(x0)
    B = x0.shape[0]
    D = mesh.size
    pad = (D - B % D) % D
    per = (B + pad) // D
    lo = mesh.rank * per

    def mine(a):
        a = torch.as_tensor(a)
        if pad:
            a = torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
        return a[lo:lo + per]

    data = pytree.tree_map(mine, data) if has_data(data) else None
    rdims = None if rdims is None else type(rdims)(*map(mine, rdims))
    res = _solve_local(fns, mine(x0), dims, opts, tols, dtype, data, rdims,
                       mesh, graph=graph)
    if pad:
        res = BatchResult(exit_code=res.exit_code[:B], x=res.x[:B],
                          f=res.f[:B], n_iter=res.n_iter[:B],
                          counters=Counters(*(c[:B] for c in res.counters)))
    return res


def _check_equal_lanes(n_local: int, mesh: Mesh) -> None:
    mine = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
    mine[mesh.rank] = n_local
    sizes = all_reduce(mine, mesh).tolist()
    if len(set(sizes)) != 1:
        raise ValueError(f"every rank must pass the same number of lanes; "
                         f"the ranks pass {sizes}")


def global_from_process_local(mesh: Mesh, tree, axis: str = "batch"):
    """Global tensors from every rank's lanes (each leaf: this rank's
    lanes, the same count on every rank), concatenated in rank order on
    every rank, on the mesh's device.  Inverse of :func:`local_lanes`."""
    def glob(a):
        return gather_lanes(torch.as_tensor(a).to(mesh.device), mesh)
    return pytree.tree_map(glob, tree)


def local_lanes(array: torch.Tensor, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """This rank's lanes of a global batch-sharded (B, ...) tensor, in
    global lane order (inverse of :func:`global_from_process_local`)."""
    mesh = mesh or batch_mesh(device=array.device)
    per = array.shape[0] // mesh.size
    return array[mesh.rank * per:(mesh.rank + 1) * per]


def solve_batched_sharded_mp(fns: Functions, x0_local, dims: Dims,
                             opts: Options, tols: Tols,
                             mesh: Optional[Mesh] = None, axis: str = "batch",
                             dtype=None, data_local=None, rdims_local=None,
                             check_every: int = 1,
                             graph: bool = True) -> BatchResult:
    """Batched solve in which each rank passes ITS OWN lanes
    (``x0_local`` (B_local, n), the same B_local on every rank, and the
    optional ``data_local`` / ``rdims_local``).  Returns the global
    :class:`BatchResult` on every rank, lanes in rank order; read this
    rank's lanes back with :func:`local_lanes`.

    ``check_every``: trips between two global convergence checks (one
    ``all_reduce`` each); per-lane results do not depend on it.
    ``graph``: as in :func:`solve_batched_sharded`."""
    mesh = mesh or batch_mesh(axis=axis)
    x0 = torch.as_tensor(x0_local)
    _check_equal_lanes(x0.shape[0], mesh)
    dtype = dtype or _default_dtype(x0)
    data = data_local if has_data(data_local) else None
    return _solve_local(fns, x0, dims, opts, tols, dtype, data, rdims_local,
                        mesh, check_every, graph)
