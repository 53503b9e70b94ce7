"""Collectives of the multi-device solves, and the ambient row scope.

A JAX ``Mesh`` with one named axis becomes a :class:`Mesh` here: the
``torch.distributed`` process group, its size D and this process's rank,
the rank's device, and the axis name.  One process runs one rank.  When
``torch.distributed`` is not initialised, :func:`make_mesh` gives the
one-rank mesh and every collective below is the identity, so a single
process runs the sharded code paths unchanged with D = 1.

Only one collective is used, ``all_reduce``, so the same code runs on
NCCL (one rank a card) and on gloo (the CPU tests, and several ranks
sharing one card, whose CUDA tensors go through host memory).  An
all-gather is an ``all_reduce`` (sum) of a zero-filled buffer in which
each rank fills its own slot; the buffer is summed as integers of the
element's width (:func:`merge_disjoint`), so the gather is exact to the
bit, -0.0 and NaN payloads included.

Every collective is counted (:func:`collective_count`), as
``_device.to_host`` counts read-backs.  Every rank must take the same
branch, or the next collective waits forever: the solvers compute each
branch predicate from replicated values, and the process groups are
created with a timeout (:func:`init_process_group`).

Inside a device-resident solve (``_graph``) a collective on NCCL is
captured like any other work of the stream: ``ProcessGroupNCCL`` joins
its own stream to the capturing one by events, so the collective lands
in the body being captured (a conditional node's, when the solve
branches around it) and runs at every replay, where the device launch
counter of ``_graph.count_launch`` counts it (``collective_count`` counts
the collectives made now: eager, or in a CPU rehearsal).  A gloo
collective on a card's tensor goes through host memory, which a graph
cannot hold: inside a device-resident solve it raises.  The device form
of the convergence check, :func:`mesh_flags`, leaves its flags on the
device for a WHILE or an IF node.

The row scope (:func:`row_scope`) is the counterpart of ``jax.set_mesh``
around the row-sharded giant-m solve: inside it, the solver's
contractions over the m residual rows (``rows_sum``, ``rows_dot``,
``split_dots``) add this rank's partial sums across the ranks.  Outside
it they are the identity, so the single-device paths do not change by a
bit.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import NamedTuple, Optional

import torch

from . import _graph
from ._device import resolve_device

# How long a collective may wait for the other ranks before it fails.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=60)


class Mesh(NamedTuple):
    """One mesh axis over the ranks of a process group.

    group: the ``torch.distributed`` process group, or None when
      ``torch.distributed`` is not initialised (one rank, no collective);
    size: the number of ranks D; rank: this process's rank in ``group``;
    device: where this rank's tensors live; axis: the axis name
      ("batch" or "rows", as the JAX package names its mesh axes)."""

    group: object
    size: int
    rank: int
    device: torch.device
    axis: str = "batch"


def init_process_group(backend: str, init_method: str, world_size: int,
                       rank: int, timeout=DEFAULT_TIMEOUT) -> None:
    """``torch.distributed.init_process_group`` with a timeout, so that a
    rank whose peers took another branch fails instead of waiting."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, timeout=timeout)


def make_mesh(group=None, device=None, axis: str = "batch") -> Mesh:
    """The mesh over ``group`` (default: every rank of the initialised
    process group; one rank when ``torch.distributed`` is not
    initialised).  ``device`` defaults to the card
    ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK`` as ``torchrun``
    sets it, else the rank); pass ``device="cpu"`` to run on the host."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        size, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        group, size, rank = None, 1, 0
    if device is None:
        resolve_device(None)        # raises when there is no card
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = f"cuda:{local % torch.cuda.device_count()}"
    return Mesh(group=group, size=size, rank=rank,
                device=resolve_device(device), axis=axis)


# --------------------------------------------------------- collectives

def via_host(mesh: Mesh, device) -> bool:
    """Do the mesh's collectives on tensors of ``device`` go through host
    memory?  (gloo on anything but the CPU: a device-resident solve
    cannot hold them.)"""
    if mesh.group is None or torch.device(device).type == "cpu":
        return False
    import torch.distributed as dist
    return dist.get_backend(mesh.group) == "gloo"


def check_capturable(mesh: Optional[Mesh], device) -> None:
    """Raise unless the mesh's collectives on ``device`` can sit inside a
    captured graph (gloo with a card's tensors cannot: the caller passes
    ``graph=False``; nothing switches by itself)."""
    if mesh is not None and via_host(mesh, device):
        raise ValueError("a gloo group moves the card's tensors through "
                         "host memory, which a captured graph cannot hold: "
                         "pass graph=False (or use NCCL)")


def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced over the ranks of ``mesh`` ("sum" or
    "max"), identical on every rank; ``t`` itself is left as it was.
    With no process group it is ``t``.  Enqueued in the current stream's
    order with no host read, so it may be captured (NCCL); through host
    memory (gloo with a card's tensor) it raises inside a
    device-resident solve."""
    if mesh.group is None:
        return t
    import torch.distributed as dist
    host = via_host(mesh, t.device)
    if host and _graph.device_resident():
        raise RuntimeError(
            "a gloo collective on a tensor on the card goes through host "
            "memory and cannot run inside a device-resident solve; use "
            "NCCL, or pass graph=False")
    out = t.contiguous().cpu() if host else t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=mesh.group)
    _graph.count_launch(all_reduce, "collectives")
    return out.to(t.device) if host else out


all_reduce.collectives = 0
_graph.register_counts(all_reduce, "collectives")


def mesh_key(mesh: Optional[Mesh]) -> tuple:
    """What a captured graph's key holds of a mesh: the process group
    itself (kept alive by the key, so its identity is not reused), D, the
    rank and the axis.  A graph captured for one mesh is never replayed
    in another."""
    if mesh is None:
        return (None,)
    return (mesh.group, mesh.size, mesh.rank, mesh.axis)


def scope_key() -> tuple:
    """:func:`mesh_key` of the ambient row scope's mesh."""
    return mesh_key(_RowScope.mesh)


def warm(mesh: Optional[Mesh], device) -> None:
    """One eager collective on ``device``, before a capture: NCCL creates
    its communicator at the first collective, which a capture cannot
    hold."""
    if mesh is not None and mesh.group is not None:
        all_reduce(torch.zeros(1, device=device), mesh)


def collective_count() -> int:
    """Collectives made now (eager, or in a CPU rehearsal); a replayed
    graph's are on the device counter, ``_graph.launches(all_reduce,
    "collectives")``."""
    return all_reduce.collectives


def reset_collective_count() -> None:
    all_reduce.collectives = 0


_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def merge_disjoint(buf: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``buf`` merged, where each entry is set by at most one
    rank and zero on the others: one ``all_reduce`` summed as integers of
    the element's width, so every entry is its owner's to the bit."""
    if mesh.group is None:
        return buf
    src = buf.to(torch.uint8) if buf.dtype == torch.bool else buf
    ints = _INT_OF_WIDTH[src.element_size()]
    out = all_reduce(src.view(ints), mesh).view(src.dtype)
    return out.to(torch.bool) if buf.dtype == torch.bool else out


def gather_slots(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``local`` (same shape on every rank) stacked along a
    new leading axis in rank order, on every rank, to the bit."""
    if mesh.group is None:
        return local[None]
    buf = torch.zeros((mesh.size, *local.shape), dtype=local.dtype,
                      device=local.device)
    buf[mesh.rank] = local
    return merge_disjoint(buf, mesh)


def gather_lanes(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' (B_local, ...) lane blocks concatenated in rank order
    (B_local equal on every rank), exact to the bit."""
    g = gather_slots(local, mesh)
    return g.reshape(-1, *local.shape[1:])


def mesh_flags(pred: torch.Tensor, mesh: Optional[Mesh] = None):
    """(does any lane of any rank hold ``pred``, does any of this rank's)
    as 0-d bool tensors on the device, for a WHILE and an IF node: one
    collective (max), no read-back.  With no mesh, or a one without a
    process group, both are "does any lane hold it"."""
    mine = torch.any(pred)
    if mesh is None or mesh.group is None:
        return mine, mine
    glob = all_reduce(mine.to(torch.int32).reshape(1), mesh, "max")
    return glob[0] > 0, mine


def mesh_any(pred: torch.Tensor,
             mesh: Optional[Mesh] = None) -> tuple[bool, bool]:
    """:func:`mesh_flags` read back as host bools in one counted
    transfer."""
    from ._device import to_host_list
    glob, loc = mesh_flags(pred, mesh)
    glob, loc = to_host_list(torch.stack([glob, loc]))
    return bool(glob), bool(loc)


# ----------------------------------------------------------- row scope

class _RowScope:
    mesh: Optional[Mesh] = None


@contextlib.contextmanager
def row_scope(mesh: Mesh):
    """Within it, the m residual rows are sharded over ``mesh``: every
    rank holds its contiguous block of m / D rows (rank-major order) and
    the m-contractions below add the ranks' partial sums."""
    before = _RowScope.mesh
    _RowScope.mesh = mesh
    try:
        yield mesh
    finally:
        _RowScope.mesh = before


def row_mesh_in_scope() -> Optional[Mesh]:
    return _RowScope.mesh


def rows_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``, a partial sum over this rank's rows, summed over the row
    scope's ranks (the identity outside a row scope)."""
    mesh = _RowScope.mesh
    return t if mesh is None else all_reduce(t, mesh)


def rows_sums(*vals: torch.Tensor):
    """Several same-shaped partial sums reduced by ONE collective; the
    values themselves outside a row scope."""
    if _RowScope.mesh is None:
        return vals
    return tuple(torch.unbind(rows_sum(torch.stack(vals))))


def rows_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``dot(a, b)`` over row-sharded vectors."""
    return rows_sum(torch.sum(a * b, dim=-1))


def split_dots(pairs, rows: int):
    """``[dot(a, b) for a, b in pairs]`` for vectors whose first ``rows``
    entries are row-sharded and the rest replicated (the line search's
    [r; c] concatenations): the sharded parts are summed by one
    collective, the replicated parts added on every rank.  Outside a row
    scope it is the plain dot of each pair."""
    if _RowScope.mesh is None:
        return [torch.sum(a * b, dim=-1) for a, b in pairs]
    part = rows_sums(*(torch.sum(a[..., :rows] * b[..., :rows], dim=-1)
                       for a, b in pairs))
    return [s + torch.sum(a[..., rows:] * b[..., rows:], dim=-1)
            for s, (a, b) in zip(part, pairs)]


def global_rows(local_rows: int) -> int:
    """The row count of the whole sharded buffer whose block this rank
    holds (``local_rows`` outside a row scope)."""
    mesh = _RowScope.mesh
    return local_rows if mesh is None else local_rows * mesh.size
