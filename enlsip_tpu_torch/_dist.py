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
host branch, or the next collective waits forever: the solvers compute
each branch predicate from replicated values, and the process groups
are created with a timeout (:func:`init_process_group`).

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


# ------------------------------------------------------------ counting

class _Collectives:
    count = 0


def collective_count() -> int:
    return _Collectives.count


def reset_collective_count() -> None:
    _Collectives.count = 0


# --------------------------------------------------------- collectives

def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced over the ranks of ``mesh`` ("sum" or
    "max"), identical on every rank; ``t`` itself is left as it was.
    With no process group it is ``t``."""
    if mesh.group is None:
        return t
    import torch.distributed as dist
    via_host = t.is_cuda and dist.get_backend(mesh.group) == "gloo"
    out = t.contiguous().cpu() if via_host else t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=mesh.group)
    _Collectives.count += 1
    return out.to(t.device) if via_host else out


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


def mesh_any(pred: torch.Tensor,
             mesh: Optional[Mesh] = None) -> tuple[bool, bool]:
    """(does any lane of any rank hold ``pred``, does any of this rank's):
    one collective (max) and one counted read-back.  With no mesh, or a
    one-rank one, both are "does any lane hold it", with no collective."""
    from ._device import to_host, to_host_list
    mine = torch.any(pred)
    if mesh is None or mesh.group is None:
        loc = bool(to_host(mine))
        return loc, loc
    mine = mine.to(torch.int32).reshape(1)
    glob, loc = to_host_list(torch.cat([all_reduce(mine, mesh, "max"), mine]))
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
