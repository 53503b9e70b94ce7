"""Helpers that let one function serve a single solve and a batch of them.

The solver's math is written once, over tensors with any number of
LEADING lane axes: a vector is ``(..., n)``, a matrix ``(..., r, c)``, a
per-lane scalar ``(...)`` (0-d for a single solve, ``(B,)`` for a
batch).  This module holds the few idioms that differ from plain 1-D/2-D
PyTorch:

* indexing by per-lane indices (:func:`take`, :func:`take1`,
  :func:`take_rows`, :func:`put`), which is ``gather``/``scatter`` on the
  last axis;
* lane-wise products (:func:`dot`, :func:`norm`, :func:`mv`, :func:`mtv`);
* control flow.  A single solve reads its predicate back and evaluates
  ONE branch.  A batch runs in lockstep: :func:`cond` skips the side no
  lane takes, else computes both for the whole batch and selects per
  lane; :func:`while_loop` runs the body while ANY lane's condition
  holds and freezes the others by select.  Values computed on lanes that
  do not take a side may be NaN or inf; they are selected away with
  ``torch.where``, never multiplied by 0.
"""

from __future__ import annotations

import torch

from ._device import to_host, to_host_list


def ex(v, n: int = 1):
    """Per-lane scalar ``v`` (0-d, ``(B,)`` or a Python number) with ``n``
    trailing unit axes, so it broadcasts against per-lane vectors
    (``n = 1``) or matrices (``n = 2``)."""
    if not isinstance(v, torch.Tensor):
        return v
    return v[(...,) + (None,) * n]


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def norm(a):
    return torch.linalg.vector_norm(a, dim=-1)


def mv(A, x):
    """Lane-wise ``A @ x`` for ``A`` (..., r, c), ``x`` (..., c).

    With lane axes it is a product and a sum, not a batched matrix
    product: the card's batched product picks its kernel, and with it the
    summation order, by the number of lanes, so a lane's bits would
    depend on how many lanes share its batch (a sharded rank's half of
    the lanes would round otherwise than the whole batch)."""
    if A.ndim > 2:
        return torch.sum(A * x[..., None, :], dim=-1)
    return (A @ x[..., None])[..., 0]


def mtv(A, x):
    """Lane-wise ``A^T @ x`` for ``A`` (..., r, c), ``x`` (..., r); with
    lane axes a product and a sum, as :func:`mv`."""
    if A.ndim > 2:
        return torch.sum(A * x[..., :, None], dim=-2)
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def take(v, idx):
    """``v[..., idx]`` with per-lane index vectors: ``v`` (..., L),
    ``idx`` (..., K) -> (..., K)."""
    lead = torch.broadcast_shapes(v.shape[:-1], idx.shape[:-1])
    return torch.gather(v.expand(*lead, v.shape[-1]), -1,
                        idx.expand(*lead, idx.shape[-1]))


def take1(v, i):
    """``v[..., i]`` with one index per lane: ``v`` (..., L), ``i`` (...)."""
    return take(v, i[..., None])[..., 0]


def take_rows(A, idx):
    """``A[..., idx, :]`` with per-lane row indices: ``A`` (..., L, n),
    ``idx`` (..., K) -> (..., K, n)."""
    lead = torch.broadcast_shapes(A.shape[:-2], idx.shape[:-1])
    n = A.shape[-1]
    ix = idx.expand(*lead, idx.shape[-1])[..., None].expand(
        *lead, idx.shape[-1], n)
    return torch.gather(A.expand(*lead, *A.shape[-2:]), -2, ix)


def put(base, idx, values):
    """Copy of ``base`` (..., L) with ``base[..., idx] = values`` per lane
    (``idx`` has no repeats within a lane)."""
    lead = torch.broadcast_shapes(base.shape[:-1], idx.shape[:-1], values.shape[:-1])
    out = base.expand(*lead, base.shape[-1]).clone()
    k = idx.shape[-1]
    return out.scatter_(-1, idx.expand(*lead, k),
                        values.expand(*lead, k).to(out.dtype))


def tree_where(pred, t, f):
    """Per-lane select over two identically-structured nests of tensors
    (tuples, NamedTuples, ``None``); ``pred`` is a per-lane bool
    broadcast over each leaf's trailing axes."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor) or isinstance(f, torch.Tensor):
        t = torch.as_tensor(t, device=pred.device)
        f = torch.as_tensor(f, device=pred.device)
        nd = max(t.ndim, f.ndim) - pred.ndim
        return torch.where(ex(pred, nd), t, f)
    if isinstance(t, tuple):
        vals = [tree_where(pred, a, b) for a, b in zip(t, f)]
        return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
    # Python numbers (host ints of a single solve never reach a select)
    return torch.where(pred, torch.as_tensor(t, device=pred.device),
                       torch.as_tensor(f, device=pred.device))


def is_batched(pred) -> bool:
    return isinstance(pred, torch.Tensor) and pred.ndim > 0


def lane_any(pred) -> bool:
    """Host bool: does any lane hold ``pred``?  One counted read-back."""
    if not isinstance(pred, torch.Tensor):
        return bool(pred)
    return bool(to_host(torch.any(pred) if pred.ndim else pred))


def cond(pred, true_fn, false_fn, lanes=None):
    """Branch on a per-lane predicate.

    0-d ``pred`` (a single solve) or a host bool: at most one read-back,
    ONE side evaluated.  ``(B,)`` ``pred``: the side that none of
    ``lanes`` (default: all lanes) takes is skipped (one read-back of
    two flags); when both are taken, both are computed for the whole
    batch and selected per lane."""
    if not is_batched(pred):
        return true_fn() if lane_any(pred) else false_fn()
    if lanes is None:
        some, all_ = torch.any(pred), torch.all(pred)
    else:
        some, all_ = torch.any(pred & lanes), torch.all(pred | ~lanes)
    some, all_ = to_host_list(torch.stack([some, all_]))
    if all_:
        return true_fn()
    if not some:
        return false_fn()
    return tree_where(pred, true_fn(), false_fn())


def while_loop(cond_fn, body_fn, state, max_trips=None):
    """``state = body_fn(state)`` while ``cond_fn(state)`` holds.  For a
    batch the body runs while ANY lane's condition holds and the lanes
    whose condition is false keep their state; one read-back a trip.
    ``max_trips`` caps the trips (a lane that runs does so from trip 0
    without a gap, so the cap is per lane too)."""
    trips = 0
    while max_trips is None or trips < max_trips:
        c = cond_fn(state)
        if not lane_any(c):
            break
        new = body_fn(state)
        state = tree_where(c, new, state) if is_batched(c) else new
        trips += 1
    return state
