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
* control flow.  A single solve evaluates ONE branch: eagerly it reads
  its predicate back, and inside a captured CUDA graph (``_graph``) the
  branch becomes conditional nodes that the card takes itself
  (:func:`cond`: an IF per side; :func:`switch`: an IF per branch;
  :func:`while_loop`: one WHILE node).  A batch runs in lockstep:
  :func:`cond` skips the side no lane takes, else computes both for the
  whole batch and selects per lane; :func:`while_loop` runs the body
  while ANY lane's condition holds and freezes the others by select.
  Values computed on lanes that do not take a side (or by an IF body
  that did not run) may be NaN, inf or garbage; they are selected away
  with ``torch.where``, never multiplied by 0.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from . import _graph
from ._device import cpu_int, flag_value, to_host, to_host_list


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


def const(v, device, dtype=None):
    """``v`` as a tensor on ``device``: a tensor as it is (cast to
    ``dtype`` if given), a Python number by a fill on the device — never
    a copy of host data, which a captured graph cannot hold.  The dtype
    of a number is ``torch.as_tensor``'s (bool, int64, the default float
    dtype) unless ``dtype`` says otherwise."""
    if isinstance(v, torch.Tensor):
        if v.device != torch.device(device) and v.ndim == 0 \
                and v.device.type == "cpu":
            raise ValueError("a CPU tensor cannot enter a device-resident "
                             "solve; pass a Python number or a device tensor")
        return v if dtype is None else v.to(dtype)
    if not isinstance(v, (bool, int, float)):
        # host data (a list, an array): an upload, never inside a capture
        return torch.as_tensor(v, dtype=dtype, device=device)
    return torch.full((), v, dtype=dtype, device=device)


def tree_where(pred, t, f, _seen=None):
    """Per-lane select over two identically-structured nests of tensors
    (tuples, NamedTuples, ``None``); ``pred`` is a per-lane bool
    broadcast over each leaf's trailing axes.  A static leaf both sides
    share (an axis name, the very same mesh object of a row-sharded
    factorization) is passed through.  A pair of leaves that recurs (a
    factorization that keeps the very matrix another field holds) is
    selected once and the result shared, as the sides share it: a
    second (m, n) copy would only cost memory."""
    if t is None:
        return None
    seen = {} if _seen is None else _seen
    if isinstance(t, torch.Tensor) or isinstance(f, torch.Tensor):
        key = (id(t), id(f))
        if key in seen:
            return seen[key][2]
        a, b = const(t, pred.device), const(f, pred.device)
        nd = max(a.ndim, b.ndim) - pred.ndim
        out = torch.where(ex(pred, nd), a, b)
        seen[key] = (t, f, out)         # t, f held: their ids stay theirs
        return out
    if isinstance(t, tuple):
        if t is f and not any(isinstance(a, torch.Tensor) for a in t):
            return t
        vals = [tree_where(pred, a, b, seen) for a, b in zip(t, f)]
        return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
    if isinstance(t, (bool, int, float)):
        return torch.where(pred, const(t, pred.device),
                           const(f, pred.device))
    if t == f:
        return t
    raise TypeError(f"the two sides of a branch disagree in a static "
                    f"leaf ({t!r} vs {f!r})")


def is_batched(pred) -> bool:
    return isinstance(pred, torch.Tensor) and pred.ndim > 0


def _emulating() -> bool:
    return _graph.mode() == "emulate"


def lane_any(pred) -> bool:
    """Host bool: does any lane hold ``pred``?  One counted read-back
    (none in a CPU rehearsal of a device-resident solve, where the flag
    is read as a conditional node reads it)."""
    if not isinstance(pred, torch.Tensor):
        return bool(pred)
    p = torch.any(pred) if pred.ndim else pred
    if _emulating():
        return flag_value(p)
    return bool(to_host(p))


def lane_flags(*preds):
    """``any`` of each predicate: host bools read back in ONE transfer,
    or 0-d device flags while a graph is captured (each then feeds an IF
    node through :func:`cond`)."""
    anys = [torch.any(p) if isinstance(p, torch.Tensor) else p
            for p in preds]
    if _graph.capturing():
        return anys
    if _emulating():
        return [flag_value(a) for a in anys]
    tensors = [a for a in anys if isinstance(a, torch.Tensor)]
    vals = iter(to_host_list(torch.stack(tensors))) if tensors else iter(())
    return [bool(next(vals)) if isinstance(a, torch.Tensor) else bool(a)
            for a in anys]


def _select_sides(sel, t, f):
    """The merge of two captured IF bodies: ``t`` where ``sel``, else
    ``f``.  The side whose IF did not run holds garbage and is selected
    away, never read arithmetically; both sides must agree in dtype."""
    for a, b in zip(pytree.tree_leaves(t), pytree.tree_leaves(f)):
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and (
                a.dtype != b.dtype or
                (a.shape == b.shape and _layout(a) != _layout(b))):
            raise TypeError(f"the two sides of a branch disagree in dtype "
                            f"or layout ({a.dtype} {_layout(a)} vs "
                            f"{b.dtype} {_layout(b)}); a device-resident "
                            f"branch must return one structure")
    return tree_where(sel, t, f)


def cond(pred, true_fn, false_fn, lanes=None):
    """Branch on a per-lane predicate.

    0-d ``pred`` (a single solve) or a host bool: ONE side evaluated, on
    one read-back (eager), or as two IF nodes of a captured graph (one
    per side, the flag and its negation, merged by select).  ``(B,)``
    ``pred``: the side that none of ``lanes`` (default: all lanes) takes
    is skipped (eager: one read-back of two flags; captured: IF nodes on
    the two flags); when both are taken, both are computed for the whole
    batch and selected per lane."""
    if not is_batched(pred):
        if _graph.capturing() and isinstance(pred, torch.Tensor):
            t = _graph.if_body(pred, true_fn)
            f = _graph.if_body(~pred, false_fn)
            return _select_sides(pred, t, f)
        return true_fn() if lane_any(pred) else false_fn()
    if lanes is None:
        some, all_ = torch.any(pred), torch.all(pred)
    else:
        some, all_ = torch.any(pred & lanes), torch.all(pred | ~lanes)
    if _graph.capturing():
        t = _graph.if_body(some | all_, true_fn)
        f = _graph.if_body(~all_, false_fn)
        return _select_sides(all_ | (some & pred), t, f)
    if _emulating():
        some, all_ = flag_value(some), flag_value(all_)
    else:
        some, all_ = to_host_list(torch.stack([some, all_]))
    if all_:
        return true_fn()
    if not some:
        return false_fn()
    return tree_where(pred, true_fn(), false_fn())


def switch(index, fns):
    """``fns[index]()`` for a 0-d int ``index`` (lax.switch): one
    read-back and one branch eagerly; captured, one IF node per branch
    on ``index == i``, merged by select."""
    if _graph.capturing() and isinstance(index, torch.Tensor):
        outs = [_graph.if_body(index == i, fn) for i, fn in enumerate(fns)]
        out = outs[-1]
        for i in range(len(fns) - 2, -1, -1):
            out = _select_sides(index == i, outs[i], out)
        return out
    if not isinstance(index, torch.Tensor):
        return fns[int(index)]()
    return fns[cpu_int(index) if _emulating() else int(to_host(index))]()


def _tensor_state(state, device):
    """A loop state with every number leaf made a 0-d device tensor (the
    form a WHILE node's buffers take)."""
    return pytree.tree_map(
        lambda a: a if a is None or isinstance(a, torch.Tensor)
        else const(a, device), state)


def _dense_state(state):
    """A loop state with every broadcast leaf (a stride-0 dimension, as a
    lane-mapped closure returns a constant Jacobian) materialized: the
    trips hand on dense tensors, so the first trip reads the layout the
    later ones read, in the eager loop and in a WHILE node's buffers."""
    return pytree.tree_map(
        lambda a: a.contiguous() if isinstance(a, torch.Tensor) and any(
            st == 0 and sz > 1 for st, sz in zip(a.stride(), a.shape))
        else a, state)


def _layout(t: torch.Tensor) -> tuple:
    """The order of a floating tensor's dimensions in memory (size-1 and
    broadcast dimensions left out): a matrix product or a reduction over
    a column-major and a row-major copy of the same values may round
    differently.  Integer and bool tensors round nothing: ``()``."""
    if not t.is_floating_point():
        return ()
    dims = [d for d in range(t.ndim) if t.shape[d] > 1 and t.stride(d) > 0]
    return tuple(sorted(dims, key=lambda d: -t.stride(d)))


def _check_state(new, state) -> None:
    """A trip keeps its state's structure, and each leaf's dtype, shape
    and memory layout: a WHILE node's body writes into fixed buffers, so
    a leaf that changed would make the next trip run otherwise than the
    eager loop's."""
    sa, sb = pytree.tree_flatten(new), pytree.tree_flatten(state)
    if sa[1] != sb[1]:
        raise TypeError("a loop body changed the structure of its state")
    for a, b in zip(sa[0], sb[0]):
        if isinstance(b, torch.Tensor) and (
                not isinstance(a, torch.Tensor) or a.dtype != b.dtype or
                torch.broadcast_shapes(a.shape, b.shape) != b.shape or
                (a.shape == b.shape and _layout(a) != _layout(b))):
            raise TypeError(
                f"a loop body changed a state leaf from "
                f"{b.dtype}{tuple(b.shape)} layout {_layout(b)} to "
                f"{getattr(a, 'dtype', type(a))}"
                f"{tuple(getattr(a, 'shape', ()))}"
                f"{'' if not isinstance(a, torch.Tensor) else ' layout ' + str(_layout(a))}")


def _device_of(state):
    for a in pytree.tree_leaves(state):
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("a device-resident loop needs a tensor in its state")


def while_loop(cond_fn, body_fn, state, max_trips=None):
    """``state = body_fn(state)`` while ``cond_fn(state)`` holds.  For a
    batch the body runs while ANY lane's condition holds and the lanes
    whose condition is false keep their state; one read-back a trip.
    ``max_trips`` caps the trips (a lane that runs does so from trip 0
    without a gap, so the cap is per lane too).

    Device-resident, the state's leaves are tensors whose dtype and shape
    a trip keeps (numbers become 0-d tensors on entry); captured, the
    loop is ONE WHILE node whose body is one trip."""
    state = _dense_state(state)
    if _graph.capturing():
        return _while_captured(cond_fn, body_fn, state, max_trips)
    resident = _emulating()
    if resident:
        state = _tensor_state(state, _device_of(state))
    trips = 0
    while max_trips is None or trips < max_trips:
        c = cond_fn(state)
        if not lane_any(c):
            break
        new = body_fn(state)
        if resident:
            _check_state(new, state)
        state = tree_where(c, new, state) if is_batched(c) else new
        trips += 1
    return state


def _while_captured(cond_fn, body_fn, state, max_trips):
    dev = _device_of(state)
    # the buffers keep each leaf's layout (a copy in another layout would
    # send the trips' matrix products down other kernels than the eager
    # loop's)
    buf = pytree.tree_map(
        lambda a: a.clone() if isinstance(a, torch.Tensor) else a,
        _tensor_state(state, dev))
    trips = torch.zeros((), dtype=torch.int64, device=dev)
    c0 = cond_fn(buf)
    lanes = c0.clone() if is_batched(c0) else None

    def flag(c):
        f = torch.any(c) if is_batched(c) else const(c, dev, torch.bool)
        return f if max_trips is None else f & (trips < max_trips)

    def trip():
        new = body_fn(buf)
        _check_state(new, buf)
        if lanes is not None:
            new = tree_where(lanes, new, buf)
        dst = pytree.tree_leaves(buf)
        src = pytree.tree_leaves(new)
        owned = {a.untyped_storage().data_ptr() for a in dst
                 if isinstance(a, torch.Tensor)}
        src = [a.clone() if isinstance(a, torch.Tensor) and
               a.untyped_storage().data_ptr() in owned else a for a in src]
        for d, s in zip(dst, src):
            if isinstance(d, torch.Tensor):
                d.copy_(s)
        trips.add_(1)
        c = cond_fn(buf)
        if lanes is not None:
            lanes.copy_(c)
        return flag(c)

    _graph.while_body(flag(c0), trip)
    return buf
