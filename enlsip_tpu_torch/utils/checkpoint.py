"""Checkpoint / resume for (batched) solver state.

Counterpart of ``enlsip_tpu/utils/checkpoint.py``, in the same ``.npz``
format: the leaves of the :class:`~enlsip_tpu_torch.core.types.Carry` in
its field order (which both packages share) as ``leaf_{i}``, plus a
``__format_version__`` entry.  The file is the interchange between the
packages: a carry saved by ``enlsip_tpu`` loads here and resumes, and
one saved here loads into ``enlsip_tpu``.  So integer leaves are written
as int32, the JAX package's type, although the port holds int64; a
single solve's host-int fields (``nb_iter``, ``exit_code``, the
counters, ...) are written as 0-d arrays and read back as Python ints.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .._device import resolve_device
from ..core.types import Carry, Counters, PrevIter

# Carry layout version.  v2 removed the trailing ``time_exceeded`` leaf;
# v1 files (no version entry) are migrated on load by dropping it.
FORMAT_VERSION = 2

# Fields one solve keeps as host ints ((B,) tensors in a batch).
def _example_carry() -> Carry:
    """A structure-only Carry (leaf values unused)."""
    return Carry(
        x=0, rx=0, cx=0, J=0, A=0, gf=0, active_mask=0, w=0, K=0,
        prev=PrevIter(*([0] * len(PrevIter._fields))),
        restart=0, index_del=0, nb_newton_steps=0, nb_iter=0, exit_code=0,
        counters=Counters(0, 0, 0, 0), display=0, n_display=0)


def _leaf_names() -> list:
    names = []
    for f in Carry._fields:
        sub = {"prev": PrevIter, "counters": Counters}.get(f)
        names += [f"{f}.{k}" for k in sub._fields] if sub else [f]
    return names


def save_carry(path: str, carry: Carry) -> None:
    """Save a (possibly batched) solver carry to ``path`` (.npz)."""
    arrays = {}
    for i, leaf in enumerate(pytree.tree_leaves(carry)):
        a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)
        arrays[f"leaf_{i}"] = a.astype(np.int32) if a.dtype.kind in "iu" \
            else a
    arrays["__format_version__"] = np.int32(FORMAT_VERSION)
    np.savez(path, **arrays)


def _like(a: np.ndarray, like):
    """A file leaf as the port holds ``like``'s leaf."""
    if not isinstance(like, torch.Tensor):
        return int(a)
    return torch.as_tensor(a).to(device=like.device, dtype=like.dtype)


def _canonical(a: np.ndarray, dev):
    """A file leaf as ``init_carry`` / ``init_batch`` give it: int64 for
    integer tensors."""
    t = torch.as_tensor(a)
    if a.dtype.kind in "iu":
        t = t.to(torch.int64)
    return t.to(dev)


def load_carry(path: str, like: Carry | None = None,
               device=None) -> Carry:
    """Load a carry saved by :func:`save_carry` (by either package).

    ``like`` (any carry with the same structure, e.g. a fresh
    ``init_carry`` / ``init_batch`` result) gives each leaf its dtype and
    device (and tells host ints from tensors, for carries that hold
    some).  Without it the canonical Carry field order is used: integer
    leaves become int64 tensors, on ``device`` (default:
    the card; raises if there is none).  Files written before the version
    entry existed (v1: trailing ``time_exceeded`` leaf) are migrated."""
    data = np.load(path)
    n_leaf = sum(1 for k in data.files if k.startswith("leaf_"))
    version = int(data["__format_version__"]) \
        if "__format_version__" in data.files else 1
    if version > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path!r} has format version {version}; this "
            f"build reads up to {FORMAT_VERSION}")
    leaves = [data[f"leaf_{i}"] for i in range(n_leaf)]
    names = _leaf_names()
    if version == 1 and len(leaves) == len(names) + 1:
        leaves = leaves[:-1]  # v1 trailing time_exceeded (bool) leaf
    if len(leaves) != len(names):
        raise ValueError(
            f"checkpoint {path!r} (format v{version}) holds {len(leaves)} "
            f"leaves; the current Carry has {len(names)} — the file was "
            "written by an incompatible version")
    if like is not None:
        like_leaves, spec = pytree.tree_flatten(like)
        return pytree.tree_unflatten(
            [_like(a, l) for a, l in zip(leaves, like_leaves)], spec)
    dev = resolve_device(device)
    spec = pytree.tree_flatten(_example_carry())[1]
    return pytree.tree_unflatten(
        [_canonical(a, dev) for a in leaves], spec)
