"""Constant data of the problem closures, on the device once.

A closure that turned a numpy array into a tensor at every call would
copy host data to the card inside the solve, which a captured CUDA graph
cannot hold.  :func:`on_device` makes the tensor once per array, device
and dtype, at the first call; the solve evaluates its closures once
eagerly before it captures (``_graph.run``'s warm-up), so that call
never happens inside a capture.
"""

from __future__ import annotations

import torch

_cache: dict = {}


def on_device(array, like: torch.Tensor) -> torch.Tensor:
    """``array`` (a module-level constant) as a tensor of ``like``'s
    dtype on ``like``'s device."""
    key = (id(array), like.device, like.dtype)
    hit = _cache.get(key)
    if hit is None:
        hit = _cache[key] = (torch.as_tensor(array, dtype=like.dtype,
                                             device=like.device),
                             array)        # kept, so its id is not reused
    return hit[0]
