"""Forward-difference Jacobian fallback.

The reference ships a hand-rolled forward-difference Jacobian with step
``delta_j = max(|x_j|, 1) * sqrt(eps)`` even though its constructors
default to AD; the same scheme is kept for user callables that
``torch.func`` cannot differentiate (e.g. ones wrapping an external
simulator), and as the behavioral spec of the no-AD path.
"""

from __future__ import annotations

from typing import Callable

import torch


def jac_forward_diff(fn: Callable) -> Callable:
    """Return x -> J where J[i, j] = (fn(x + d_j e_j) - fn(x)) / d_j,
    d_j = max(|x_j|, 1) * sqrt(eps(dtype))."""

    def jac(x):
        x = torch.as_tensor(x)
        sqrel = torch.finfo(x.dtype).eps ** 0.5
        f0 = fn(x)
        delta = torch.clamp(x.abs(), min=1.0) * sqrel
        cols = []
        for j in range(x.shape[0]):
            xj = x.clone()
            xj[j] += delta[j]
            cols.append((fn(xj) - f0) / delta[j])
        return torch.stack(cols, dim=1)

    return jac
