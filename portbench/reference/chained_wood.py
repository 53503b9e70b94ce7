"""Chained Wood with Broyden banded equalities (n = 20), written out from
its definition for a stack of points X (N, 20), float64.

Block j = 0..8 holds (a, b, c, d) = (x_2j, x_2j+1, x_2j+2, x_2j+3) and
six residuals: 10 (a^2 - b), a - 1, 3 sqrt(10) (c^2 - d), c - 1,
sqrt(10) (b + d - 2), (b - d) / sqrt(10).  Equalities, k = 0..12
(0-based): (2 + 5 x_{k+5}^2) x_{k+5} + 1 + sum over i from max(k - 5, 0)
to k + 1 of x_i (1 + x_i) = 0.
"""

from __future__ import annotations

import math

import torch

N_PARAMS = 20
BLOCKS = N_PARAMS // 2 - 1
N_EQ = N_PARAMS - 7
S = math.sqrt(10.0)


def _blocks(X):
    a = X[:, 0:2 * BLOCKS:2]
    b = X[:, 1:2 * BLOCKS + 1:2]
    c = X[:, 2:2 * BLOCKS + 2:2]
    d = X[:, 3:2 * BLOCKS + 3:2]
    return a, b, c, d


def residuals(X):
    """(N, 54), six residuals a block, block after block."""
    a, b, c, d = _blocks(X)
    r = torch.stack([10.0 * (a * a - b), a - 1.0, 3.0 * S * (c * c - d),
                     c - 1.0, S * (b + d - 2.0), (b - d) / S], dim=2)
    return r.reshape(X.shape[0], 6 * BLOCKS)


def equalities(X) -> int:
    return N_EQ


def objective(X):
    r = residuals(X)
    return (r * r).sum(1)


def gradient(X):
    """2 J^T r, block by block."""
    a, b, c, d = _blocks(X)
    r1, r2 = 10.0 * (a * a - b), a - 1.0
    r3, r4 = 3.0 * S * (c * c - d), c - 1.0
    r5, r6 = S * (b + d - 2.0), (b - d) / S
    g = torch.zeros_like(X)
    g[:, 0:2 * BLOCKS:2] += 2.0 * (20.0 * a * r1 + r2)
    g[:, 1:2 * BLOCKS + 1:2] += 2.0 * (-10.0 * r1 + S * r5 + r6 / S)
    g[:, 2:2 * BLOCKS + 2:2] += 2.0 * (6.0 * S * c * r3 + r4)
    g[:, 3:2 * BLOCKS + 3:2] += 2.0 * (-3.0 * S * r3 + S * r5 - r6 / S)
    return g


def constraints(X):
    rows = []
    for k in range(N_EQ):
        y = X[:, k + 5]
        lo, hi = max(k - 5, 0), k + 1
        w = X[:, lo:hi + 1]
        rows.append((2.0 + 5.0 * y * y) * y + 1.0 + (w * (1.0 + w)).sum(1))
    return torch.stack(rows, dim=1)


def constraint_jacobian(X):
    A = torch.zeros((X.shape[0], N_EQ, N_PARAMS), dtype=X.dtype,
                    device=X.device)
    for k in range(N_EQ):
        lo, hi = max(k - 5, 0), k + 1
        A[:, k, lo:hi + 1] = 1.0 + 2.0 * X[:, lo:hi + 1]
        y = X[:, k + 5]
        A[:, k, k + 5] = 2.0 + 15.0 * y * y
    return A
