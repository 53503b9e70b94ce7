"""Hock-Schittkowski problem 65 written out from its definition for a
stack of points X (N, 3), float64: f = (x1 - x2)^2 + ((x1 + x2 - 10)/3)^2
+ (x3 - 5)^2, subject to 48 - |x|^2 >= 0, -4.5 <= x1, x2 <= 4.5 and
-5 <= x3 <= 5.  Constraints in the form c(x) >= 0:
[48 - |x|^2, x - lower, upper - x]."""

from __future__ import annotations

import torch

LOWER = (-4.5, -4.5, -5.0)
UPPER = (4.5, 4.5, 5.0)


def equalities(X) -> int:
    return 0


def objective(X):
    x1, x2, x3 = X[:, 0], X[:, 1], X[:, 2]
    return (x1 - x2) ** 2 + ((x1 + x2 - 10.0) / 3.0) ** 2 + (x3 - 5.0) ** 2


def gradient(X):
    x1, x2, x3 = X[:, 0], X[:, 1], X[:, 2]
    d, s = x1 - x2, (x1 + x2 - 10.0) / 3.0
    return torch.stack([2.0 * d + 2.0 * s / 3.0, -2.0 * d + 2.0 * s / 3.0,
                        2.0 * (x3 - 5.0)], dim=1)


def constraints(X):
    lo = X.new_tensor(LOWER)
    up = X.new_tensor(UPPER)
    return torch.cat([48.0 - (X * X).sum(1, keepdim=True), X - lo, up - X],
                     dim=1)


def constraint_jacobian(X):
    N = X.shape[0]
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(N, 3, 3)
    return torch.cat([-2.0 * X[:, None, :], eye, -eye], dim=1)
