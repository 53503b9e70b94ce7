"""Chained Rosenbrock with trigonometric-exponential equalities, written
out from its definition for a stack of points X (N, n), float64.

Residuals r1_k = 10 (x_k^2 - x_{k+1}), r2_k = x_k - 1 (k < n - 1);
equalities, with (a, b, c) = (x_k, x_{k+1}, x_{k+2}) (k < n - 2):
3 b^3 + 2 c - 5 + sin(b - c) sin(b + c) + 4 b - a exp(a - b) - 3 = 0,
written here with sin(b - c) sin(b + c) = sin^2 b - sin^2 c.
"""

from __future__ import annotations

import torch


def equalities(X) -> int:
    return X.shape[-1] - 2


def objective(X):
    r1 = 10.0 * (X[:, :-1] ** 2 - X[:, 1:])
    r2 = X[:, :-1] - 1.0
    return (r1 * r1).sum(1) + (r2 * r2).sum(1)


def gradient(X):
    """2 J^T r."""
    r1 = 10.0 * (X[:, :-1] ** 2 - X[:, 1:])
    r2 = X[:, :-1] - 1.0
    g = torch.zeros_like(X)
    g[:, :-1] += 2.0 * (20.0 * X[:, :-1] * r1 + r2)
    g[:, 1:] -= 20.0 * r1
    return g


def constraints(X):
    a, b, c = X[:, :-2], X[:, 1:-1], X[:, 2:]
    return (3.0 * b ** 3 + 2.0 * c - 8.0 + torch.sin(b) ** 2
            - torch.sin(c) ** 2 + 4.0 * b - a * torch.exp(a - b))


def constraint_jacobian(X):
    a, b, c = X[:, :-2], X[:, 1:-1], X[:, 2:]
    e = torch.exp(a - b)
    N, n = X.shape
    A = torch.zeros((N, n - 2, n), dtype=X.dtype, device=X.device)
    torch.diagonal(A, 0, 1, 2).copy_(-(1.0 + a) * e)
    torch.diagonal(A, 1, 1, 2).copy_(9.0 * b ** 2 + torch.sin(2.0 * b)
                                     + 4.0 + a * e)
    torch.diagonal(A, 2, 1, 2).copy_(2.0 - torch.sin(2.0 * c))
    return A
