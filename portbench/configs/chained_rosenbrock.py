"""Chained Rosenbrock with trigonometric-exponential equality constraints
(Luksan and Vlcek), as Enlsip.jl's test/problems/chained_rosenbrock.jl
and its tutorial write it: n parameters, m = 2(n - 1) residuals
10 (x_k^2 - x_{k+1}) and x_k - 1, n - 2 equalities, analytic Jacobians,
start (-1.2, 1, -1.2, ...).

The closures are what a user hands the solver: tensor code only, their
index tensors made once here, so that the solve can be captured.
"""

from __future__ import annotations

import numpy as np
import torch


def problem(dtype, device, n):
    n = int(n)
    m = 2 * (n - 1)
    k1 = torch.arange(n - 1, device=device)
    k2 = torch.arange(n - 2, device=device)

    def residuals(x):
        return torch.cat([10.0 * (x[:-1] ** 2 - x[1:]), x[:-1] - 1.0])

    def jac_residuals(x):
        top = torch.zeros((n - 1, n), dtype=x.dtype, device=x.device)
        top = top.index_put((k1, k1), 20.0 * x[:-1])
        top = top.index_put((k1, k1 + 1), torch.full_like(x[:-1], -10.0))
        bottom = torch.eye(n - 1, n, dtype=x.dtype, device=x.device)
        return torch.cat([top, bottom])

    def eq_constraints(x):
        a, b, c = x[:-2], x[1:-1], x[2:]
        return (3.0 * b ** 3 + 2.0 * c - 5.0
                + torch.sin(b - c) * torch.sin(b + c)
                + 4.0 * b - a * torch.exp(a - b) - 3.0)

    def jac_eq_constraints(x):
        a, b, c = x[:-2], x[1:-1], x[2:]
        e = torch.exp(a - b)
        A = torch.zeros((n - 2, n), dtype=x.dtype, device=x.device)
        A = A.index_put((k2, k2), -(1.0 + a) * e)
        A = A.index_put((k2, k2 + 1),
                        9.0 * b ** 2 + torch.cos(b - c) * torch.sin(b + c)
                        + torch.sin(b - c) * torch.cos(b + c) + 4.0 + a * e)
        A = A.index_put((k2, k2 + 2),
                        2.0 - torch.cos(b - c) * torch.sin(b + c)
                        + torch.sin(b - c) * torch.cos(b + c))
        return A

    return dict(
        n=n, m=m, q=n - 2, p=0, x_low=None, x_upp=None,
        x0=np.where(np.arange(n) % 2 == 0, -1.2, 1.0),
        res=residuals, jac_res=jac_residuals,
        eq=eq_constraints, jac_eq=jac_eq_constraints,
        ineq=None, jac_ineq=None, active_at_solution=n - 2)
