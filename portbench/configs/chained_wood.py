"""Chained Wood with Broyden banded equality constraints (Luksan and
Vlcek), as Enlsip.jl's test/problems/chained_wood.jl writes it: n = 20
parameters; for each block j = 0..8 of (x_2j, x_2j+1, x_2j+2, x_2j+3) six
residuals 10 (a^2 - b), a - 1, 3 sqrt(10) (c^2 - d), c - 1,
sqrt(10) (b + d - 2) and (b - d) / sqrt(10); 13 equalities
c_k = (2 + 5 x_{k+5}^2) x_{k+5} + 1 + sum_{i=max(k-5,0)}^{k+1} x_i (1 + x_i)
(0-based k); no bounds; start (-2, 1, -2, 1, ...).

The closures are what a user hands the solver: tensor code only, their
index tensors and the band made once here, so that the solve can be
captured and mapped over lanes.  The Jacobians are ``torch.func.jacfwd``
of the closures, as ``CnlsModel`` builds them where a model gives none.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def problem(dtype, device):
    n = 20
    blocks, q = n // 2 - 1, n - 7
    s = math.sqrt(10.0)
    j = torch.arange(blocks, device=device)
    a_i, b_i, c_i, d_i = 2 * j, 2 * j + 1, 2 * j + 2, 2 * j + 3
    k = torch.arange(q, device=device)
    i = torch.arange(n, device=device)
    band = ((i[None, :] >= (k - 5).clamp(min=0)[:, None])
            & (i[None, :] <= (k + 1)[:, None])).to(dtype)

    def residuals(x):
        a, b, c, d = x[a_i], x[b_i], x[c_i], x[d_i]
        return torch.cat([10.0 * (a ** 2 - b), a - 1.0,
                          3.0 * s * (c ** 2 - d), c - 1.0,
                          s * (b + d - 2.0), (b - d) / s])

    def eq_constraints(x):
        y = x[k + 5]
        return (2.0 + 5.0 * y ** 2) * y + 1.0 + band @ (x * (1.0 + x))

    return dict(
        n=n, m=6 * blocks, q=q, p=0, x_low=None, x_upp=None,
        x0=np.where(np.arange(n) % 2 == 0, -2.0, 1.0),
        res=residuals, jac_res=torch.func.jacfwd(residuals),
        eq=eq_constraints, jac_eq=torch.func.jacfwd(eq_constraints),
        ineq=None, jac_ineq=None, active_at_solution=q)
