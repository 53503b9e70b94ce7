"""Hock-Schittkowski problem 65 as Enlsip.jl's test/problems/HS65.jl
writes it: 3 parameters, residuals (x1 - x2, (x1 + x2 - 10)/3, x3 - 5),
one inequality 48 - x1^2 - x2^2 - x3^2 >= 0, box bounds, analytic
Jacobians, start (-5, 5, 0).

The closures are what a user hands the solver: tensor code only, their
constant made once here, so that the solve can be captured and mapped
over lanes.
"""

from __future__ import annotations

import numpy as np
import torch


def problem(dtype, device):
    jac = torch.tensor([[1.0, -1.0, 0.0],
                        [1.0 / 3.0, 1.0 / 3.0, 0.0],
                        [0.0, 0.0, 1.0]], dtype=dtype, device=device)

    def residuals(x):
        return torch.stack([x[0] - x[1], (x[0] + x[1] - 10.0) / 3.0,
                            x[2] - 5.0])

    def jac_residuals(x):
        return jac

    def ineq_constraints(x):
        return (48.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2)[None]

    def jac_ineq_constraints(x):
        return (-2.0 * x)[None, :]

    return dict(
        n=3, m=3, q=0, p=1,
        x_low=np.array([-4.5, -4.5, -5.0]), x_upp=np.array([4.5, 4.5, 5.0]),
        x0=np.array([-5.0, 5.0, 0.0]),
        res=residuals, jac_res=jac_residuals, eq=None, jac_eq=None,
        ineq=ineq_constraints, jac_ineq=jac_ineq_constraints,
        active_at_solution=1)
