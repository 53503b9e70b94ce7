"""The four classic test problems of the reference suite, as torch
closures: HS65, the Osborne-2 variant, Chained Rosenbrock(n) and Chained
Wood(n).  Each is a dict of ``CnlsModel`` keyword arguments.

All closures build their constants on the input's device and dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._const import on_device

# ---------------------------------------------------------------- HS65

HS65_XSTAR = np.array([3.650461821, 3.65046168, 4.6204170507])
HS65_FSTAR = 0.9535288567


def hs65_residuals(x):
    return torch.stack([x[0] - x[1], (x[0] + x[1] - 10.0) / 3.0, x[2] - 5.0])


_HS65_JAC = np.array([[1.0, -1.0, 0.0],
                      [1.0 / 3.0, 1.0 / 3.0, 0.0],
                      [0.0, 0.0, 1.0]])


def hs65_jac_residuals(x):
    return on_device(_HS65_JAC, x)


def hs65_ineq(x):
    return (48.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2)[None]


def hs65_jac_ineq(x):
    return (-2.0 * x)[None, :]


HS65 = dict(
    residuals=hs65_residuals,
    jacobian_residuals=hs65_jac_residuals,
    nb_parameters=3,
    nb_residuals=3,
    ineq_constraints=hs65_ineq,
    jacobian_ineqcons=hs65_jac_ineq,
    nb_ineqcons=1,
    x_low=np.array([-4.5, -4.5, -5.0]),
    x_upp=np.array([4.5, 4.5, 5.0]),
    starting_point=np.array([-5.0, 5.0, 0.0]),
)


# ------------------------------------------------------------ Osborne 2
# The reference's modified-data variant.

OSBORNE2_T = 0.1 * np.arange(65)
OSBORNE2_Y = np.array([
    1.366, 1.191, 1.112, 1.013, 0.991, 0.885, 0.831, 0.847, 0.786, 0.725,
    0.746, 0.679, 0.608, 0.655, 0.616, 0.606, 0.602, 0.626, 0.651, 0.724,
    0.649, 0.649, 0.694, 0.644, 0.624, 0.661, 0.612, 0.558, 0.533, 0.495,
    0.500, 0.423, 0.395, 0.375, 0.538, 0.522, 0.506, 0.490, 0.478, 0.467,
    0.457, 0.457, 0.457, 0.457, 0.457, 0.457, 0.457, 0.457, 0.457, 0.457,
    0.457, 0.431, 0.431, 0.424, 0.420, 0.414, 0.411, 0.406, 0.406, 0.406,
    0.406, 0.406, 0.406, 0.406, 0.406])

OSBORNE2_X0 = np.array([
    1.3344098963722457, 0.5572842161127423, 0.6757364753061974,
    0.8291980513226953, 0.9233565833014519, 0.9588470511477797,
    1.9610314699563896, 4.055321823656234, 2.048625993866472,
    4.60296578920499, 5.95212572157736])


def osborne2_residuals(x):
    t = on_device(OSBORNE2_T, x)
    y = on_device(OSBORNE2_Y, x)
    model = (x[0] * torch.exp(-x[4] * t)
             + x[1] * torch.exp(-x[5] * (t - x[8]) ** 2)
             + x[2] * torch.exp(-x[6] * (t - x[9]) ** 2)
             + x[3] * torch.exp(-x[7] * (t - x[10]) ** 2))
    return y - model


OSBORNE2 = dict(
    residuals=osborne2_residuals,
    nb_parameters=11,
    nb_residuals=65,
    x_low=np.array([1.31, 0.4314, 0.6336, 0.5, 0.5, 0.6, 1.0, 4.0, 2.0,
                    4.5689, 5.0]),
    x_upp=np.array([1.4, 0.8, 1.0, 1.0, 1.0, 3.0, 5.0, 7.0, 2.5, 5.0, 6.0]),
    starting_point=OSBORNE2_X0,
)


# -------------------------------------------------- Chained Rosenbrock

def chained_rosenbrock(n: int):
    """n params, m = 2(n-1) residuals (two concatenated blocks),
    n-2 equality constraints."""
    m = 2 * (n - 1)

    def residuals(x):
        return torch.cat([10.0 * (x[:-1] ** 2 - x[1:]), x[:-1] - 1.0])

    def jac_residuals(x):
        nn = x.shape[0]
        k = torch.arange(nn - 1, device=x.device)
        # the banded entries written out of place into zeros, so that
        # torch.func.vmap can lift the closure onto a batch of lanes
        top = torch.zeros((nn - 1, nn), dtype=x.dtype, device=x.device)
        top = top.index_put((k, k), 20.0 * x[:-1])
        top = top.index_put((k, k + 1), torch.full_like(x[:-1], -10.0))
        bot = torch.eye(nn - 1, nn, dtype=x.dtype, device=x.device)
        return torch.cat([top, bot])

    def eq_cons(x):
        xk = x[:-2]
        xk1 = x[1:-1]
        xk2 = x[2:]
        return (3.0 * xk1 ** 3 + 2.0 * xk2 - 5.0
                + torch.sin(xk1 - xk2) * torch.sin(xk1 + xk2)
                + 4.0 * xk1 - xk * torch.exp(xk - xk1) - 3.0)

    def jac_eq_cons(x):
        nn = x.shape[0]
        xk = x[:-2]
        xk1 = x[1:-1]
        xk2 = x[2:]
        k = torch.arange(nn - 2, device=x.device)
        A = torch.zeros((nn - 2, nn), dtype=x.dtype, device=x.device)
        A = A.index_put((k, k), -(xk + 1.0) * torch.exp(xk - xk1))
        A = A.index_put((k, k + 1),
                        9.0 * xk1 ** 2
                        + torch.cos(xk1 - xk2) * torch.sin(xk1 + xk2)
                        + torch.sin(xk1 - xk2) * torch.cos(xk1 + xk2)
                        + 4.0 + xk * torch.exp(xk - xk1))
        A = A.index_put((k, k + 2),
                        2.0 - torch.cos(xk1 - xk2) * torch.sin(xk1 + xk2)
                        + torch.sin(xk1 - xk2) * torch.cos(xk1 + xk2))
        return A

    x0 = np.where(np.arange(n) % 2 == 0, -1.2, 1.0)
    return dict(residuals=residuals, jacobian_residuals=jac_residuals,
                nb_parameters=n, nb_residuals=m,
                eq_constraints=eq_cons, jacobian_eqcons=jac_eq_cons,
                nb_eqcons=n - 2, starting_point=x0)


# --------------------------------------------------------- Chained Wood
# Exercises the Newton direction path.

def chained_wood(n: int = 20):
    """n (even, >= 8) params, m = 6(n/2 - 1) residuals, n-7 equality
    constraints."""
    assert n % 2 == 0 and n >= 8
    N = n // 2 - 1
    s = math.sqrt(10.0)

    def residuals(x):
        jj = torch.arange(N, device=x.device)
        x1 = x[2 * jj]
        x2 = x[2 * jj + 1]
        x3 = x[2 * jj + 2]
        x4 = x[2 * jj + 3]
        return torch.cat([
            10.0 * (x1 ** 2 - x2),
            x1 - 1.0,
            3.0 * s * (x3 ** 2 - x4),
            x3 - 1.0,
            s * (x2 + x4 - 2.0),
            (x2 - x4) / s,
        ])

    def eq_cons(x):
        # c_k = (2 + 5 x_{k+5}^2) x_{k+5} + 1
        #       + sum_{i=max(k-5,1)}^{k+1} x_i (1 + x_i),  k = 1..n-7
        # (1-based; all indices shifted by -1 below)
        nn = x.shape[0]
        kk = torch.arange(nn - 7, device=x.device)
        xk5 = x[kk + 5]
        i = torch.arange(nn, device=x.device)
        lo = torch.clamp(kk - 5, min=0)
        hi = kk + 1
        inwin = (i[None, :] >= lo[:, None]) & (i[None, :] <= hi[:, None])
        terms = x * (1.0 + x)
        ssum = torch.sum(inwin.to(x.dtype) * terms[None, :], dim=1)
        return (2.0 + 5.0 * xk5 ** 2) * xk5 + 1.0 + ssum

    x0 = np.where(np.arange(n) % 2 == 0, -2.0, 1.0)
    return dict(residuals=residuals, nb_parameters=n, nb_residuals=6 * N,
                eq_constraints=eq_cons, nb_eqcons=n - 7, starting_point=x0)
