"""Hock–Schittkowski CNLS problem suite, as torch closures.

Counterpart of ``enlsip_tpu/problems/hs.py``: the 28 problems of the
collection whose objectives are natural sums of squares.  Each entry is
a builder returning ``(model_kwargs, fstar)`` where ``model_kwargs``
feeds :class:`enlsip_tpu_torch.CnlsModel` and ``fstar`` is the published
optimum of the objective (= sum of squared residuals).  Problem data
from W. Hock, K. Schittkowski, "Test Examples for Nonlinear Programming
Codes", LNEMS 187, Springer 1981.

The closures take a 1-d tensor and build their constants on its device
and dtype, so they run under ``torch.func.vmap`` / ``jacfwd`` /
``hessian`` on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from .classic import HS65, HS65_FSTAR

_SQRT2 = float(np.sqrt(2.0))


def _rosenbrock_residuals(x):
    return torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


def hs1():
    return dict(
        residuals=_rosenbrock_residuals, nb_parameters=2, nb_residuals=2,
        x_low=np.array([-np.inf, -1.5]),
        starting_point=np.array([-2.0, 1.0])), 0.0


def hs2():
    return dict(
        residuals=_rosenbrock_residuals, nb_parameters=2, nb_residuals=2,
        x_low=np.array([-np.inf, 1.5]),
        starting_point=np.array([-2.0, 1.0])), 0.0504261879


def hs6():
    return dict(
        residuals=lambda x: torch.stack([1.0 - x[0]]),
        nb_parameters=2, nb_residuals=1,
        eq_constraints=lambda x: torch.stack([10.0 * (x[1] - x[0] ** 2)]),
        nb_eqcons=1,
        starting_point=np.array([-1.2, 1.0])), 0.0


def hs13():
    # Constraint qualification fails at the solution; kept for coverage.
    return dict(
        residuals=lambda x: torch.stack([x[0] - 2.0, x[1]]),
        nb_parameters=2, nb_residuals=2,
        ineq_constraints=lambda x: torch.stack([(1.0 - x[0]) ** 3 - x[1]]),
        nb_ineqcons=1,
        x_low=np.zeros(2),
        starting_point=np.array([-2.0, -2.0])), 1.0


def hs14():
    return dict(
        residuals=lambda x: torch.stack([x[0] - 2.0, x[1] - 1.0]),
        nb_parameters=2, nb_residuals=2,
        eq_constraints=lambda x: torch.stack([x[0] - 2.0 * x[1] + 1.0]),
        nb_eqcons=1,
        ineq_constraints=lambda x: torch.stack(
            [-0.25 * x[0] ** 2 - x[1] ** 2 + 1.0]),
        nb_ineqcons=1,
        starting_point=np.array([2.0, 2.0])), 1.3934649807


def hs15():
    return dict(
        residuals=_rosenbrock_residuals, nb_parameters=2, nb_residuals=2,
        ineq_constraints=lambda x: torch.stack(
            [x[0] * x[1] - 1.0, x[0] + x[1] ** 2]),
        nb_ineqcons=2,
        x_upp=np.array([0.5, np.inf]),
        starting_point=np.array([-2.0, 1.0])), 306.5


def hs16():
    return dict(
        residuals=_rosenbrock_residuals, nb_parameters=2, nb_residuals=2,
        ineq_constraints=lambda x: torch.stack(
            [x[0] + x[1] ** 2, x[0] ** 2 + x[1]]),
        nb_ineqcons=2,
        x_low=np.array([-0.5, -np.inf]),
        x_upp=np.array([0.5, 1.0]),
        starting_point=np.array([-2.0, 1.0])), 0.25


def hs22():
    return dict(
        residuals=lambda x: torch.stack([x[0] - 2.0, x[1] - 1.0]),
        nb_parameters=2, nb_residuals=2,
        ineq_constraints=lambda x: torch.stack(
            [-x[0] - x[1] + 2.0, -x[0] ** 2 + x[1]]),
        nb_ineqcons=2,
        starting_point=np.array([2.0, 2.0])), 1.0


def hs23():
    return dict(
        residuals=lambda x: torch.stack([x[0], x[1]]),
        nb_parameters=2, nb_residuals=2,
        ineq_constraints=lambda x: torch.stack([
            x[0] + x[1] - 1.0,
            x[0] ** 2 + x[1] ** 2 - 1.0,
            9.0 * x[0] ** 2 + x[1] ** 2 - 9.0,
            x[0] ** 2 - x[1],
            x[1] ** 2 - x[0]]),
        nb_ineqcons=5,
        x_low=np.array([-50.0, -50.0]),
        x_upp=np.array([50.0, 50.0]),
        starting_point=np.array([3.0, 1.0])), 2.0


def hs26():
    return dict(
        residuals=lambda x: torch.stack([x[0] - x[1], (x[1] - x[2]) ** 2]),
        nb_parameters=3, nb_residuals=2,
        eq_constraints=lambda x: torch.stack(
            [(1.0 + x[1] ** 2) * x[0] + x[2] ** 4 - 3.0]),
        nb_eqcons=1,
        starting_point=np.array([-2.6, 2.0, 2.0])), 0.0


def hs27():
    return dict(
        residuals=lambda x: torch.stack([0.1 * (x[0] - 1.0),
                                         x[1] - x[0] ** 2]),
        nb_parameters=3, nb_residuals=2,
        eq_constraints=lambda x: torch.stack([x[0] + x[2] ** 2 + 1.0]),
        nb_eqcons=1,
        starting_point=np.array([2.0, 2.0, 2.0])), 0.04


def hs28():
    return dict(
        residuals=lambda x: torch.stack([x[0] + x[1], x[1] + x[2]]),
        nb_parameters=3, nb_residuals=2,
        eq_constraints=lambda x: torch.stack(
            [x[0] + 2.0 * x[1] + 3.0 * x[2] - 1.0]),
        nb_eqcons=1,
        starting_point=np.array([-4.0, 1.0, 1.0])), 0.0


def hs30():
    return dict(
        residuals=lambda x: torch.stack([x[0], x[1], x[2]]),
        nb_parameters=3, nb_residuals=3,
        ineq_constraints=lambda x: torch.stack(
            [x[0] ** 2 + x[1] ** 2 - 1.0]),
        nb_ineqcons=1,
        x_low=np.array([1.0, -10.0, -10.0]),
        x_upp=np.array([10.0, 10.0, 10.0]),
        starting_point=np.array([1.0, 1.0, 1.0])), 1.0


def hs31():
    return dict(
        residuals=lambda x: torch.stack([3.0 * x[0], x[1], 3.0 * x[2]]),
        nb_parameters=3, nb_residuals=3,
        ineq_constraints=lambda x: torch.stack([x[0] * x[1] - 1.0]),
        nb_ineqcons=1,
        x_low=np.array([-10.0, 1.0, -10.0]),
        x_upp=np.array([10.0, 10.0, 1.0]),
        starting_point=np.array([1.0, 1.0, 1.0])), 6.0


def hs32():
    return dict(
        residuals=lambda x: torch.stack([x[0] + 3.0 * x[1] + x[2],
                                         2.0 * (x[0] - x[1])]),
        nb_parameters=3, nb_residuals=2,
        eq_constraints=lambda x: torch.stack(
            [1.0 - x[0] - x[1] - x[2]]),
        nb_eqcons=1,
        ineq_constraints=lambda x: torch.stack(
            [6.0 * x[1] + 4.0 * x[2] - x[0] ** 3 - 3.0]),
        nb_ineqcons=1,
        x_low=np.zeros(3),
        starting_point=np.array([0.1, 0.7, 0.2])), 1.0


def hs42():
    return dict(
        residuals=lambda x: torch.stack([x[0] - 1.0, x[1] - 2.0,
                                         x[2] - 3.0, x[3] - 4.0]),
        nb_parameters=4, nb_residuals=4,
        eq_constraints=lambda x: torch.stack(
            [x[0] - 2.0, x[2] ** 2 + x[3] ** 2 - 2.0]),
        nb_eqcons=2,
        starting_point=np.array([1.0, 1.0, 1.0, 1.0])), 28.0 - 10.0 * _SQRT2


def hs46():
    return dict(
        residuals=lambda x: torch.stack([
            x[0] - x[1], x[2] - 1.0, (x[3] - 1.0) ** 2,
            (x[4] - 1.0) ** 3]),
        nb_parameters=5, nb_residuals=4,
        eq_constraints=lambda x: torch.stack([
            x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 1.0,
            x[1] + x[2] ** 4 * x[3] ** 2 - 2.0]),
        nb_eqcons=2,
        starting_point=np.array(
            [_SQRT2 / 2.0, 1.75, 0.5, 2.0, 2.0])), 0.0


def hs48():
    return dict(
        residuals=lambda x: torch.stack([x[0] - 1.0, x[1] - x[2],
                                         x[3] - x[4]]),
        nb_parameters=5, nb_residuals=3,
        eq_constraints=lambda x: torch.stack([
            x[0] + x[1] + x[2] + x[3] + x[4] - 5.0,
            x[2] - 2.0 * (x[3] + x[4]) + 3.0]),
        nb_eqcons=2,
        starting_point=np.array([3.0, 5.0, -3.0, 2.0, -2.0])), 0.0


def hs49():
    return dict(
        residuals=lambda x: torch.stack([
            x[0] - x[1], x[2] - 1.0, (x[3] - 1.0) ** 2,
            (x[4] - 1.0) ** 3]),
        nb_parameters=5, nb_residuals=4,
        eq_constraints=lambda x: torch.stack([
            x[0] + x[1] + x[2] + 4.0 * x[3] - 7.0,
            x[2] + 5.0 * x[4] - 6.0]),
        nb_eqcons=2,
        starting_point=np.array([10.0, 7.0, 2.0, -3.0, 0.8])), 0.0


def hs50():
    return dict(
        residuals=lambda x: torch.stack([
            x[0] - x[1], x[1] - x[2], (x[2] - x[3]) ** 2, x[3] - x[4]]),
        nb_parameters=5, nb_residuals=4,
        eq_constraints=lambda x: torch.stack([
            x[0] + 2.0 * x[1] + 3.0 * x[2] - 6.0,
            x[1] + 2.0 * x[2] + 3.0 * x[3] - 6.0,
            x[2] + 2.0 * x[3] + 3.0 * x[4] - 6.0]),
        nb_eqcons=3,
        starting_point=np.array([35.0, -31.0, 11.0, 5.0, -5.0])), 0.0


def hs51():
    return dict(
        residuals=lambda x: torch.stack([
            x[0] - x[1], x[1] + x[2] - 2.0, x[3] - 1.0, x[4] - 1.0]),
        nb_parameters=5, nb_residuals=4,
        eq_constraints=lambda x: torch.stack([
            x[0] + 3.0 * x[1] - 4.0,
            x[2] + x[3] - 2.0 * x[4],
            x[1] - x[4]]),
        nb_eqcons=3,
        starting_point=np.array([2.5, 0.5, 2.0, -1.0, 0.5])), 0.0


def hs52():
    return dict(
        residuals=lambda x: torch.stack([
            4.0 * x[0] - x[1], x[1] + x[2] - 2.0, x[3] - 1.0,
            x[4] - 1.0]),
        nb_parameters=5, nb_residuals=4,
        eq_constraints=lambda x: torch.stack([
            x[0] + 3.0 * x[1],
            x[2] + x[3] - 2.0 * x[4],
            x[1] - x[4]]),
        nb_eqcons=3,
        starting_point=np.array([2.0, 2.0, 2.0, 2.0, 2.0])), 1859.0 / 349.0


def hs53():
    return dict(
        residuals=lambda x: torch.stack([
            x[0] - x[1], x[1] + x[2] - 2.0, x[3] - 1.0, x[4] - 1.0]),
        nb_parameters=5, nb_residuals=4,
        eq_constraints=lambda x: torch.stack([
            x[0] + 3.0 * x[1],
            x[2] + x[3] - 2.0 * x[4],
            x[1] - x[4]]),
        nb_eqcons=3,
        x_low=np.full(5, -10.0),
        x_upp=np.full(5, 10.0),
        starting_point=np.array([2.0, 2.0, 2.0, 2.0, 2.0])), 176.0 / 43.0


_HS57_A = np.array([
    8, 8, 10, 10, 10, 10, 12, 12, 12, 12, 14, 14, 14, 16, 16, 16, 18, 18,
    20, 20, 20, 22, 22, 22, 24, 24, 24, 26, 26, 26, 28, 28, 30, 30, 30,
    32, 32, 34, 36, 36, 38, 38, 40, 42], dtype=float)
_HS57_B = np.array([
    0.49, 0.49, 0.48, 0.47, 0.48, 0.47, 0.46, 0.46, 0.45, 0.43, 0.45,
    0.43, 0.43, 0.44, 0.43, 0.43, 0.46, 0.45, 0.42, 0.42, 0.43, 0.41,
    0.41, 0.40, 0.42, 0.40, 0.40, 0.41, 0.40, 0.41, 0.41, 0.40, 0.40,
    0.40, 0.38, 0.41, 0.40, 0.40, 0.41, 0.38, 0.40, 0.40, 0.39, 0.39])


def _hs57_residuals(x):
    # exp(-x1 (a - 8)) overflows float32 for x1 below about -2.6 (a <= 42)
    a = torch.as_tensor(_HS57_A, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(_HS57_B, dtype=x.dtype, device=x.device)
    return b - x[0] - (0.49 - x[0]) * torch.exp(-x[1] * (a - 8.0))


def hs57():
    return dict(
        residuals=_hs57_residuals, nb_parameters=2, nb_residuals=44,
        ineq_constraints=lambda x: torch.stack(
            [0.49 * x[1] - x[0] * x[1] - 0.09]),
        nb_ineqcons=1,
        x_low=np.array([0.4, -4.0]),
        starting_point=np.array([0.42, 5.0])), 0.02845966972


def hs60():
    c = 4.0 + 3.0 * _SQRT2
    return dict(
        residuals=lambda x: torch.stack([
            x[0] - 1.0, x[0] - x[1], (x[1] - x[2]) ** 2]),
        nb_parameters=3, nb_residuals=3,
        eq_constraints=lambda x: torch.stack(
            [x[0] * (1.0 + x[1] ** 2) + x[2] ** 4 - c]),
        nb_eqcons=1,
        x_low=np.full(3, -10.0),
        x_upp=np.full(3, 10.0),
        starting_point=np.array([2.0, 2.0, 2.0])), 0.03256820025


def hs65():
    # the same problem, bounds and start as problems/classic.py's HS65
    return dict(HS65), HS65_FSTAR


def hs77():
    return dict(
        residuals=lambda x: torch.stack([
            x[0] - 1.0, x[0] - x[1], x[2] - 1.0, (x[3] - 1.0) ** 2,
            (x[4] - 1.0) ** 3]),
        nb_parameters=5, nb_residuals=5,
        eq_constraints=lambda x: torch.stack([
            x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 2.0 * _SQRT2,
            x[1] + x[2] ** 4 * x[3] ** 2 - 8.0 - _SQRT2]),
        nb_eqcons=2,
        starting_point=np.array([2.0, 2.0, 2.0, 2.0, 2.0])), 0.24150513


def hs79():
    return dict(
        residuals=lambda x: torch.stack([
            x[0] - 1.0, x[0] - x[1], x[1] - x[2],
            (x[2] - x[3]) ** 2, (x[3] - x[4]) ** 2]),
        nb_parameters=5, nb_residuals=5,
        eq_constraints=lambda x: torch.stack([
            x[0] + x[1] ** 2 + x[2] ** 3 - 2.0 - 3.0 * _SQRT2,
            x[1] - x[2] ** 2 + x[3] + 2.0 - 2.0 * _SQRT2,
            x[0] * x[4] - 2.0]),
        nb_eqcons=3,
        starting_point=np.array([2.0, 2.0, 2.0, 2.0, 2.0])), 0.0787768209


HS_PROBLEMS = {
    "hs1": hs1, "hs2": hs2, "hs6": hs6, "hs13": hs13, "hs14": hs14,
    "hs15": hs15, "hs16": hs16, "hs22": hs22, "hs23": hs23, "hs26": hs26,
    "hs27": hs27, "hs28": hs28, "hs30": hs30, "hs31": hs31, "hs32": hs32,
    "hs42": hs42, "hs46": hs46, "hs48": hs48, "hs49": hs49, "hs50": hs50,
    "hs51": hs51, "hs52": hs52, "hs53": hs53, "hs57": hs57, "hs60": hs60,
    "hs65": hs65, "hs77": hs77, "hs79": hs79,
}


def problem_names():
    return sorted(HS_PROBLEMS.keys())


def get_problem(name: str):
    """Returns (model_kwargs, fstar)."""
    return HS_PROBLEMS[name]()
