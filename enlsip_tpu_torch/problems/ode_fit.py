"""Batched parameter-estimation problem: 10-parameter ODE-style
exponential-mixture data fit with bounds.

Counterpart of ``enlsip_tpu/problems/ode_fit.py`` (the constants are
this module's own copy, generated the same way).

Model: y(t; theta) = sum_{k=1}^{5} a_k * exp(-b_k * t) sampled at 40
time points — a classic stiff-ish multiexponential fit (the same family
as Osborne-1/2) with box constraints a_k in [0, 5], b_k in [0.01, 20].
Each batch lane perturbs the starting point; the data is shared, or per
lane through ``residuals_data`` and ``scenario_observations``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._const import on_device

N_PARAMS = 10
N_POINTS = 40
_T = np.linspace(0.0, 2.0, N_POINTS)
_TRUE = np.array([1.0, 0.8, 0.6, 0.4, 0.2, 0.5, 1.5, 3.0, 5.0, 8.0])
_rng = np.random.default_rng(7)
_Y = (np.sum(_TRUE[:5, None] * np.exp(-_TRUE[5:, None] * _T[None, :]),
             axis=0) + 0.001 * _rng.normal(size=N_POINTS))

X0 = np.array([0.5, 0.5, 0.5, 0.5, 0.5, 1.0, 2.0, 4.0, 6.0, 7.0])
X_LOW = np.concatenate([np.zeros(5), np.full(5, 0.01)])
X_UPP = np.concatenate([np.full(5, 5.0), np.full(5, 20.0)])


def _model(x):
    a = x[:5]
    b = x[5:]
    t = on_device(_T, x)
    return torch.sum(a[:, None] * torch.exp(-b[:, None] * t[None, :]), dim=0)


def residuals(x):
    return on_device(_Y, x) - _model(x)


def model_kwargs():
    return dict(residuals=residuals, nb_parameters=N_PARAMS,
                nb_residuals=N_POINTS, x_low=X_LOW, x_upp=X_UPP,
                starting_point=X0)


def perturbed_starts(batch: int, seed: int = 0, scale: float = 0.1):
    rng = np.random.default_rng(seed)
    starts = X0[None, :] * (1.0 + scale * rng.normal(size=(batch, N_PARAMS)))
    return np.clip(starts, X_LOW + 1e-3, X_UPP - 1e-3)


# --- per-lane scenario data (the ``data=`` argument of solve_batched) --

def residuals_data(x, y):
    """Residuals against a per-lane observation vector ``y`` (40,)."""
    return y - _model(x)


def scenario_observations(batch: int, seed: int = 1, noise: float = 0.001):
    """(batch, 40) noisy observations: each lane draws its own noise
    realisation of the shared true curve."""
    rng = np.random.default_rng(seed)
    clean = np.sum(_TRUE[:5, None] * np.exp(-_TRUE[5:, None] * _T[None, :]),
                   axis=0)
    return clean[None, :] + noise * rng.normal(size=(batch, N_POINTS))
