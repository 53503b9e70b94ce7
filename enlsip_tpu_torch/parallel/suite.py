"""Mixed-problem scenario batches, bucketed by family.

Counterpart of ``enlsip_tpu/parallel/suite.py``.  A batch that mixes
instances of different problem families with different (n, m, q, l) is
solved one family at a time: each family's lanes run as one
:func:`~enlsip_tpu_torch.parallel.batch.solve_batched` call, and the
families run back to back.  No padding: every lane follows the
trajectory of its family's own batch.  ``parallel/hetero.py`` fuses the
families into ONE batch instead.

For the Hock–Schittkowski suite, :func:`hs_scenario_batch` builds the
per-family inputs from ``enlsip_tpu_torch.problems``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.driver import Functions
from ..core.types import Dims, Options
from ..models.model import (CnlsModel, _ad_jac, build_constraint_functions,
                            total_nb_constraints)
from ..problems import get_problem
from .batch import solve_batched


class FamilySpec(NamedTuple):
    fns: Functions
    dims: Dims
    x0_batch: torch.Tensor  # (B_f, n_f)
    fstar: Optional[float] = None


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "multi-device batches are not ported yet (ROADMAP queue A, "
            "item A13); call without mesh=")


def solve_suite_batched(families: dict, opts: Options, tols_fn,
                        mesh=None, dtype=torch.float32,
                        device=None) -> dict:
    """Solve every family's batch; returns {name: BatchResult}.

    ``tols_fn(dtype) -> Tols``.  Runs on ``device`` (default: the card;
    raises if there is none)."""
    _no_mesh(mesh)
    return {name: solve_batched(spec.fns, spec.x0_batch, spec.dims, opts,
                                tols_fn(dtype), dtype=dtype, device=device)
            for name, spec in families.items()}


def hs_scenario_batch(names, per_family: int, seed: int = 0,
                      scale: float = 0.1, device=None) -> dict:
    """Build FamilySpecs for HS problems: ``per_family`` perturbed
    starting points each, ``x0 + scale (1 + |x0|) N(0, 1)`` drawn from
    ``np.random.default_rng(seed)`` family after family in the order of
    ``names`` (the JAX package's draws, so both get the same starts).
    The starts are float64 tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    families = {}
    for name in names:
        kw, fstar = get_problem(name)
        model = CnlsModel(**kw)
        cons, jac_cons = build_constraint_functions(model, dev)
        fns = Functions(
            res=model.residuals,
            jac_res=model.jacobian_residuals or _ad_jac(model.residuals),
            cons=cons, jac_cons=jac_cons)
        dims = Dims(n=model.nb_parameters, m=model.nb_residuals,
                    q=model.nb_eqcons, l=total_nb_constraints(model))
        x0 = np.asarray(model.starting_point, dtype=float)
        starts = x0[None, :] + scale * (1.0 + np.abs(x0))[None, :] * \
            rng.normal(size=(per_family, dims.n))
        families[name] = FamilySpec(
            fns=fns, dims=dims,
            x0_batch=torch.as_tensor(starts, dtype=torch.float64,
                                     device=dev),
            fstar=fstar)
    return families
