"""Batched parameter estimation on the PyTorch/CUDA port: thousands of
ODE-fit instances in one batch on one card, each lane fitting ITS OWN
noisy observation vector (the per-lane ``data=`` API) from a perturbed
start.  The twin of ``examples/batched_scenarios.py`` (its one-card
form; the batch-sharded form is ``parallel.solve_batched_sharded`` on
``torch.distributed``).

Run on a machine with an NVIDIA GPU:
    python examples/torch_batched_scenarios.py
or on the host, at a smaller size:
    python examples/torch_batched_scenarios.py --device cpu --batch 64
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

import enlsip_tpu_torch as et
from enlsip_tpu_torch._device import resolve_device
from enlsip_tpu_torch.core.driver import Functions
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.models.model import (build_constraint_functions,
                                           total_nb_constraints)
from enlsip_tpu_torch.parallel import solve_batched
from enlsip_tpu_torch.problems import ode_fit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the batch runs ('cpu' to run on the host)")
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)   # raises with no card

    model = et.CnlsModel(**ode_fit.model_kwargs())
    dtype = torch.float32
    cons, jac_cons = build_constraint_functions(model, args.device)
    fns = Functions(
        res=ode_fit.residuals_data,
        jac_res=torch.func.jacfwd(ode_fit.residuals_data),
        cons=lambda x, y: cons(x), jac_cons=lambda x, y: jac_cons(x))
    dims = Dims(n=model.nb_parameters, m=model.nb_residuals, q=0,
                l=total_nb_constraints(model))
    tols = Tols.for_dtype(dtype, args.device)

    starts = ode_fit.perturbed_starts(args.batch)
    ys = ode_fit.scenario_observations(args.batch).astype(np.float32)
    res_b = solve_batched(fns, starts, dims, Options(), tols, dtype=dtype,
                          data=ys, device=args.device)
    f = res_b.f.double().cpu().numpy()
    share = float(np.mean(f < 1e-3))
    print(f"{args.batch} instances (per-lane observations): "
          f"{share:.1%} reached the noise-level optimum; "
          f"median f = {np.median(f):.2e}")
    return share


if __name__ == "__main__":
    main()
