"""Multistart on the PyTorch/CUDA port: escape an alternate stationary
point in one batch.  The twin of ``examples/multistart.py``.

HS2 from its published standard start converges to an alternate local
solution (f = 4.941), as the reference algorithm does.  Re-solving from
K perturbed starts as K batched lanes costs one batch solve and finds
the published global optimum f* = 0.0504.

Run on a machine with an NVIDIA GPU:
    python examples/torch_multistart.py
or on the host:
    python examples/torch_multistart.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch

import enlsip_tpu_torch as et
from enlsip_tpu_torch._device import resolve_device
from enlsip_tpu_torch.core.driver import Functions
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.models.model import (build_constraint_functions,
                                           total_nb_constraints)
from enlsip_tpu_torch.parallel import solve_multistart
from enlsip_tpu_torch.problems import get_problem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the batch runs ('cpu' to run on the host)")
    ap.add_argument("--starts", type=int, default=16,
                    help="K, the lanes of the batch")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)   # raises with no card

    kw, fstar = get_problem("hs2")
    model = et.CnlsModel(**kw)
    cons, jac_cons = build_constraint_functions(model, args.device)
    fns = Functions(
        res=model.residuals,
        jac_res=model.jacobian_residuals or torch.func.jacfwd(model.residuals),
        cons=cons, jac_cons=jac_cons)
    dims = Dims(n=model.nb_parameters, m=model.nb_residuals,
                q=model.nb_eqcons, l=total_nb_constraints(model))
    dtype = torch.float32
    tols = Tols.for_dtype(dtype, args.device)

    ms = solve_multistart(fns, model.starting_point, dims, Options(), tols,
                          K=args.starts, scale=1.0, seed=1, dtype=dtype,
                          escalate_f64=True, device=args.device)
    f0 = float(ms.batch.f[0])
    print(f"standard start (lane 0):  f = {f0:.7f}   <- alternate point")
    print(f"best of {ms.n_converged} converged lanes: "
          f"f = {float(ms.f):.7f}   (published f* = {fstar})")
    print(f"x = {ms.x.cpu().numpy()}, exit_code = {int(ms.exit_code)}")
    assert abs(float(ms.f) - fstar) <= 1e-4 * (1 + abs(fstar))
    return ms


if __name__ == "__main__":
    main()
