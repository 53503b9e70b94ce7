"""Single CNLS solve on the PyTorch/CUDA port: the HS65 README example.
The twin of ``examples/single_solve.py``.

Run on a machine with an NVIDIA GPU:
    python examples/torch_single_solve.py
or on the host:
    python examples/torch_single_solve.py --device cpu
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the solve runs ('cpu' to run on the host)")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)   # raises with no card

    model = et.CnlsModel(
        residuals=lambda x: torch.stack(
            [x[0] - x[1], (x[0] + x[1] - 10.0) / 3.0, x[2] - 5.0]),
        nb_parameters=3, nb_residuals=3,
        starting_point=np.array([-5.0, 5.0, 0.0]),
        ineq_constraints=lambda x: (48.0 - x[0] ** 2 - x[1] ** 2
                                    - x[2] ** 2)[None],
        nb_ineqcons=1,
        x_low=np.array([-4.5, -4.5, -5.0]),
        x_upp=np.array([4.5, 4.5, 5.0]))
    et.solve(model, silent=False, device=args.device)
    print("status:", et.status(model))
    print("solution:", et.solution(model))
    print("objective:", et.sum_sq_residuals(model))
    return model


if __name__ == "__main__":
    main()
