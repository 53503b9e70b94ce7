"""Checkpoint / resume on the PyTorch/CUDA port: save a mid-solve carry,
reload it, continue.  The twin of ``examples/checkpoint_resume.py``.

The solver state is ONE fixed-shape structure of tensors
(``core.types.Carry``), so a checkpoint is a flat save of its leaves
(``utils/checkpoint.py``, a file the JAX package reads too), and the
continuation is the uninterrupted solve's: the loop body only reads the
carry.

Run on a machine with an NVIDIA GPU:
    python examples/torch_checkpoint_resume.py
or on the host:
    python examples/torch_checkpoint_resume.py --device cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

import enlsip_tpu_torch as et
from enlsip_tpu_torch._device import resolve_device
from enlsip_tpu_torch.core.driver import Functions, init_carry, iterate_body
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.models.model import build_constraint_functions
from enlsip_tpu_torch.utils import load_carry, save_carry


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
    cons, jac_cons = build_constraint_functions(model, args.device)
    fns = Functions(res=model.residuals,
                    jac_res=torch.func.jacfwd(model.residuals),
                    cons=cons, jac_cons=jac_cons)
    dims = Dims(n=3, m=3, q=0, l=7)
    dtype = torch.float32
    tols = Tols.for_dtype(dtype, args.device)

    def step(carry):
        return iterate_body(carry, fns, dims, Options(), tols)

    carry = init_carry(fns, model.starting_point, dims, Options(), dtype,
                       device=args.device)
    for _ in range(3):
        carry = step(carry)
    print(f"after 3 iterations: x = {carry.x.cpu().numpy()}")

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "state.npz")
        save_carry(path, carry)
        print(f"checkpointed to {path} "
              f"({os.path.getsize(path) / 1024:.1f} KiB)")
        resumed = load_carry(path, like=carry)

    while int(resumed.exit_code) == 0:
        resumed = step(resumed)
    f = float(torch.dot(resumed.rx, resumed.rx))
    print(f"resumed -> exit {int(resumed.exit_code)}, "
          f"x = {resumed.x.cpu().numpy()}, f = {f:.7f}")
    assert int(resumed.exit_code) > 0
    assert abs(f - 0.9535289) < 1e-4
    return resumed


if __name__ == "__main__":
    main()
