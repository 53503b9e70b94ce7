"""ENLSIP on PyTorch and CUDA: constrained nonlinear least squares for
NVIDIA GPUs.

The Lindström–Wedin ENLSIP method (active-set Gauss–Newton with
null-space QR subproblem solves, subspace-minimization and Newton
fallbacks, and a penalty-weighted merit-function line search) with the
capabilities of the Julia reference UncertainLab/Enlsip.jl.  This
package is the counterpart of the JAX package ``enlsip_tpu`` module by
module; it imports ``torch`` and nothing of JAX.

Entry points — ``solve(CnlsModel)``, ``core_solve``, and in
``enlsip_tpu_torch.parallel`` the batched ``solve_batched`` /
``solve_multistart`` (B same-shaped instances in lockstep) — run on the
CUDA device unless the caller passes
``device="cpu"``; with no device and no such argument they raise.  The
multi-device solves in ``enlsip_tpu_torch.parallel``
(``solve_batched_sharded``, ``solve_rowsharded``) run one process a rank
on ``torch.distributed`` and take the rank's device from their mesh.

A single solve whose residual Jacobian is tall (rows >= 32 n and rows >=
4096) takes the two-stage factorizations of ``ops/tsqr.py`` and the
fused WY kernels of ``ops/wy_hopper.py``: ``Options.tall_qr`` picks
CholeskyQR ("cholqr", default) or a Householder first stage ("qr"), and
``Functions`` takes three optional hooks for residuals of the form
phi(W x): ``res_trial`` (line-search trials along a ray in O(m)) and
``jac_rowscale`` / ``jac_base`` (the Jacobian as diag(s) @ base, never
materialized).  ``problems/giant_m.py`` holds the benchmark's problem.
"""

from .core.driver import Functions, SolveResult, solve as core_solve
from .core.types import Dims, Options, Tols
from .models.model import (CnlsModel, ExecutionInfo,
                           bounds_constraints_values, constraints_values,
                           convert_exit_code, dict_status_codes,
                           equality_constraints_values,
                           inequality_constraints_values,
                           nb_equality_constraints, nb_inequality_constraints,
                           nb_lower_bounds, nb_upper_bounds, print_cnls_model,
                           solution, solve, status, sum_sq_residuals,
                           total_nb_constraints)

__version__ = "0.1.0"

__all__ = [
    "CnlsModel", "ExecutionInfo", "solve", "status", "solution",
    "sum_sq_residuals", "constraints_values", "equality_constraints_values",
    "inequality_constraints_values", "bounds_constraints_values",
    "total_nb_constraints", "nb_equality_constraints",
    "nb_inequality_constraints", "nb_lower_bounds", "nb_upper_bounds",
    "print_cnls_model", "dict_status_codes", "convert_exit_code",
    "Dims", "Options", "Tols", "Functions", "SolveResult", "core_solve",
    "__version__",
]
