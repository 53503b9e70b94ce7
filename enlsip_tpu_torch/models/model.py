"""User-facing CNLS model API.

Counterpart of ``enlsip_tpu/models/model.py``.  Mirrors the reference's
modeling layer: a ``CnlsModel`` container, bound-constraint synthesis
into general inequalities, constraint stacking in the order
[eq; ineq; x - lb; ub - x], the ``solve!`` tolerance mapping and the
status-code lattice.

User callables take and return torch tensors.  Jacobians default to
``torch.func.jacfwd`` of the user closure (the reference uses
ForwardDiff.jacobian); users may supply any block explicitly and the
remaining blocks are filled with AD.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.driver import Functions, solve as core_solve
from ..core.types import Dims, Options, Tols
from ..utils.profiling import span

# Status codes: convert_exit_code + dict_status_codes
dict_status_codes = {
    0: "unsolved",
    1: "found_first_order_stationary_point",
    -1: "failed",
    -2: "maximum_iterations_exceeded",
    -11: "time_limit_exceeded",
}


def convert_exit_code(code: int) -> int:
    if code > 0:
        return 1
    if code in (-2, -11):
        return code
    return -1


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass
class ExecutionInfo:
    """Post-solve report."""

    iterations_detail: np.ndarray  # (k, 5): objective, ||act cx||^2, ||p||, alpha, reduction
    nb_function_evaluations: int = 0
    nb_jacobian_evaluations: int = 0
    solving_time: float = 0.0


@dataclasses.dataclass
class CnlsModel:
    """Constrained nonlinear least-squares model.

    min_x ||r(x)||^2  s.t.  eq(x) = 0, ineq(x) >= 0, x_low <= x <= x_upp

    The callables map a 1-d torch tensor to a torch tensor.
    """

    residuals: Callable
    nb_parameters: int
    nb_residuals: int
    starting_point: Optional[np.ndarray] = None
    jacobian_residuals: Optional[Callable] = None
    eq_constraints: Optional[Callable] = None
    jacobian_eqcons: Optional[Callable] = None
    nb_eqcons: int = 0
    ineq_constraints: Optional[Callable] = None
    jacobian_ineqcons: Optional[Callable] = None
    nb_ineqcons: int = 0
    x_low: Optional[np.ndarray] = None
    x_upp: Optional[np.ndarray] = None
    constraints_scaling: bool = False
    status_code: int = 0
    sol: Optional[np.ndarray] = None
    obj_value: float = 0.0
    model_info: Optional[ExecutionInfo] = None

    def __post_init__(self):
        n = self.nb_parameters
        if not callable(self.residuals):
            raise ValueError("A function evaluating residuals must be provided")
        if n <= 0 or self.nb_residuals <= 0:
            raise ValueError("The number of parameters and number of "
                             "residuals must be strictly positive")
        if self.starting_point is None:
            self.starting_point = np.zeros(n)
        self.starting_point = np.asarray(_np(self.starting_point), dtype=float)
        self.x_low = (np.full(n, -np.inf) if self.x_low is None
                      else np.asarray(_np(self.x_low), dtype=float))
        self.x_upp = (np.full(n, np.inf) if self.x_upp is None
                      else np.asarray(_np(self.x_upp), dtype=float))
        has_any = (self.eq_constraints is not None
                   or self.ineq_constraints is not None
                   or np.any(np.isfinite(self.x_low))
                   or np.any(np.isfinite(self.x_upp)))
        if not has_any:
            raise ValueError("There must be at least one constraint")
        if (self.eq_constraints is None) != (self.nb_eqcons == 0):
            raise ValueError("Incoherent definition of equality constraints")
        if (self.ineq_constraints is None) != (self.nb_ineqcons == 0):
            raise ValueError("Incoherent definition of inequality constraints")
        # (the model is built on the host; only ``solve`` touches the card)
        rx0 = _np(self.residuals(torch.as_tensor(self.starting_point)))
        self.obj_value = float(np.dot(rx0, rx0))
        if self.sol is None:
            self.sol = self.starting_point.copy()


# ------------------------------------------------------------ accessors

def status(model: CnlsModel) -> str:
    return dict_status_codes[model.status_code]


def solution(model: CnlsModel) -> np.ndarray:
    return model.sol


def sum_sq_residuals(model: CnlsModel) -> float:
    return model.obj_value


def nb_equality_constraints(model: CnlsModel) -> int:
    return model.nb_eqcons


def nb_inequality_constraints(model: CnlsModel) -> int:
    return model.nb_ineqcons


def nb_lower_bounds(model: CnlsModel) -> int:
    return int(np.sum(np.isfinite(model.x_low)))


def nb_upper_bounds(model: CnlsModel) -> int:
    return int(np.sum(np.isfinite(model.x_upp)))


def total_nb_constraints(model: CnlsModel) -> int:
    return (nb_equality_constraints(model) + nb_inequality_constraints(model)
            + nb_lower_bounds(model) + nb_upper_bounds(model))


def equality_constraints_values(model: CnlsModel) -> np.ndarray:
    if model.eq_constraints is None:
        return np.zeros(0)
    return _np(model.eq_constraints(torch.as_tensor(solution(model))))


def inequality_constraints_values(model: CnlsModel) -> np.ndarray:
    if model.ineq_constraints is None:
        return np.zeros(0)
    return _np(model.ineq_constraints(torch.as_tensor(solution(model))))


def bounds_constraints_values(model: CnlsModel) -> np.ndarray:
    """[x - x_low ; x_upp - x] (full vectors, including infinite
    entries, like the reference)."""
    s = solution(model)
    return np.concatenate([s - model.x_low, model.x_upp - s])


def constraints_values(model: CnlsModel) -> np.ndarray:
    """[eq; ineq; bounds] at the solution.  Bounds entries are
    restricted to the finite ones."""
    s = solution(model)
    parts = [equality_constraints_values(model),
             inequality_constraints_values(model)]
    lowf = np.isfinite(model.x_low)
    uppf = np.isfinite(model.x_upp)
    if lowf.any() or uppf.any():
        parts.append((s - model.x_low)[lowf])
        parts.append((model.x_upp - s)[uppf])
    return np.concatenate(parts)


# ------------------------------------------------- constraint synthesis

def _ad_jac(fn: Callable) -> Callable:
    return torch.func.jacfwd(fn)


def _model_functions(model: CnlsModel, dtype, device):
    """Dtype-cast (res, jac_res, cons, jac_cons) closures for a model on
    ``device``."""
    def _cast(fn):
        return lambda x: torch.as_tensor(fn(x)).to(device=x.device,
                                                   dtype=dtype)

    cons0, jac_cons0 = build_constraint_functions(model, device)
    return (_cast(model.residuals),
            _cast(model.jacobian_residuals or _ad_jac(model.residuals)),
            _cast(cons0), _cast(jac_cons0))


_FNS_CACHE: "collections.OrderedDict" = collections.OrderedDict()


def _solve_functions(model: CnlsModel, dtype, device) -> Functions:
    """The model's :class:`Functions`, one object per distinct model
    definition (callables, sizes, bounds), dtype and device, so that
    solving models built from the same definition reuses one captured
    solve graph (the graph cache is keyed by the closures)."""
    key = (model.residuals, model.jacobian_residuals, model.eq_constraints,
           model.jacobian_eqcons, model.ineq_constraints,
           model.jacobian_ineqcons, model.nb_parameters, model.nb_residuals,
           model.nb_eqcons, model.nb_ineqcons, model.x_low.tobytes(),
           model.x_upp.tobytes(), dtype, torch.device(device))
    fns = _FNS_CACHE.get(key)
    if fns is None:
        fns = _FNS_CACHE[key] = Functions(*_model_functions(model, dtype,
                                                            device))
        while len(_FNS_CACHE) > 32:
            _FNS_CACHE.popitem(last=False)
    return fns


def build_constraint_functions(model: CnlsModel, device="cpu"):
    """Concatenate eq || ineq || bounds into single (cons, jac_cons)
    closures, stacking order [eq; ineq; x-lb; ub-x].  Bound rows are
    static +-I slices."""
    n = model.nb_parameters
    low_idx = torch.as_tensor(np.nonzero(np.isfinite(model.x_low))[0],
                              device=device)
    upp_idx = torch.as_tensor(np.nonzero(np.isfinite(model.x_upp))[0],
                              device=device)
    # the bounds in each solve dtype: a float64 bound in a float32
    # closure would make its second derivatives mix the two types
    xl, xu = ({dt: torch.as_tensor(v, dtype=dt, device=device)
               for dt in (torch.float32, torch.float64)}
              for v in (model.x_low, model.x_upp))
    eye = torch.eye(n, dtype=torch.float64, device=device)

    blocks_val = []
    blocks_jac = []
    if model.eq_constraints is not None:
        blocks_val.append(model.eq_constraints)
        blocks_jac.append(model.jacobian_eqcons
                          or _ad_jac(model.eq_constraints))
    if model.ineq_constraints is not None:
        blocks_val.append(model.ineq_constraints)
        blocks_jac.append(model.jacobian_ineqcons
                          or _ad_jac(model.ineq_constraints))
    if low_idx.shape[0] > 0:
        blocks_val.append(lambda x: (x - xl[x.dtype])[low_idx])
        blocks_jac.append(lambda x: eye[low_idx])
    if upp_idx.shape[0] > 0:
        blocks_val.append(lambda x: (xu[x.dtype] - x)[upp_idx])
        blocks_jac.append(lambda x: -eye[upp_idx])

    def cons(x):
        return torch.cat([torch.atleast_1d(f(x)).to(x.dtype)
                          for f in blocks_val])

    def jac_cons(x):
        return torch.cat([torch.atleast_2d(g(x)).to(x.dtype)
                          for g in blocks_jac])

    return cons, jac_cons


# ---------------------------------------------------------------- solve

def solve(model: CnlsModel, *, silent: bool = True, max_iter: int = 100,
          scaling: bool = False, time_limit: Optional[float] = None,
          abs_tol: Optional[float] = None, rel_tol: Optional[float] = None,
          c_tol: Optional[float] = None, x_tol: Optional[float] = None,
          dtype=torch.float64, device=None, weight_code: int = 2,
          second_derivatives: bool = True,
          matmul_precision: Optional[str] = "float32") -> CnlsModel:
    """solve!.

    Tolerance mapping is the reference's exactly: ``abs_tol`` defaults
    to eps(T) and only seeds ``rel_tol = sqrt(abs_tol)``; c_tol and
    x_tol default to rel_tol; eps_rank = sqrt(eps(T)); and the internal
    epsilon-absolute stays at the enlsip default 1e-10 regardless of
    ``abs_tol`` (solve! never forwards it).

    ``device``: where the solve runs; ``None`` (default) is the CUDA
    device, and the call raises if there is none — pass ``"cpu"`` to run
    on the host.  ``dtype``: ``torch.float64`` (default) or
    ``torch.float32``.

    ``time_limit``: wall-clock budget in seconds; ``None`` (default) is
    unlimited (the solve is then one replay of a captured graph on the
    card).  A finite limit is checked between chunks of iterations
    (``core.driver.solve``).  The model's callables must be capture-safe
    (tensor code only: no tensor made from host data at a call, no
    read-back), as the JAX package requires jittable closures.

    ``matmul_precision``: precision of float32 matrix products for this
    solve ("float32" = full precision, the default; "tensorfloat32" /
    "bfloat16" = faster tensor-core passes with fewer digits; None =
    inherit the process setting).
    """
    with span("api.solve"):
        _solve_model(model, max_iter, scaling, time_limit, abs_tol, rel_tol,
                     c_tol, x_tol, dtype, device, weight_code,
                     second_derivatives, matmul_precision)
    if not silent:
        print_cnls_model(model)
    return model


def _solve_model(model: CnlsModel, max_iter, scaling, time_limit, abs_tol,
                 rel_tol, c_tol, x_tol, dtype, device, weight_code,
                 second_derivatives, matmul_precision) -> None:
    with span("prepare"):
        dev = resolve_device(device)
        eps = float(torch.finfo(dtype).eps)
        abs_tol = eps if abs_tol is None else abs_tol
        rel_tol = float(np.sqrt(abs_tol)) if rel_tol is None else rel_tol
        c_tol = rel_tol if c_tol is None else c_tol
        x_tol = rel_tol if x_tol is None else x_tol
        eps_abs_internal = 1e-10

        model.constraints_scaling = scaling
        fns = _solve_functions(model, dtype, dev)

        n, m, q = model.nb_parameters, model.nb_residuals, model.nb_eqcons
        l = total_nb_constraints(model)
        dims = Dims(n=n, m=m, q=q, l=l)
        # Second derivatives force-disabled for n + m >= 1000, as in the
        # reference.
        second_derivatives = second_derivatives and (n + m < 1000)
        opts = Options(scaling=scaling, second_derivatives=second_derivatives,
                       weight_code=weight_code, max_iter=max_iter,
                       matmul_precision=matmul_precision)
        tols = Tols(*(torch.tensor(v, dtype=dtype, device=dev)
                      for v in (eps_abs_internal, rel_tol, x_tol, c_tol,
                                np.sqrt(eps))))
    result = core_solve(fns, model.starting_point, dims, opts, tols,
                        time_limit=time_limit, dtype=dtype, device=dev)

    with span("result"):
        model.status_code = convert_exit_code(result.exit_code)
        model.sol = _np(result.x)
        model.obj_value = float(result.f)
        c = result.counters
        model.model_info = ExecutionInfo(
            iterations_detail=_np(result.display)[:result.n_display],
            nb_function_evaluations=c.nb_res + c.nb_cons,
            nb_jacobian_evaluations=c.nb_jacres + c.nb_jaccons,
            solving_time=result.solving_time)


# ------------------------------------------------------------- printing

def _print_header(model: CnlsModel, out) -> None:
    out.write("\n" + "*" * 64 + "\n")
    out.write("*" + " " * 19 + "ENLSIP (PyTorch / CUDA)" + " " * 20 + "*\n")
    out.write("* Constrained nonlinear least squares solver for NVIDIA GPUs  *\n")
    out.write("* implementing the Lindstrom-Wedin ENLSIP method.             *\n")
    out.write("*" * 64 + "\n\n")
    out.write("Characteristics of the model\n\n")
    out.write(f"Number of parameters.................: {model.nb_parameters:5d}\n")
    out.write(f"Number of residuals..................: {model.nb_residuals:5d}\n")
    out.write(f"Number of equality constraints.......: {model.nb_eqcons:5d}\n")
    out.write(f"Number of inequality constraints.....: {model.nb_ineqcons:5d}\n")
    out.write(f"Number of lower bounds...............: {nb_lower_bounds(model):5d}\n")
    out.write(f"Number of upper bounds...............: {nb_upper_bounds(model):5d}\n")
    out.write(f"Constraints internal scaling.........: {model.constraints_scaling}\n\n")


def print_cnls_model(model: CnlsModel, out=None) -> None:
    """print_cnls_model."""
    import sys
    out = out or sys.stdout
    _print_header(model, out)
    if status(model) == "unsolved":
        out.write("Model has been initialized.\n\n"
                  "Method solve can be called to execute ENLSIP.\n")
        return
    info = model.model_info
    out.write("\nIteration steps information\n\n")
    out.write("iter    objective   ||active_constraints||^2  ||p||       "
              "alpha     reduction\n")
    for k, row in enumerate(info.iterations_detail):
        out.write(f"{k + 1:4d}  {row[0]:.7e}       {row[1]:.2e}         "
                  f"{row[2]:.2e}  {row[3]:.2e}  {row[4]:.3e}\n")
    out.write(f"\nNumber of iterations...................: "
              f"{len(info.iterations_detail):4d}\n")
    out.write(f"\nSquare sum of residuals................: "
              f"{sum_sq_residuals(model):.7e}\n")
    out.write(f"\nNumber of function evaluations.........: "
              f"{info.nb_function_evaluations:4d}\n")
    out.write(f"Number of Jacobian matrix evaluations..: "
              f"{info.nb_jacobian_evaluations:4d}\n")
    out.write(f"\nSolving time (seconds).................: "
              f"{info.solving_time:.3f}\n")
    out.write(f"Termination status.....................: {status(model)}\n\n")
