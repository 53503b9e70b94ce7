"""Numerical-health guards.

Counterpart of ``enlsip_tpu/utils/debug.py``.  The JAX package checks
every evaluation of the user's functions with ``checkify``; here a
guarded function checks its output on the host and raises
``FloatingPointError`` naming the function ("residuals",
"jac_residuals", "constraints", "jac_constraints") at the first
non-finite value.  Use it while developing a model and drop it for
production runs: in an eager loop each check reads a flag back from the
device; in a device-resident solve (a captured graph) the checks set
device flags that are read back once after the replay
(``_graph.guard``), and the first function whose flag is set is named.

Where the check sits.  Under ``torch.func`` transforms (the batch's
``vmap`` over lanes, the Newton direction's Hessians) a Python ``if`` on
a mapped tensor is refused.  So the check is made beneath the
transforms: it unwraps the output to the plain tensor that carries its
values (a mapped output to its (B, ...) values, a differentiated one to
its primal) and tests that on the host.  Nothing branches on a mapped
tensor, and the solver's code knows nothing of the guard.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import _graph
from ..core.driver import Functions


def _values(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor beneath every torch.func wrapper of ``t``."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


class _Guarded:
    """``fn`` with a finite-value check of its output (see the module
    docstring for where the check sits)."""

    def __init__(self, fn: Callable, name: str):
        self.fn, self.name = fn, name

    def __call__(self, *args):
        out = self.fn(*args)
        bad = ~torch.all(torch.isfinite(_values(out)))
        if _graph.device_resident():
            _graph.guard(self.name, bad)
        elif bool(bad):
            raise FloatingPointError(f"non-finite values from {self.name}(x)")
        return out


def guarded_functions(fns: Functions) -> Functions:
    """Wrap a Functions bundle with finite-value checks; a solve (single
    or batched) with the result raises ``FloatingPointError`` naming the
    first function that returned a non-finite value.  ``res_trial`` and
    the factored-Jacobian hooks pass through unguarded, as in the JAX
    package."""
    return fns._replace(res=_Guarded(fns.res, "residuals"),
                        jac_res=_Guarded(fns.jac_res, "jac_residuals"),
                        cons=_Guarded(fns.cons, "constraints"),
                        jac_cons=_Guarded(fns.jac_cons, "jac_constraints"))


def first_nonfinite_report(model) -> str | None:
    """Host-side sanity check of a solved model: returns a description
    of any non-finite piece of the solution state, else None."""
    s = np.asarray(model.sol)
    if not np.all(np.isfinite(s)):
        return ("solution contains non-finite entries at "
                f"{np.where(~np.isfinite(s))[0]}")
    if not np.isfinite(model.obj_value):
        return "objective value is non-finite"
    return None
