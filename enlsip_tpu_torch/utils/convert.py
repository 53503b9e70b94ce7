"""Carry solver state between the JAX reference package and this one.

The solver has no learned weights: what has to cross between the two
packages is its *state* (factorizations, working-set data, the loop
carry), so that both sides can compute from the same inputs.  The
reference side hands a structure over as a nested dict of numpy arrays
keyed by field name, with the structure's class name under ``"_type"``
(a field that is ``None`` on the reference side, such as the optional
members of a ``CholQRF`` or the ``axis`` of a ``TSQRF``, stays ``None``;
an elided ``JQ1`` is its (0, n) placeholder array);
:func:`from_reference` rebuilds the port's structure on a device and
:func:`to_numpy` goes back.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.direction import AnalysResult
from ..core.driver import WorkingSetRound, WSRound1
from ..core.linesearch import SteplengthResult
from ..core.subproblem import (ActiveConstraint, FactorA, FactorJ2, FactorL11,
                               GNResult)
from ..core.types import Carry, Counters, PrevIter, Tols, WorkingView
from ..ops.blocked_qr import CPQRF
from ..ops.qr import CPQR
from ..ops.tsqr import TSQRF, CholQRF
from ..parallel.batch import BatchResult

STRUCTURES = {cls.__name__: cls for cls in (
    CPQR, CPQRF, CholQRF, TSQRF, ActiveConstraint, FactorA, FactorL11, FactorJ2, GNResult,
    PrevIter, Carry, Tols, Counters, WorkingView, WorkingSetRound, WSRound1,
    AnalysResult, SteplengthResult, BatchResult)}

# Fields the port keeps as host values (Python int / bool) where the
# reference keeps 0-d arrays.  In a batched structure (a leading lane
# axis on every field) they stay per-lane tensors on both sides.
HOST_FIELDS = {
    "WorkingSetRound": {"deleted"},
    "SteplengthResult": {"updated_progress"},
}


def _leaf(v, device, dtype):
    a = np.asarray(v)
    if a.dtype.kind == "f":
        return torch.tensor(a, dtype=dtype, device=device)
    if a.dtype.kind in "iu":
        return torch.tensor(a, dtype=torch.int64, device=device)
    if a.dtype.kind == "b":
        return torch.tensor(a, dtype=torch.bool, device=device)
    raise TypeError(f"cannot convert array of dtype {a.dtype}")


def from_reference(tree, device, dtype):
    """Nested dicts of numpy arrays -> the port's structures on
    ``device`` (floats as ``dtype``, integers as int64, masks as bool)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        name = tree.get("_type")
        fields = {k: v for k, v in tree.items() if k != "_type"}
        if name is None:
            return {k: from_reference(v, device, dtype)
                    for k, v in fields.items()}
        cls = STRUCTURES[name]
        host = HOST_FIELDS.get(name, ())
        out = {}
        for k in cls._fields:
            if k not in fields:
                continue        # a field the port does not carry
            v = fields[k]
            out[k] = (np.asarray(v).item()
                      if k in host and np.ndim(v) == 0
                      else from_reference(v, device, dtype))
        return cls(**out)
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_reference(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)


def to_numpy(obj):
    """The port's structures -> nested dicts of numpy arrays (the
    inverse of :func:`from_reference`)."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        out = {"_type": type(obj).__name__}
        out.update({k: to_numpy(getattr(obj, k)) for k in obj._fields})
        return out
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return np.asarray(obj)
