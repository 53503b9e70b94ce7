"""Device resolution and host read-back accounting for the port.

Every entry point runs on the card unless the caller asks for the CPU;
nothing moves to the CPU by itself.  Host branches read scalars back
from the device through :func:`to_host`, which counts them.

:func:`forbid_readbacks` is the scope of a device-resident solve (a CUDA
graph being captured, or its CPU rehearsal): inside it :func:`to_host`
and :func:`to_host_list` raise, and so does every tensor operation that
would wait for the device or copy host data to it (``.item()``,
``int(t)``, ``bool(t)``, ``nonzero``, boolean-mask indexing, a tensor
built from Python or numpy data).  The control-flow helpers of
``_lanes`` read their flags through :func:`flag_value` instead, which is
what a conditional node does on the card.
"""

from __future__ import annotations

import contextlib
import threading
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for and
    there is none; never substitutes the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "enlsip_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run on the host")
    return dev


class _Readbacks:
    """Count of device -> host scalar reads taken by host branches."""

    count = 0


class _Scope(threading.local):
    forbidden = 0       # nesting depth of forbid_readbacks
    allowed = 0         # nesting depth of _allow (flag reads, CPU plain code)


_scope = _Scope()


class ReadbackError(RuntimeError):
    """A read-back (or a host-data upload) inside a device-resident solve."""


def to_host(v):
    """Read one scalar back for a host-side branch (counted; on a CUDA
    tensor this waits for the device)."""
    if isinstance(v, torch.Tensor):
        _check_allowed("to_host")
        _Readbacks.count += 1
        return v.item()
    return v


def to_host_list(v) -> list:
    """Read a small tensor back as a list in one transfer (counted once)."""
    _check_allowed("to_host_list")
    _Readbacks.count += 1
    return v.tolist()


def readback_count() -> int:
    return _Readbacks.count


def reset_readback_count() -> None:
    _Readbacks.count = 0


def _check_allowed(what: str) -> None:
    if _scope.forbidden and not _scope.allowed:
        raise ReadbackError(
            f"{what} inside a device-resident solve: the body must take "
            f"its branches through enlsip_tpu_torch._lanes")


@contextlib.contextmanager
def _allow():
    _scope.allowed += 1
    try:
        yield
    finally:
        _scope.allowed -= 1


def flag_value(v) -> bool:
    """The value of a 0-d flag as a conditional node reads it: on a CPU
    rehearsal a direct, uncounted read.  Raises on a CUDA tensor (a
    captured body never reads its flags on the host)."""
    if not isinstance(v, torch.Tensor):
        return bool(v)
    if v.is_cuda:
        raise ReadbackError("a device flag cannot be read on the host while "
                            "the solve is device-resident")
    with _allow():
        return bool(v)


def cpu_int(v) -> int:
    """A Python int of ``v`` (an int, or a tensor on the CPU).  Plain
    versions of the kernels bound their loops with it on the CPU; a CUDA
    tensor raises (the card's code takes the count from device memory)."""
    if not isinstance(v, torch.Tensor):
        return int(v)
    if v.device.type != "cpu":
        raise ReadbackError("cpu_int takes an int or a CPU tensor, got a "
                            f"tensor on {v.device}")
    with _allow():
        return int(v)


# Operations that wait for the device or copy host data onto it.
_FORBIDDEN_OPS = {
    "aten::_local_scalar_dense": "reads a scalar back (.item(), int(), "
                                 "bool(), float() of a tensor)",
    "aten::nonzero": "has a data-dependent shape",
    "aten::masked_select": "has a data-dependent shape",
    "aten::unique_consecutive": "has a data-dependent shape",
    "aten::_unique2": "has a data-dependent shape",
    "aten::lift_fresh": "builds a tensor from host data (torch.tensor / "
                        "torch.as_tensor of a list or a numpy array)",
}


_INDEX_PUTS = {"aten::index_put_", "aten::index_put", "aten::_index_put_impl_"}


class _ForbidMode(TorchDispatchMode):
    """``strict`` (a CPU rehearsal): every listed operation raises, as its
    tensors stand in for the card's.  Otherwise (a capture on the card)
    only those on CUDA tensors do: a library's own bookkeeping on CPU
    tensors is harmless there, and a copy of host data to the card fails
    the capture by itself."""

    def __init__(self, strict: bool):
        super().__init__()
        self.strict = strict
        self.scalars = weakref.WeakSet()     # Python numbers made tensors

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _scope.allowed:
            return func(*args, **(kwargs or {}))
        name = func._schema.name
        on_card = any(isinstance(a, torch.Tensor) and a.is_cuda
                      for a in pytree.tree_leaves((args, kwargs)))
        if name == "aten::lift_fresh" and args[0].ndim == 0:
            # a Python number as a tensor: harmless unless a write copies
            # it to the card (below; a slice's fill takes it by value)
            out = func(*args, **(kwargs or {}))
            self.scalars.add(out)
            return out
        if (name in _INDEX_PUTS and len(args) > 2 and args[2] in self.scalars
                or name == "aten::copy_" and args[1] in self.scalars):
            raise ReadbackError(
                "a Python number written into one element or through "
                "advanced indexing (x[i, j] = 1.0, x[idx] = 1.0) is a copy "
                "of host data on the card; fill a slice or write a tensor")
        why = _FORBIDDEN_OPS.get(name)
        if name == "aten::index" and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                             torch.uint8)
                for i in args[1]):
            why = "indexes with a boolean mask (a data-dependent shape)"
        if why is not None and (self.strict or on_card):
            raise ReadbackError(f"{name} inside a device-resident solve: it "
                                f"{why}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def forbid_readbacks(strict: bool = True):
    """Scope in which nothing reads back from the device: see the module
    docstring.  ``strict=False`` is the form of a capture on the card
    (only operations on CUDA tensors are held)."""
    _scope.forbidden += 1
    try:
        with _ForbidMode(strict):
            yield
    finally:
        _scope.forbidden -= 1
