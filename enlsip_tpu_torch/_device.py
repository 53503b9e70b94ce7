"""Device resolution and host read-back accounting for the port.

Every entry point runs on the card unless the caller asks for the CPU;
nothing moves to the CPU by itself.  Host branches read scalars back
from the device through :func:`to_host`, which counts them.
"""

from __future__ import annotations

import torch


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


def to_host(v):
    """Read one scalar back for a host-side branch (counted; on a CUDA
    tensor this waits for the device)."""
    if isinstance(v, torch.Tensor):
        _Readbacks.count += 1
        return v.item()
    return v


def to_host_list(v) -> list:
    """Read a small tensor back as a list in one transfer (counted once)."""
    _Readbacks.count += 1
    return v.tolist()


def readback_count() -> int:
    return _Readbacks.count


def reset_readback_count() -> None:
    _Readbacks.count = 0
