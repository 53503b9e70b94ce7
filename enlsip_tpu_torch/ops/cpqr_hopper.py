"""Fused column-pivoted QR on an NVIDIA Hopper card: the wrapper of
``csrc/cpqr.cu``.

Replaces the TPU kernel ``enlsip_tpu/ops/pallas_qr2.py::_kernel`` (and
its wrapper ``cpqr_pallas2_packed``).  The work is a sequential chain of
Householder steps, each streaming the trailing block about three times
at half a flop a byte, so the kernel is bound by bytes and by the
per-step dependency across the matrix; the source note in
``csrc/cpqr.cu`` says what its design does about both.

Beside the kernel:

* its plain PyTorch version, :func:`cpqr_packed_plain` (the rank-1
  loop of ``ops/blocked_qr.py``), which :func:`cpqr_hopper` takes ONLY
  for a tensor that lies on the CPU.  For a CUDA tensor it launches the
  kernel or raises;
* ``cpqr_hopper.launches``, a plain integer counting kernel launches
  (one per factorization sent to the card).
"""

from __future__ import annotations

import ctypes

import torch

from .blocked_qr import cpqr_packed_plain, panel_width

_CTYPES = {torch.float32: "cpqr_f32", torch.float64: "cpqr_f64"}


def _library():
    from ._build import load_library
    lib = load_library("cpqr")
    if not getattr(lib, "_enlsip_bound", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        for fn in _CTYPES.values():
            getattr(lib, fn).argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, ptr]
            getattr(lib, fn).restype = i
        lib.cpqr_error_string.argtypes = [i]
        lib.cpqr_error_string.restype = ctypes.c_char_p
        lib.cpqr_scratch_entries.argtypes = [i]
        lib.cpqr_scratch_entries.restype = i
        lib._enlsip_bound = True
    return lib


def cpqr_hopper(M: torch.Tensor, nsteps: int):
    """Packed CPQR of ``M`` (rows, cols) with ``nsteps`` Householder
    steps (host int, clamped to min(rows, cols)).

    Returns ``(Bt, tau, perm)``: ``Bt`` (cols, rows) packed as
    :func:`cpqr_packed_plain` describes, ``tau`` (kp,), ``perm`` (cols,)
    int64.  ``M`` itself is not modified."""
    if M.ndim != 2 or M.shape[0] == 0 or M.shape[1] == 0:
        raise ValueError(f"cpqr_hopper takes a non-empty matrix, got shape "
                         f"{tuple(M.shape)}")
    if M.dtype not in _CTYPES:
        raise TypeError(f"cpqr_hopper takes float32 or float64, got {M.dtype}")
    rows, cols = M.shape
    nsteps = max(0, min(int(nsteps), rows, cols))
    if M.device.type == "cpu":
        return cpqr_packed_plain(M, nsteps)
    if M.device.type != "cuda":
        raise ValueError(f"cpqr_hopper takes a CPU or CUDA tensor, got "
                         f"{M.device}")
    if not M.is_contiguous():
        raise ValueError("cpqr_hopper takes a contiguous matrix")
    if rows * cols >= 2 ** 31:
        raise ValueError("cpqr_hopper indexes rows and columns with int32")

    lib = _library()
    _, kp = panel_width(min(rows, cols))
    with torch.cuda.device(M.device):
        # a fresh buffer: the kernel works in place on it
        Bt = M.t().clone(memory_format=torch.contiguous_format)
        tau = torch.zeros(kp, dtype=M.dtype, device=M.device)
        perm = torch.arange(cols, dtype=torch.int32, device=M.device)
        # Scratch freed on return is safe: the caching allocator hands a
        # block back only to work queued later on this same stream.
        nscratch = lib.cpqr_scratch_entries(cols)
        pval = torch.empty(nscratch, dtype=M.dtype, device=M.device)
        pidx = torch.empty(nscratch, dtype=torch.int32, device=M.device)
        stream = torch.cuda.current_stream().cuda_stream
        cpqr_hopper.launches += 1
        err = getattr(lib, _CTYPES[M.dtype])(
            Bt.data_ptr(), tau.data_ptr(), perm.data_ptr(), pval.data_ptr(),
            pidx.data_ptr(), rows, cols, nsteps, stream)
    if err != 0:
        raise RuntimeError(f"cpqr kernel launch failed: "
                           f"{lib.cpqr_error_string(err).decode()} ({err})")
    return Bt, tau, perm.to(torch.int64)


cpqr_hopper.launches = 0
