"""Fused compact-WY right-apply, Gram and projection on an NVIDIA Hopper
card: the wrappers of ``csrc/wy_gram.cu``.

Counterpart of ``enlsip_tpu/ops/pallas_wy.py`` and replaces its four TPU
kernels (``_wy_kernel``, ``_wy_gram_kernel``, ``_wy_gram_scale_kernel``,
``_wy_gram_scale_noout_kernel``).  The Gauss-Newton direction of a tall
problem needs, from J (m, n) and the single WY panel (V, T) of the
active-constraint factorization,

    JQ1 = J - (J V) (T V^T)       (scaled by rows where J = diag(s) base)
    G   = JQ1^T JQ1,   p = JQ1^T rx.

As separate matrix products these stream (m, n) buffers five or six
times; the kernel reads J once, keeps ``J V`` on chip, writes JQ1 once
(or not at all) and accumulates G and p on the way.  At the main shape
the function is bound by operations (see the source note in
``csrc/wy_gram.cu``).

Beside the kernel:

* the plain PyTorch versions (``*_plain``: the same arithmetic as a
  chain of matrix products), which the wrappers take ONLY for tensors
  that lie on the CPU.  For CUDA tensors they launch the kernel or
  raise;
* one launch count per entry point, plain integers:
  ``wy_right_apply.launches``, ``wy_gram_project.launches`` (no
  rowscale), ``wy_gram_project.launches_rowscale`` and
  ``wy_gram_project_noapply.launches`` (:func:`launch_counts` reads them
  all, :func:`reset_launch_counts` zeroes them).

The products inside the kernel are plain FMAs for float32 inputs (full
float32 under every ``Options.matmul_precision`` setting, the accuracy
class of ``"float32"``) and float64 tensor-core ``mma`` for float64
(``csrc/wy_gram_f64.cu``: IEEE double products and sums, the accuracy
class of the float64 chain).

Differences from the TPU wrappers, all deliberate: no row-block divisor
search and no ``rows % 8`` leg of the gate (a ragged last block is
masked in the kernel), rx and the row scale are plain (m,) vectors, the
kernel is instantiated for float64 too, and no environment variable
switches it off.  G is summed over a number of partial sums that depends
on the row count only, in a fixed order, so equal inputs give equal bits.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _graph
# dtype -> (library of csrc/, entry point); the float64 instantiations
# are a library of their own so that the two build side by side
_CTYPES = {torch.float32: ("wy_gram", "wy_gram_f32"),
           torch.float64: ("wy_gram_f64", "wy_gram_f64")}

# What the kernel's tiling takes (csrc/wy_gram.cu): n up to 128 (at most
# three 16 x 32 Gram patches a warp), a walk in 64-row units, and V, W,
# the ring of J tiles, the X tile and rx, s together within the shared
# memory one block may use on the card.
MAX_COLS = 128
ROW_BLOCK = 64
MAX_SHARED_BYTES = 232_448
# Partial Gram sums kept (= blocks launched); fixed, so the summation
# order does not depend on the card.
MAX_PARTS = 256
# (rows of a tile, tiles in the ring), in the order the float32 kernel
# tries them: two 64-row tiles so that one loads while the other computes,
# else one 32-row tile.  The dispatch gate admits a panel at both dtypes
# where the float32 layout of one of these fits (``_admitted``).
TILINGS = ((64, 2), (32, 1))
# The float64 kernel's own layout (csrc/wy_gram_f64.cu) and its tilings,
# in the order it tries them; one of them fits every admitted panel.
TILINGS_F64 = ((64, 2), (32, 2), (16, 1))

_APPLY, _GRAM, _GRAM_SCALE, _GRAM_SCALE_NOOUT = range(4)


def _pad4(x: int) -> int:
    return -(-x // 4) * 4


def _row_stride(cols: int, itemsize: int) -> int:
    """Row stride (elements) of the J tile and of W in shared memory:
    padded to four elements and skewed off a multiple of 128 bytes."""
    np_ = _pad4(cols)
    return np_ + 4 if (np_ * itemsize) % 128 == 0 else np_


def _admission_bytes(cols: int, k: int, dtype, row_block: int = 64,
                     stages: int = 2) -> int:
    """Shared memory of one block of the float32 layout, sized for the
    dtype: V (n, kp), W (k, np), ``stages`` tiles (row_block, np), X^T
    (k, row_block), and rx and s beside every tile (kp = k padded to 4, np
    the padded row stride), as ``csrc/wy_gram.cu::shared_elems`` lays it
    out.  The gate's admission rule at both dtypes."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    np_, kp = _row_stride(cols, itemsize), _pad4(k)
    return (cols * kp + k * np_ + stages * row_block * np_ + k * row_block
            + 2 * stages * row_block) * itemsize


def _shared_bytes(cols: int, k: int, dtype, row_block: int = 64,
                  stages: int = 2) -> int:
    """Shared memory of one block of the kernel of ``dtype``, as its
    source lays it out.  float32: :func:`_admission_bytes`.  float64
    (``csrc/wy_gram_f64.cu::shared_elems``): ``stages`` tiles
    (row_block, np), X (row_block, kx), -W (k8, np), V (n4, kx), and rx
    and s beside every tile, where n4 = n padded to 4, np = n4 padded to
    4 mod 8, k8 = k padded to 8 and kx = k8 + 4."""
    if dtype != torch.float64:
        return _admission_bytes(cols, k, dtype, row_block, stages)
    n4, k8 = _pad4(cols), -(-k // 8) * 8
    np_ = n4 if n4 % 8 else n4 + 4
    kx = k8 + 4
    return (stages * row_block * np_ + row_block * kx + k8 * np_ + n4 * kx
            + 2 * stages * row_block) * 8


def _admitted(cols: int, k: int, dtype) -> bool:
    """Whether the gate admits an (n, k) panel: the float32 layout, sized
    for the dtype, fits one of :data:`TILINGS`."""
    return any(_admission_bytes(cols, k, dtype, rb, stages) <= MAX_SHARED_BYTES
               for rb, stages in TILINGS)


def _tiling(cols: int, k: int, dtype):
    """The (row_block, stages) the kernel of ``dtype`` takes for an
    admitted panel: the first of its tilings that fits the card's shared
    memory; None where the gate does not admit the panel."""
    if not _admitted(cols, k, dtype):
        return None
    for rb, stages in TILINGS_F64 if dtype == torch.float64 else TILINGS:
        if _shared_bytes(cols, k, dtype, rb, stages) <= MAX_SHARED_BYTES:
            return rb, stages
    return None


def use_wy_hopper(rows: int, cols: int, k: int, dtype, device) -> bool:
    """Dispatch gate, a pure function of shape, dtype and device: tall
    (``rows >= 32 cols`` and ``rows >= 4096``) float32/float64 applies
    whose panel the kernel's tiling admits (:func:`_admitted`).

    True means "take the fused form", not "a kernel runs": the wrappers
    launch the kernel on a CUDA tensor and compute the same function with
    their plain versions on a CPU tensor.  The kernel's limits (``cols <=
    128``, the shared-memory budget) hold on the CPU too, so both devices
    split the fused form from the unfused chain at the same shapes."""
    dev = torch.device(device)
    return (dev.type in ("cuda", "cpu") and dtype in _CTYPES
            and rows >= 32 * cols and rows >= 4096
            and 1 <= cols <= MAX_COLS and 1 <= k
            and _admitted(cols, k, dtype)
            and rows < 2 ** 31 - ROW_BLOCK)


def _library(dtype=torch.float32):
    from ._build import load_library
    name, fn = _CTYPES[dtype]
    lib = load_library(name)
    if not getattr(lib, "_enlsip_bound", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        getattr(lib, fn).argtypes = [ptr] * 8 + [i] * 5 + [ptr]
        getattr(lib, fn).restype = i
        lib.wy_gram_shared_bytes.argtypes = [i] * 5
        lib.wy_gram_shared_bytes.restype = ctypes.c_longlong
        lib.wy_gram_error_string.argtypes = [i]
        lib.wy_gram_error_string.restype = ctypes.c_char_p
        lib._enlsip_bound = True
    return lib


# ------------------------------------------------------- plain versions

def _apply_plain(J, V, T, rowscale=None):
    JQ1 = J - (J @ V) @ (T @ V.transpose(-1, -2))
    return JQ1 if rowscale is None else rowscale[..., None] * JQ1


def wy_right_apply_plain(J: torch.Tensor, V: torch.Tensor,
                         T: torch.Tensor) -> torch.Tensor:
    """``J - (J V) (T V^T)`` as matrix products."""
    return _apply_plain(J, V, T)


def wy_gram_project_plain(J, V, T, rx, rowscale=None):
    """``(JQ1, JQ1^T JQ1, JQ1^T rx)`` as matrix products; with
    ``rowscale``, JQ1 = diag(rowscale) (J - (J V) (T V^T))."""
    JQ1 = _apply_plain(J, V, T, rowscale)
    Jt = JQ1.transpose(-1, -2)
    return JQ1, Jt @ JQ1, (Jt @ rx[..., None])[..., 0]


def wy_gram_project_noapply_plain(J, V, T, rx, rowscale):
    """``(JQ1^T JQ1, JQ1^T rx)`` as matrix products (JQ1 is a
    temporary)."""
    return wy_gram_project_plain(J, V, T, rx, rowscale)[1:]


# ----------------------------------------------------------- the launch

def _check(name, J, V, T, rx=None, rowscale=None):
    if J.ndim != 2 or V.ndim != 2 or T.ndim != 2:
        raise ValueError(f"{name} takes a 2-D J and one 2-D WY panel, got "
                         f"J {tuple(J.shape)}, V {tuple(V.shape)}, "
                         f"T {tuple(T.shape)}")
    rows, n = J.shape
    k = V.shape[1]
    if V.shape[0] != n or T.shape != (k, k):
        raise ValueError(f"{name}: V must be ({n}, k) and T (k, k), got "
                         f"{tuple(V.shape)} and {tuple(T.shape)}")
    for label, v in (("rx", rx), ("rowscale", rowscale)):
        if v is not None and v.shape != (rows,):
            raise ValueError(f"{name}: {label} must be ({rows},), got "
                             f"{tuple(v.shape)}")
    if J.dtype not in _CTYPES:
        raise TypeError(f"{name} takes float32 or float64, got {J.dtype}")
    for v in (V, T, rx, rowscale):
        if v is not None and (v.dtype != J.dtype or v.device != J.device):
            raise ValueError(f"{name}: every operand must have J's dtype and "
                             f"device")
    if J.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {J.device}")


def _launch(entry, count, variant, J, V, T, rx, rowscale):
    """Run variant ``variant`` of the kernel on CUDA operands for the
    entry point ``entry``, adding one to its integer attribute ``count``
    at the launch; returns ``(JQ1 or None, G or None, p or None)``.  J
    must be row-major contiguous (a copy of a tall buffer is never made
    silently); the small operands and the (m,) vectors are made
    contiguous if they are not."""
    name = entry.__name__
    rows, n, k = J.shape[0], J.shape[1], V.shape[1]
    if not use_wy_hopper(rows, n, k, J.dtype, J.device):
        raise ValueError(f"{name}: shape ({rows}, {n}), k = {k}, {J.dtype} is "
                         f"outside the kernel's gate (use_wy_hopper)")
    if not J.is_contiguous():
        raise ValueError(f"{name} takes a row-major contiguous J")
    if (n * J.element_size()) % 16 == 0 and J.data_ptr() % 16 != 0:
        # rows that are whole 16-byte chunks are copied 16 bytes at a time
        raise ValueError(f"{name} takes a J whose storage starts on a "
                         f"16-byte boundary (a sliced view does not)")
    lib = _library(J.dtype)
    with torch.cuda.device(J.device):
        Vc = V.contiguous()
        W = (T @ V.t()).contiguous()                   # (k, n)
        rxc = rx.contiguous() if rx is not None else None
        sc = rowscale.contiguous() if rowscale is not None else None
        nparts = min(MAX_PARTS, -(-rows // ROW_BLOCK))
        out = ws = gp = None
        if variant != _GRAM_SCALE_NOOUT:
            out = torch.empty_like(J)
        if variant != _APPLY:
            # Scratch freed on return is safe: the caching allocator hands
            # a block back only to work queued later on this same stream.
            ws = torch.empty((nparts, n * n + n), dtype=J.dtype,
                             device=J.device)
            gp = torch.empty(n * n + n, dtype=J.dtype, device=J.device)
        ptr = lambda t: 0 if t is None else t.data_ptr()
        stream = torch.cuda.current_stream().cuda_stream
        _graph.count_launch(entry, count)
        err = getattr(lib, _CTYPES[J.dtype][1])(
            J.data_ptr(), Vc.data_ptr(), W.data_ptr(), ptr(rxc), ptr(sc),
            ptr(out), ptr(ws), ptr(gp), rows, n, k, variant, nparts, stream)
    if err != 0:
        raise RuntimeError(f"wy_gram kernel launch failed ({name}): "
                           f"{lib.wy_gram_error_string(err).decode()} ({err})")
    if gp is None:
        return out, None, None
    return out, gp[:n * n].view(n, n), gp[n * n:]


def wy_right_apply(J: torch.Tensor, V: torch.Tensor,
                   T: torch.Tensor) -> torch.Tensor:
    """``J - ((J V) T) V^T`` in one fused pass over J (m, n) for one WY
    panel V (n, k), T (k, k).  J is not modified."""
    _check("wy_right_apply", J, V, T)
    if J.device.type == "cpu":
        return wy_right_apply_plain(J, V, T)
    return _launch(wy_right_apply, "launches", _APPLY, J, V, T, None, None)[0]


def wy_gram_project(J: torch.Tensor, V: torch.Tensor, T: torch.Tensor,
                    rx: torch.Tensor, rowscale: torch.Tensor | None = None):
    """Fused ``(JQ1, JQ1^T JQ1, JQ1^T rx)`` in one pass over J.

    Returns ``(JQ1 (m, n), G (n, n), jtrx (n,))``.  The Gram is raw
    (unmasked), exactly what ``ops.tsqr.cholqr_cpqr`` computes itself;
    dead-column masking stays on the (n, n) side.

    ``rowscale`` (factored-Jacobian mode): ``J`` is then the constant
    base matrix and the semantic Jacobian is ``diag(rowscale) @ J``; the
    scale is applied in the kernel after the WY apply, so the dense
    Jacobian never exists in device memory."""
    _check("wy_gram_project", J, V, T, rx, rowscale)
    if J.device.type == "cpu":
        return wy_gram_project_plain(J, V, T, rx, rowscale)
    if rowscale is None:
        return _launch(wy_gram_project, "launches", _GRAM, J, V, T, rx, None)
    return _launch(wy_gram_project, "launches_rowscale", _GRAM_SCALE, J, V, T,
                   rx, rowscale)


def wy_gram_project_noapply(J: torch.Tensor, V: torch.Tensor, T: torch.Tensor,
                            rx: torch.Tensor, rowscale: torch.Tensor):
    """Factored-mode Gram and projection WITHOUT materializing JQ1: one
    read of the base and nothing else of (m, n) size.  Returns
    ``(G (n, n), jtrx (n,))`` for ``JQ1 = diag(rowscale) (J Q1)``.  Only
    valid when every downstream consumer rides the Gram (the small-side
    algebra of ``j2_transform_d`` and ``second_mult_estimate``; Newton
    off)."""
    _check("wy_gram_project_noapply", J, V, T, rx, rowscale)
    if J.device.type == "cpu":
        return wy_gram_project_noapply_plain(J, V, T, rx, rowscale)
    return _launch(wy_gram_project_noapply, "launches", _GRAM_SCALE_NOOUT, J,
                   V, T, rx, rowscale)[1:]


wy_right_apply.launches = 0
wy_gram_project.launches = 0
wy_gram_project.launches_rowscale = 0
wy_gram_project_noapply.launches = 0
_graph.register_counts(wy_right_apply)
_graph.register_counts(wy_gram_project, "launches", "launches_rowscale")
_graph.register_counts(wy_gram_project_noapply)


def launch_counts() -> dict:
    """The four launch counts by kernel name, replays of captured graphs
    included (``_graph.launches``)."""
    return {"wy_right_apply": _graph.launches(wy_right_apply),
            "wy_gram_project": _graph.launches(wy_gram_project),
            "wy_gram_project_rowscale": _graph.launches(wy_gram_project,
                                                        "launches_rowscale"),
            "wy_gram_project_noapply": _graph.launches(
                wy_gram_project_noapply)}


def reset_launch_counts() -> None:
    _graph.reset_launches()
    wy_right_apply.launches = 0
    wy_gram_project.launches = 0
    wy_gram_project.launches_rowscale = 0
    wy_gram_project_noapply.launches = 0
