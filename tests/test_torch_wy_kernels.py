"""The fused WY kernels' module (ops/wy_hopper.py) on the CPU.

The CUDA kernel cannot run here; the plain PyTorch versions — which the
wrappers take only for CPU tensors — are held against the four Pallas
bodies they replace (``enlsip_tpu/ops/pallas_wy.py``), run in interpret
mode with the calls built as tests/test_pallas_wy.py builds them, and
against the matrix-product chain in numpy.  float64, tolerance 1e-10
(absolute + relative, as tests/test_pallas_wy.py holds G and jtrx).
``chip_smoke.py`` holds the kernel itself against the plain versions on
the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from enlsip_tpu.ops import blocked_qr as jbq
from enlsip_tpu.ops import pallas_wy as jwy
from enlsip_tpu_torch.ops import blocked_qr as tb
from enlsip_tpu_torch.ops import wy_hopper as wy

from torch_port_helpers import tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

TOL = dict(rtol=1e-10, atol=1e-10)
# (rows, n, k, Pallas row block): the shapes of tests/test_pallas_wy.py,
# one k = 1 and one k = n
PALLAS_SHAPES = [(2048, 60, 24, 256), (4096, 100, 50, 2048),
                 (1024, 12, 1, 128), (1024, 8, 8, 256)]


def _inputs(rows, n, k, seed):
    """J, V, T, rx, s as numpy float64: (V, T) the single WY panel of a
    pivoted QR of a random (n, k) matrix; s has entries of both signs."""
    rng = np.random.default_rng(seed)
    f = jbq.cpqr_blocked(jnp.asarray(rng.normal(size=(n, k))))
    V, T = np.asarray(f.V), np.asarray(f.T[0])
    J = rng.normal(size=(rows, n))
    rx = rng.normal(size=rows)
    s = rng.normal(size=rows) + 0.5
    return J, V, T, rx, s


def _chain(J, V, T, s=None):
    JQ1 = J - ((J @ V) @ T) @ V.T
    return JQ1 if s is None else s[:, None] * JQ1


def _pallas(kernel, J, V, T, rx=None, s=None, rb=256, out=True, gram=True):
    """One of the four Pallas bodies in interpret mode."""
    rows, n = J.shape
    k = V.shape[1]
    W = jnp.asarray(T @ V.T)
    stripe = pl.BlockSpec((8, rb), lambda i: (i // 8, 0))
    in_specs = [pl.BlockSpec((rb, n), lambda i: (i, 0)),
                pl.BlockSpec((n, k), lambda i: (0, 0)),
                pl.BlockSpec((k, n), lambda i: (0, 0))]
    args = [jnp.asarray(J), jnp.asarray(V), W]
    for v in (rx, s):
        if v is not None:
            in_specs.append(stripe)
            args.append(jnp.asarray(v).reshape(rows // rb, rb))
    out_specs, out_shape = [], []
    if out:
        out_specs.append(pl.BlockSpec((rb, n), lambda i: (i, 0)))
        out_shape.append(jax.ShapeDtypeStruct((rows, n), jnp.float64))
    if gram:
        out_specs += [pl.BlockSpec((n, n), lambda i: (0, 0)),
                      pl.BlockSpec((1, n), lambda i: (0, 0))]
        out_shape += [jax.ShapeDtypeStruct((n, n), jnp.float64),
                      jax.ShapeDtypeStruct((1, n), jnp.float64)]
    res = pl.pallas_call(kernel, grid=(rows // rb,), in_specs=in_specs,
                         out_specs=out_specs if gram else out_specs[0],
                         out_shape=out_shape if gram else out_shape[0],
                         interpret=True)(*args)
    return [np.asarray(r) for r in (res if gram else [res])]


@pytest.mark.parametrize("rows,n,k,rb", PALLAS_SHAPES)
def test_plain_versions_match_the_four_pallas_bodies(rows, n, k, rb):
    J, V, T, rx, s = _inputs(rows, n, k, seed=rows + n + k)
    tJ, tV, tT, trx, ts = (tt(a) for a in (J, V, T, rx, s))
    # B3: apply only
    (ref,) = _pallas(jwy._wy_kernel, J, V, T, rb=rb, gram=False)
    np.testing.assert_allclose(wy.wy_right_apply(tJ, tV, tT).numpy(), ref,
                               **TOL)
    # B4: apply + Gram + projection
    refs = _pallas(jwy._wy_gram_kernel, J, V, T, rx, rb=rb)
    got = wy.wy_gram_project(tJ, tV, tT, trx)
    for g, r in zip(got, (refs[0], refs[1], refs[2][0])):
        np.testing.assert_allclose(g.numpy(), r, **TOL)
    # B5: row-scaled
    refs = _pallas(jwy._wy_gram_scale_kernel, J, V, T, rx, s, rb=rb)
    got = wy.wy_gram_project(tJ, tV, tT, trx, rowscale=ts)
    for g, r in zip(got, (refs[0], refs[1], refs[2][0])):
        np.testing.assert_allclose(g.numpy(), r, **TOL)
    # B6: row-scaled, no JQ1 output
    refs = _pallas(jwy._wy_gram_scale_noout_kernel, J, V, T, rx, s, rb=rb,
                   out=False)
    got = wy.wy_gram_project_noapply(tJ, tV, tT, trx, ts)
    for g, r in zip(got, (refs[0], refs[1][0])):
        np.testing.assert_allclose(g.numpy(), r, **TOL)


@pytest.mark.parametrize("rows,n,k", [(4100, 7, 3), (8192, 16, 5),
                                      (4099, 16, 1), (4100, 9, 9)])
@pytest.mark.parametrize("scaled", [False, True])
def test_plain_versions_match_the_product_chain(rows, n, k, scaled):
    """Ragged row counts, k = 1 and k = n, rowscale of both signs,
    against ``J - ((J V) T) V^T`` in numpy."""
    J, V, T, rx, s = _inputs(rows, n, k, seed=rows + k)
    sc = s if scaled else None
    ref = _chain(J, V, T, sc)
    tJ, tV, tT, trx = (tt(a) for a in (J, V, T, rx))
    ts = tt(s) if scaled else None
    JQ1, G, p = wy.wy_gram_project(tJ, tV, tT, trx, rowscale=ts)
    np.testing.assert_allclose(JQ1.numpy(), ref, **TOL)
    np.testing.assert_allclose(G.numpy(), ref.T @ ref, **TOL)
    np.testing.assert_allclose(p.numpy(), ref.T @ rx, **TOL)
    if scaled:
        G2, p2 = wy.wy_gram_project_noapply(tJ, tV, tT, trx, ts)
        assert torch.equal(G2, G) and torch.equal(p2, p)
    else:
        assert torch.equal(wy.wy_right_apply(tJ, tV, tT), JQ1)


def test_right_q_apply_dispatches_tall_single_panel_to_the_wrapper():
    """``blocked_qr.right_q_apply``: a tall 2-D J with one panel goes
    through ``wy_right_apply`` (W-form), anything else through the
    chain; both agree to rounding."""
    rng = np.random.default_rng(3)
    f = tb.cpqr_blocked(tt(rng.normal(size=(12, 8))), device="cpu")
    J = tt(rng.normal(size=(4096, 12)))
    V0, T0 = tb._panels(f)[0]
    chain = J - ((J @ V0) @ T0) @ V0.t()
    assert torch.equal(tb.right_q_apply(f, J), wy.wy_right_apply(J, V0, T0))
    np.testing.assert_allclose(tb.right_q_apply(f, J).numpy(), chain.numpy(),
                               **TOL)
    short = J[:100]                      # not tall: the chain
    assert torch.equal(tb.right_q_apply(f, short),
                       short - ((short @ V0) @ T0) @ V0.t())


def test_dispatch_gate():
    f32, f64 = torch.float32, torch.float64
    assert wy.use_wy_hopper(5_000_000, 100, 50, f32, "cuda")
    assert wy.use_wy_hopper(5_000_000, 100, 50, f64, "cuda")
    assert wy.use_wy_hopper(2_000_000, 100, 20, f32, "cuda")
    assert wy.use_wy_hopper(5_000_001, 100, 50, f32, "cuda")   # ragged is fine
    assert wy.use_wy_hopper(4100, 7, 3, f32, "cpu")
    assert not wy.use_wy_hopper(2000, 100, 50, f32, "cuda")    # not tall
    assert not wy.use_wy_hopper(4095, 7, 3, f32, "cuda")       # under 4096 rows
    assert not wy.use_wy_hopper(8192, 300, 10, f32, "cuda")    # rows < 32 n
    assert not wy.use_wy_hopper(10 ** 6, 129, 10, f32, "cuda")  # n > 128
    assert not wy.use_wy_hopper(10 ** 6, 128, 128, f64, "cuda")  # shared memory
    assert wy.use_wy_hopper(10 ** 6, 128, 128, f32, "cuda")
    assert not wy.use_wy_hopper(10 ** 6, 100, 50, torch.float16, "cuda")


@pytest.mark.parametrize("n,k,dtype,tiling", [
    (100, 50, torch.float32, (64, 2)),      # the giant-m main shape
    (100, 50, torch.float64, (64, 2)),
    (100, 20, torch.float32, (64, 2)),
    (7, 3, torch.float32, (64, 2)),
    (128, 128, torch.float32, (32, 1)),     # no room for two 64-row tiles
    (128, 64, torch.float64, (32, 2)),      # float64: two 32-row tiles
    (128, 84, torch.float64, (16, 1)),      # the largest k admitted at n = 128
    (100, 100, torch.float64, (16, 1)),
    (128, 128, torch.float64, None),
])
def test_tiling_by_shape(n, k, dtype, tiling):
    """float32: two 64-row tiles in a ring where the panel leaves room, one
    32-row tile otherwise.  float64 (its own layout): two 64-row tiles,
    else two 32-row tiles, else one 16-row tile.  Nothing where the gate
    does not admit the panel."""
    assert wy._tiling(n, k, dtype) == tiling


def test_shared_bytes_formula():
    """V (n, kp), W (k, np), the tiles (rb, np), X^T (k, rb), rx and s
    beside every tile; kp pads k to 4, np pads n to 4 and steps off a
    multiple of 128 bytes."""
    assert wy._row_stride(100, 4) == 100 and wy._row_stride(7, 4) == 8
    assert wy._row_stride(128, 4) == 132 and wy._row_stride(96, 4) == 100
    assert wy._row_stride(100, 8) == 100 and wy._row_stride(16, 8) == 20
    assert wy._shared_bytes(100, 50, torch.float32) == \
        (100 * 52 + 50 * 100 + 2 * 64 * 100 + 50 * 64 + 4 * 64) * 4
    assert wy._admission_bytes(100, 50, torch.float64, 32, 1) == \
        (100 * 52 + 50 * 100 + 32 * 100 + 50 * 32 + 2 * 32) * 8
    assert 2 * wy._shared_bytes(100, 50, torch.float32) <= wy.MAX_SHARED_BYTES


def test_float64_shared_bytes_formula():
    """The float64 layout: the tiles (rb, np), X (rb, kx), -W (k8, np),
    V (n4, kx), rx and s beside every tile; np pads n to 4, then to 4 mod
    8; k8 pads k to 8 and kx = k8 + 4."""
    f64 = torch.float64
    assert wy._shared_bytes(100, 50, f64, 32, 1) == \
        (32 * 100 + 32 * 60 + 56 * 100 + 100 * 60 + 2 * 32) * 8
    assert wy._shared_bytes(100, 50, f64) == \
        (2 * 64 * 100 + 64 * 60 + 56 * 100 + 100 * 60 + 4 * 64) * 8
    # n = 16: n4 = 16 is 0 mod 8, so the stride steps to 20; k = 3 pads to 8
    assert wy._shared_bytes(16, 3, f64, 16, 1) == \
        (16 * 20 + 16 * 12 + 8 * 20 + 16 * 12 + 2 * 16) * 8
    assert wy._shared_bytes(100, 50, f64) <= wy.MAX_SHARED_BYTES


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gate_takes_every_panel_the_single_tile_layout_took(dtype):
    """The shapes accepted do not shrink: whatever fitted V, W, one 64-row
    J tile and the X tile unpadded, 2 n k + 64 (n + k) + 128 elements,
    still has a tiling."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    for n in range(1, wy.MAX_COLS + 1):
        for k in range(1, 2 * wy.MAX_COLS + 1):
            if (2 * n * k + 64 * (n + k) + 128) * itemsize <= wy.MAX_SHARED_BYTES:
                assert wy._tiling(n, k, dtype) is not None, (n, k)


def _frozen_admission_bytes(n, k, itemsize, rb, stages):
    """The gate's shared-memory rule as it stood before the float64 kernel
    had a layout of its own (written out here, not read from the module):
    V (n, kp), W (k, np), the tiles (rb, np), X^T (k, rb), rx and s."""
    kp = -(-k // 4) * 4
    np_ = -(-n // 4) * 4
    if (np_ * itemsize) % 128 == 0:
        np_ += 4
    return (n * kp + k * np_ + stages * rb * np_ + k * rb + 2 * stages * rb) \
        * itemsize


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gate_is_frozen(dtype):
    """``use_wy_hopper`` admits exactly the panels it admitted before the
    float64 redesign, at both dtypes: the layout of a kernel may change,
    the shapes the fused form takes (and with them the CPU's parity with
    the JAX package) may not."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    admits = lambda n, k: any(
        _frozen_admission_bytes(n, k, itemsize, rb, st) <= 232_448
        for rb, st in ((64, 2), (32, 1)))
    for n in range(1, 129):
        kmax = max(k for k in range(1, 2000) if admits(n, k))
        assert not any(admits(n, k) for k in range(kmax + 1, 2000))
        for k in sorted(set(range(1, 130)) | set(range(130, 2000, 7))
                        | {kmax, kmax + 1}):
            for device in ("cuda", "cpu"):
                assert wy.use_wy_hopper(32 * 128, n, k, dtype, device) == \
                    (k <= kmax), (n, k, dtype, device)


def test_float64_layout_fits_every_admitted_panel():
    """Wherever the gate admits a float64 panel, one of the float64
    kernel's tilings fits the card's shared memory, as the kernel sizes
    it."""
    f64 = torch.float64
    for n in range(1, wy.MAX_COLS + 1):
        for k in range(1, 1200):
            if not wy._admitted(n, k, f64):
                continue
            tiling = wy._tiling(n, k, f64)
            assert tiling in wy.TILINGS_F64, (n, k)
            assert wy._shared_bytes(n, k, f64, *tiling) <= wy.MAX_SHARED_BYTES


def test_ptxas_rows_read_registers_and_spill():
    """The ``build`` line's registers and spill come from ``nvcc -Xptxas
    -v``'s text, one row a kernel (``chip_smoke.py`` fails on a float64
    WY kernel that spills)."""
    from enlsip_tpu_torch.ops import _build
    log = """ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    72 bytes stack frame, 88 bytes spill stores, 112 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 400 bytes cmem[0]
"""
    assert _build.ptxas_rows(log) == [
        {"kernel": "_Z1av", "spill_bytes": [88, 112], "registers": 255,
         "static_shared_bytes": 16},
        {"kernel": "_Z1bv", "spill_bytes": [0, 0], "registers": 32,
         "static_shared_bytes": 0}]


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    J, V, T, rx, s = (tt(a) for a in _inputs(4100, 7, 3, seed=1))
    wy.reset_launch_counts()
    assert torch.equal(wy.wy_right_apply(J, V, T),
                       wy.wy_right_apply_plain(J, V, T))
    for a, b in zip(wy.wy_gram_project(J, V, T, rx, s),
                    wy.wy_gram_project_plain(J, V, T, rx, s)):
        assert torch.equal(a, b)
    for a, b in zip(wy.wy_gram_project_noapply(J, V, T, rx, s),
                    wy.wy_gram_project_noapply_plain(J, V, T, rx, s)):
        assert torch.equal(a, b)
    assert set(wy.launch_counts().values()) == {0}
    assert sorted(wy.launch_counts()) == [
        "wy_gram_project", "wy_gram_project_noapply",
        "wy_gram_project_rowscale", "wy_right_apply"]


@pytest.mark.parametrize("bad", ["dtype", "ndim", "panel", "rx", "mixed"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    J, V, T, rx, s = (tt(a) for a in _inputs(4100, 7, 3, seed=2))
    if bad == "dtype":
        J, V, T, rx = (a.to(torch.float16) for a in (J, V, T, rx))
    elif bad == "ndim":
        J = J[None]
    elif bad == "panel":
        V = V[:5]
    elif bad == "rx":
        rx = rx[:-1]
    else:
        V = V.to(torch.float32)
    with pytest.raises((TypeError, ValueError)):
        wy.wy_gram_project(J, V, T, rx)


# (rows, n, k) at float64: the edges of the float64 kernel's mma tiling
# (n = 7, 13, 128; k = 1, 3, n, or the largest k the gate admits at
# n = 128) and of its three tilings, rows = 1 mod 64 or 5 mod 8
EDGE_SHAPES_F64 = [(4161, 7, 1), (4101, 7, 3), (4101, 7, 7), (4101, 13, 1),
                   (4161, 13, 3), (4161, 13, 13), (8197, 128, 1),
                   (4161, 128, 3), (4161, 128, 64), (4101, 128, 84),
                   (6401, 100, 100)]


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """Needs the card and nvcc (run with ``pytest -m gpu``);
    ``chip_smoke.py`` makes the same comparison at the main path's
    shapes.  float64, 1e-11 relative; two launches give equal bits; G
    symmetric to the bit, at the float64 edge shapes too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    J, V, T, rx, s = (tt(a).cuda() for a in _inputs(4100, 7, 3, seed=0))
    wy.reset_launch_counts()
    got = wy.wy_gram_project(J, V, T, rx, s)
    again = wy.wy_gram_project(J, V, T, rx, s)
    want = wy.wy_gram_project_plain(J, V, T, rx, s)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert float((g - w).abs().max()) <= 1e-11 * float(w.abs().max())
    G, p = wy.wy_gram_project_noapply(J, V, T, rx, s)
    assert float((G - want[1]).abs().max()) <= 1e-11 * float(want[1].abs().max())
    out = wy.wy_right_apply(J, V, T)
    ref = wy.wy_right_apply_plain(J, V, T)
    assert float((out - ref).abs().max()) <= 1e-11 * float(ref.abs().max())
    assert wy.launch_counts() == {
        "wy_right_apply": 1, "wy_gram_project": 0,
        "wy_gram_project_rowscale": 2, "wy_gram_project_noapply": 1}
    with pytest.raises(ValueError, match="contiguous"):
        wy.wy_right_apply(J.t().contiguous().t(), V, T)
    # rows of whole 16-byte chunks are copied 16 bytes at a time: a view
    # whose storage starts off such a boundary is refused, not copied
    J8, V8, T8, _, _ = (tt(a).cuda() for a in _inputs(4096, 8, 3, seed=0))
    flat = torch.empty(4096 * 8 + 1, dtype=J8.dtype, device="cuda")
    off = flat[1:].view(4096, 8).copy_(J8)
    with pytest.raises(ValueError, match="16-byte"):
        wy.wy_right_apply(off, V8, T8)
    for rows, n, k in EDGE_SHAPES_F64:
        J, V, T, rx, s = (tt(a).cuda() for a in _inputs(rows, n, k, seed=n + k))
        for scale in (None, s):
            got, again = (wy.wy_gram_project(J, V, T, rx, scale)
                          for _ in range(2))
            want = wy.wy_gram_project_plain(J, V, T, rx, scale)
            assert torch.equal(got[1], got[1].T), (rows, n, k)
            for g, a, w in zip(got, again, want):
                assert torch.equal(g, a), (rows, n, k)
                assert float((g - w).abs().max()) <= \
                    1e-11 * float(w.abs().max()), (rows, n, k)
        G, p = wy.wy_gram_project_noapply(J, V, T, rx, s)
        assert torch.equal(G, G.T)
        want = wy.wy_gram_project_plain(J, V, T, rx, s)
        for g, w in ((G, want[1]), (p, want[2])):
            assert float((g - w).abs().max()) <= 1e-11 * float(w.abs().max())
        out = wy.wy_right_apply(J, V, T)
        ref = wy.wy_right_apply_plain(J, V, T)
        assert float((out - ref).abs().max()) <= 1e-11 * float(ref.abs().max())
