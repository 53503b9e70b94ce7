"""The Hopper CPQR kernel's module (ops/cpqr_hopper.py) on the CPU.

The CUDA kernel cannot run here; its plain PyTorch version — which the
wrapper takes only for a CPU tensor — is held against the Pallas kernel
it replaces, run in interpret mode, and against the JAX rank-1 loop, on
the shapes of tests/test_pallas_qr2.py plus the masked-``nsteps`` case.
Tolerance 1e-10 absolute (as tests/test_pallas_qr2.py), perm exact.
``chip_smoke.py`` holds the kernel itself (both of its routes) against
their plain versions on the card.

What the resident route does that can be tested without a card is tested
here: its gate ``fits_resident``, and the bookkeeping that replaces the
column swaps (position <-> column maps, the first maximum by CURRENT
position, candidates per block, the packed output written column by
column), as a plain PyTorch model used by these tests only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.ops.blocked_qr import _cpqr_xla, NB
from enlsip_tpu.ops.pallas_qr2 import cpqr_pallas2, cpqr_pallas2_packed
from enlsip_tpu_torch.ops import blocked_qr as tb
from enlsip_tpu_torch.ops import cpqr_hopper as ch
from enlsip_tpu_torch.testing import assert_tree_close

from torch_port_helpers import ref_tree, tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

ATOL = 1e-10
SHAPES = [(16, 12), (33, 20), (24, 40)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_packed(shape):
    """The packed triple itself: Bt, tau, perm."""
    rng = np.random.default_rng(0)
    M = rng.normal(size=shape)
    jBt, jtau, jperm = cpqr_pallas2_packed(jnp.asarray(M), min(shape),
                                           interpret=True)
    Bt, tau, perm = ch.cpqr_hopper(tt(M), min(shape))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm)[0])
    np.testing.assert_allclose(Bt.numpy(), np.asarray(jBt), atol=ATOL)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau)[0], atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_unpacked_matches_pallas_and_rank1_loop(shape):
    rng = np.random.default_rng(0)
    M = rng.normal(size=shape)
    tf = tb.unpack_packed(*ch.cpqr_hopper(tt(M), min(shape)))
    for jf in (cpqr_pallas2(jnp.asarray(M), interpret=True),
               _cpqr_xla(jnp.asarray(M), NB, None)):
        np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))
        assert_tree_close(tf, ref_tree(jf), ATOL, skip=("perm",))


def test_masked_nsteps_matches_pallas():
    """Trailing zero columns: running only the live steps reproduces the
    Pallas kernel's result, and Q R = M[:, perm]."""
    rng = np.random.default_rng(1)
    M = rng.normal(size=(20, 14))
    M[:, 9:] = 0.0
    jf = cpqr_pallas2(jnp.asarray(M), nsteps=9, interpret=True)
    tf = tb.unpack_packed(*ch.cpqr_hopper(tt(M), 9))
    np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))
    assert_tree_close(tf, ref_tree(jf), ATOL, skip=("perm",))
    Q = tb.q_apply(tf, torch.eye(20, dtype=torch.float64)).numpy()
    R = np.zeros((20, 14))
    R[:14] = tf.R.numpy()
    np.testing.assert_allclose(Q @ R, M[:, tf.perm.numpy()], atol=ATOL)


def test_zero_column_rules():
    """A zero tail gives tau = 0, v = 0 and keeps alpha on the diagonal."""
    M = np.zeros((6, 4))
    M[0, 0] = 2.0
    Bt, tau, perm = ch.cpqr_hopper(tt(M), 4)
    assert float(Bt[0, 0]) == -2.0 and float(tau[0]) == 2.0
    assert np.all(tau.numpy()[1:] == 0.0)
    assert np.all(Bt.numpy()[1:] == 0.0)
    np.testing.assert_array_equal(perm.numpy(), np.arange(4))


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    M = tt(np.random.default_rng(4).normal(size=(12, 8)))
    before = ch.cpqr_hopper.launches
    got = ch.cpqr_hopper(M, 8)
    want = tb.cpqr_packed_plain(M, 8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ch.cpqr_hopper.launches == before


def test_nsteps_is_clamped():
    M = tt(np.random.default_rng(4).normal(size=(12, 8)))
    for a, b in zip(ch.cpqr_hopper(M, 99), ch.cpqr_hopper(M, 8)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "ndim", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    M = {"dtype": torch.zeros((4, 3), dtype=torch.float16),
         "ndim": torch.zeros(4, dtype=torch.float64),
         "empty": torch.zeros((0, 3), dtype=torch.float64)}[bad]
    with pytest.raises((TypeError, ValueError)):
        ch.cpqr_hopper(M, 1)


def test_asking_for_the_card_without_one_raises():
    """Entry points never carry on on the CPU by themselves."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tb.cpqr_blocked(tt(np.eye(4)))
    with pytest.raises(RuntimeError, match="CUDA device"):
        tb.cpqr_blocked(tt(np.eye(4)), device="cuda")


# ------------------------------------------------ the resident route

H100 = dict(sm_count=132, shared_bytes_per_block=232_448)


@pytest.mark.parametrize("rows,cols", [(1000, 998), (1998, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fits_resident_takes_the_main_paths_shapes(rows, cols, dtype):
    assert ch.fits_resident(rows, cols, dtype, **H100)


@pytest.mark.parametrize("rows,cols,dtype,sms,fits", [
    (4096, 4096, torch.float64, 132, False),      # 128 MB: never
    (2600, 2400, torch.float64, 132, False),      # 19 columns x 20.8 KB a block
    (1998, 1000, torch.float64, 64, False),       # 16 columns a block: 256 KB
    (1998, 1000, torch.float32, 64, True),
    (1000, 998, torch.float64, 32, False),
    (1000, 998, torch.float32, 32, True),
    (257, 193, torch.float64, 132, True),
    (8, 3, torch.float64, 132, True),             # fewer columns than SMs
    (1000, 998, torch.float16, 132, False),
])
def test_fits_resident_by_shape_dtype_and_sm_count(rows, cols, dtype, sms, fits):
    assert ch.fits_resident(rows, cols, dtype, sms, 232_448) is fits


def test_fits_resident_follows_the_shared_memory_formula():
    """ceil(cols / blocks) columns, the reflector, the norms, two int32
    maps; the gate is that formula against the block's limit."""
    need = ch._resident_shared_bytes(1998, 1000, 132, 8)
    assert need == (8 * 1998 + 1998 + 8) * 8 + 2 * 1000 * 4
    assert ch.fits_resident(1998, 1000, torch.float64, 132, need)
    assert not ch.fits_resident(1998, 1000, torch.float64, 132, need - 1)


def resident_model(M: torch.Tensor, nsteps: int, blocks: int):
    """The resident kernel's algorithm in plain PyTorch: columns dealt
    round-robin to ``blocks`` owners and never moved; a pivot exchange
    only edits the position <-> column maps; every owner offers its best
    live column by (norm, current position), lowest position first among
    equals; the winner's squared norm is the reflector's; a column is
    written to its packed position when chosen, the rest at the end."""
    rows, cols = M.shape
    kmax = min(rows, cols)
    _, kp = tb.panel_width(kmax)
    A = M.clone()                                   # columns stay in place
    out = torch.zeros((cols, rows), dtype=M.dtype)
    tau = torch.zeros(kp, dtype=M.dtype)
    pos2col = list(range(cols))
    col2pos = list(range(cols))
    nrm = (A * A).sum(dim=0)
    for k in range(nsteps):
        offers = []                                 # (norm, position, column)
        for b in range(min(blocks, cols)):
            best = None
            for c in range(b, cols, blocks):
                p = col2pos[c]
                if p < k:
                    continue
                v = float(nrm[c])
                if best is None or v > best[0] or (v == best[0] and p < best[1]):
                    best = (v, p, c)
            if best is not None:
                offers.append(best)
        val, piv, c = offers[0]
        for v, p, cc in offers[1:]:
            if v > val or (v == val and p < piv):
                val, piv, c = v, p, cc
        ck = pos2col[k]
        pos2col[k], pos2col[piv] = c, ck
        col2pos[ck], col2pos[c] = piv, k
        alpha = A[k, c].clone()
        signorm = torch.sqrt(torch.as_tensor(val, dtype=M.dtype))
        beta = -signorm if alpha >= 0 else signorm
        den = alpha - beta
        safe = bool(den.abs() > 0)
        t = (beta - alpha) / beta if safe and beta != 0 else torch.zeros(())
        v = torch.zeros(rows, dtype=M.dtype)
        v[k + 1:] = A[k + 1:, c] / (den if safe else 1.0)
        live = [j for j in range(cols) if col2pos[j] > k]
        if t != 0 and live:
            dot = A[k, live] + v[k + 1:] @ A[k + 1:, live]
            A[k:, live] -= torch.outer(
                torch.cat([torch.ones(1, dtype=M.dtype), v[k + 1:]]), t * dot)
        nrm = (A[k + 1:] * A[k + 1:]).sum(dim=0)
        out[k, :k] = A[:k, c]
        out[k, k] = beta if safe else alpha
        out[k, k + 1:] = v[k + 1:]
        tau[k] = t
    for c in range(cols):
        if col2pos[c] >= nsteps:
            out[col2pos[c]] = A[:, c]
    return out, tau, torch.tensor(pos2col)


def _model_case(kind):
    rng = np.random.default_rng(7)
    M = rng.normal(size=(16, 12))
    nsteps = 12
    if kind == "all_ties":
        # unit-norm columns, as the solver's row-scaled A_act^T: the pivot
        # is decided by position at every step where norms tie
        M = np.zeros((16, 12))
        M[np.arange(12), np.arange(12)] = 1.0
        M[12:, :] = 0.0
        M = M[:, rng.permutation(12)]
    elif kind == "zero_column":
        M[:, [2, 7]] = 0.0
    elif kind == "short_nsteps":
        M[:, :7] = 0.0                   # the solver's J2: 5 live columns
        nsteps = 5
    return M, nsteps


@pytest.mark.parametrize("kind", ["random", "all_ties", "zero_column",
                                  "short_nsteps"])
def test_resident_bookkeeping_model_matches_pallas_and_plain(kind):
    """perm exact, packed values and tau to 1e-10, against the Pallas
    kernel in interpret mode and against the plain version; the same
    result whatever the number of owners."""
    M, nsteps = _model_case(kind)
    jBt, jtau, jperm = cpqr_pallas2_packed(jnp.asarray(M), nsteps,
                                           interpret=True)
    Pt, ptau, pperm = tb.cpqr_packed_plain(tt(M), nsteps)
    Bt, tau, perm = resident_model(tt(M), nsteps, blocks=5)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm)[0])
    np.testing.assert_array_equal(perm.numpy(), pperm.numpy())
    np.testing.assert_allclose(Bt.numpy(), np.asarray(jBt), atol=ATOL)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau)[0], atol=ATOL)
    np.testing.assert_allclose(Bt.numpy(), Pt.numpy(), atol=ATOL)
    np.testing.assert_allclose(tau.numpy(), ptau.numpy(), atol=ATOL)
    for blocks in (1, 3, 12, 40):
        for a, b in zip(resident_model(tt(M), nsteps, blocks), (Bt, tau, perm)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["resident", "panels"])
def test_routes_take_the_plain_version_on_the_cpu(route):
    """Both route names are entry points of their own; on a CPU tensor
    each is its plain version (exact norms for the resident route, the
    panel loop with downdated norms for the panel route) and counts no
    launch."""
    fn, plain = {"resident": (ch.cpqr_hopper_resident, tb.cpqr_packed_plain),
                 "panels": (ch.cpqr_hopper_panels,
                            tb.cpqr_panels_packed_plain)}[route]
    M = tt(np.random.default_rng(5).normal(size=(12, 8)))
    before = ch.cpqr_hopper.launches
    for a, b in zip(fn(M, 6), plain(M, 6)):
        assert torch.equal(a, b)
    assert ch.cpqr_hopper.launches == before
    with pytest.raises((TypeError, ValueError)):
        fn(torch.zeros((4, 3), dtype=torch.float16), 1)


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Needs the card and nvcc (run with ``pytest -m gpu``);
    ``chip_smoke.py`` makes the same comparison at the main path's
    shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    M = tt(np.random.default_rng(0).normal(size=(257, 193))).cuda()
    for fn, plain in ((ch.cpqr_hopper, tb.cpqr_packed_plain),
                      (ch.cpqr_hopper_resident, tb.cpqr_packed_plain),
                      (ch.cpqr_hopper_panels, tb.cpqr_panels_packed_plain)):
        Pt, ptau, pperm = plain(M, 193)
        Bt, tau, perm = fn(M, 193)
        assert torch.equal(perm, pperm)
        assert float((Bt - Pt).abs().max()) <= 1e-9 * float(Pt.abs().max())
        assert float((tau - ptau).abs().max()) <= 1e-9
