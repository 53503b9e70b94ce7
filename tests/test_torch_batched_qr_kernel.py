"""The batched CPQR kernel's design (csrc/cpqr_batched.cu), on the CPU.

The CUDA kernel cannot run here.  What can: its launch shape (the pure
functions ``group_size``, ``block_lanes`` and ``_shared_bytes`` of
ops/cpqr_batched_hopper.py) over every shape the gate accepts, and a
plain PyTorch model of the kernel's arithmetic order: G threads a lane,
thread t owning rows t, t + G, ...; every sum over rows a per-thread
partial in row order and then an xor butterfly over the group; step
k+1's norms taken from the values step k's update has just written; the
pivot scanned from the norms every thread holds.  The model is held
against the Pallas kernel it replaces, run in interpret mode at float32
(perm equal, atol 5e-5: the tolerance of tests/test_pallas_batched_qr.py),
and against the plain version at float64 (perm equal, 1e-10), at every
group size.  It also checks, at every butterfly, that the G threads of a
group hold bit-identical sums: the property that lets each of them pick
the pivot alone.  ``chip_smoke.py`` holds the kernel itself against the
plain version on the card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.ops import pallas_batched_qr as pbq
from enlsip_tpu_torch.ops import cpqr_batched_hopper as cb

from torch_port_helpers import tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

GROUPS = [1, 2, 4, 8, 16, 32]


# ------------------------------------------------------------ launch shape

def _old_gate_shapes():
    """Every (rows, cols) the kernel's gate accepted before this design:
    min(rows, cols) <= 32 and rows * cols <= 2048."""
    for rows in range(1, 2049):
        for cols in range(1, 2048 // rows + 1):
            if min(rows, cols) <= 32:
                yield rows, cols


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_shape_fits_every_gate_shape(dtype):
    """Every shape the gate accepted is still accepted, and its launch
    fits: G a power of two dividing 32, no more threads than rows, at
    least one lane a block, the block's shared memory within 227 KB and
    its threads within 1024."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    n = 0
    for rows, cols in _old_gate_shapes():
        assert cb.in_gate(rows, cols)
        G, L = cb.launch_shape(rows, cols, dtype)
        assert G in GROUPS and 32 % G == 0, (rows, cols, G)
        assert G == 1 or G < 2 * rows, (rows, cols, G)
        assert L >= 1, (rows, cols)
        assert cb._shared_bytes(rows, cols, itemsize, G, L) <= cb.SHARED_LIMIT
        assert -(-L * G // 32) * 32 <= 1024
        n += 1
    assert n > 15_000


def test_shared_bytes_formula():
    """The lane stride is at least the row-major matrix with its odd row
    stride, and = G * ld mod 32, so the 32 rows a warp reads at once sit
    on 32 distinct banks."""
    for rows, cols in [(40, 10), (10, 20), (3, 7), (64, 32), (1, 2048),
                       (2048, 1), (33, 17)]:
        ld = cols | 1
        for G in GROUPS:
            S = cb._lane_stride(rows, cols, G)
            assert rows * ld <= S < rows * ld + 32
            assert (S - G * ld) % 32 == 0
            for L in (1, 3, 32 // G):
                assert cb._shared_bytes(rows, cols, 4, G, L) == \
                    L * ((S + min(rows, cols)) * 4 + 4 * cols)
            # the word each thread of a warp reads at row r of its lane
            g, t = np.divmod(np.arange(32), G)
            for r in range(3):
                banks = (g * S + (t + G * r) * ld) % 32
                assert len(set(banks.tolist())) == 32, (rows, cols, G, r)


@pytest.mark.parametrize("rows,cols,G", [(40, 10, 8), (10, 20, 4), (3, 7, 1),
                                         (3, 3, 1), (64, 32, 32),
                                         (1, 2048, 1), (2048, 1, 32)])
def test_group_size_at_the_paths_shapes(rows, cols, G):
    """The main paths' shapes (J2 and A_act^T of the ODE fit and HS65),
    the gate's edge and its two thin extremes."""
    for dtype in (torch.float32, torch.float64):
        assert cb.group_size(rows, cols, dtype) == G


def test_block_lanes_fill_two_warps_or_shared_memory():
    assert cb.block_lanes(40, 10, torch.float32, 8) == 8
    assert cb.block_lanes(3, 3, torch.float64, 1) == 64
    # a (1, 2048) lane takes 16 KB at float32 (its row and its perm):
    # as many as fit, fewer than two warps' worth
    L = cb.block_lanes(1, 2048, torch.float32, 1)
    assert L < 64
    assert cb._shared_bytes(1, 2048, 4, 1, L) <= cb.SHARED_LIMIT
    assert cb._shared_bytes(1, 2048, 4, 1, L + 1) > cb.SHARED_LIMIT


# ------------------------------------------------ the kernel's arithmetic

def _butterfly(p, G):
    """v += shfl_xor(v, m) for m = 1, 2, .. G/2 over dim 1 (the group),
    asserting that every thread of a group ends with the same bits."""
    m = 1
    while m < G:
        p = p + p[:, torch.arange(G) ^ m]
        m *= 2
    assert torch.equal(p, p[:, :1].expand_as(p)), "group sums differ"
    return p


def _group_sum(terms, G):
    """terms (B, G, R, C): each thread's partial in row order, then the
    butterfly; returns (B, C) after checking the group agrees."""
    p = torch.zeros_like(terms[:, :, 0])
    for r in range(terms.shape[2]):
        p = p + terms[:, :, r]
    return _butterfly(p, G)[:, 0]


def _first_max(s, first, default):
    """The scan every thread runs: columns from ``first`` in increasing
    order, strict >, starting from (-1, default): the first maximum, and a
    NaN never wins.  Returns (pivot, its value)."""
    B, cols = s.shape
    j = torch.arange(cols)
    vals = torch.where((j >= first) & ~torch.isnan(s), s,
                       torch.full_like(s, -2.0))
    mx = vals.max(dim=1).values
    hit = torch.where(vals == mx[:, None], j, cols).min(dim=1).values
    take = mx > -1
    return (torch.where(take, hit, default),
            torch.where(take, mx, torch.full_like(mx, -1.0)))


def kernel_model(M: torch.Tensor, G: int):
    """The kernel's arithmetic on the CPU, in its order, for groups of G
    threads; returns (packed, tau, perm) like ``cpqr_batched_packed``.
    Differences that only the card has: fused multiply-adds, and rows
    past ``rows`` not owned at all (here they hold zero and add exact
    zeros at the end of a thread's partial)."""
    B, rows, cols = M.shape
    kmax = min(rows, cols)
    R = -(-rows // G)
    dt = M.dtype
    Xp = torch.zeros((B, R * G, cols), dtype=dt)
    Xp[:, :rows] = M
    X = Xp.reshape(B, R, G, cols).transpose(1, 2).clone()      # (B, G, R, cols)
    row = torch.arange(G)[:, None] + G * torch.arange(R)[None, :]  # (G, R)
    perm = torch.arange(cols).repeat(B, 1)
    taus = torch.zeros((B, kmax), dtype=dt)
    b = torch.arange(B)
    zero = torch.zeros((), dtype=dt)

    nrm = _group_sum(X * X, G)                                   # step 0: all rows
    piv, best = _first_max(nrm, 0, torch.zeros(B, dtype=torch.long))
    for k in range(kmax):
        # swap columns k <-> piv in every row, and perm
        ck, cp = X[..., k].clone(), X[b, :, :, piv].clone()
        X[..., k] = cp
        X[b, :, :, piv] = ck
        pk, pp = perm[:, k].clone(), perm[b, piv].clone()
        perm[:, k] = pp
        perm[b, piv] = pk
        # the reflector from the pivot's squared norm
        alpha = X[:, k % G, k // G, k]
        signorm = torch.sqrt(best)
        beta = torch.where(alpha >= 0, -signorm, signorm)
        denom = alpha - beta
        safe = denom.abs() > 0
        denom = torch.where(safe, denom, torch.ones_like(denom))
        tau = torch.where(safe & (beta != 0),
                          (beta - alpha) / torch.where(beta != 0, beta,
                                                       torch.ones_like(beta)),
                          zero)
        vk = safe.to(dt)
        below = (row > k)[None]
        X[..., k] = torch.where(below, X[..., k] / denom[:, None, None],
                                X[..., k])
        v = torch.where(below, X[..., k],
                        torch.where((row == k)[None], vk[:, None, None], zero))
        # dots of the columns > k, the update, and step k+1's norms
        on = (row >= k)[None, :, :, None]
        Xr = X[..., k + 1:]
        d = _group_sum(torch.where(on, v[..., None] * Xr, zero), G)
        w = d * tau[:, None]
        Y = torch.where(on & (tau != 0)[:, None, None, None],
                        Xr - w[:, None, None, :] * v[..., None], Xr)
        X[..., k + 1:] = Y
        if k + 1 < kmax:
            s = _group_sum(torch.where(below[..., None], Y * Y, zero), G)
            full = torch.full((B, cols), -1.0, dtype=dt)
            full[:, k + 1:] = s
            piv, best = _first_max(full, k + 1,
                                   torch.full((B,), k + 1, dtype=torch.long))
        X[:, k % G, k // G, k] = torch.where(safe, beta, alpha)
        taus[:, k] = tau
    packed = X.transpose(1, 2).reshape(B, R * G, cols)[:, :rows]
    return packed, taus, perm


def _unit_columns(rng, B, rows, cols):
    """Lanes whose columns are distinct unit vectors (norms tie to the bit
    at every step, whatever the order of the sums), and every fourth lane
    with all columns equal to one unit vector."""
    M = np.zeros((B, rows, cols))
    for lane in range(B):
        if lane % 4 == 3:
            M[lane, rng.integers(1, rows), :] = 1.0
        else:
            M[lane, rng.permutation(rows)[:cols], np.arange(cols)] = 1.0
    return M


def _case(kind):
    """(M as float64 numpy, whether M is handed over as a transposed view)."""
    rng = np.random.default_rng(11)
    if kind == "ragged":            # 11 rows: ragged for every G > 1
        return rng.normal(size=(5, 11, 6)), False
    if kind == "wide":              # HS65's A_act^T shape, 3 rows
        return rng.normal(size=(6, 3, 7)), False
    if kind == "all_ties":
        return _unit_columns(rng, 8, 12, 9), False
    if kind == "zero_lanes":
        M = rng.normal(size=(5, 7, 5))
        M[[1, 3]] = 0.0
        return M, False
    if kind == "transposed":        # A_act (B, l, n) handed over as A_act^T
        A = rng.normal(size=(5, 13, 9))
        A[:, 6:, :] = 0.0
        return np.ascontiguousarray(A.transpose(0, 2, 1)), True
    raise ValueError(kind)


KINDS = ["ragged", "wide", "all_ties", "zero_lanes", "transposed"]


def _as_input(M, transposed, dtype):
    T = torch.tensor(M, dtype=dtype)
    if transposed:
        return torch.tensor(np.ascontiguousarray(M.transpose(0, 2, 1)),
                            dtype=dtype).transpose(-1, -2)
    return T


@functools.lru_cache(maxsize=None)
def _pallas_f32(kind):
    """The Pallas kernel in interpret mode, once a case."""
    M, _ = _case(kind)
    jp, jtau, jperm = pbq.cpqr_batched_packed(
        jnp.asarray(M.astype(np.float32)), interpret=True)
    return np.asarray(jp), np.asarray(jtau), np.asarray(jperm)


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_model_matches_pallas_f32(kind, G):
    M, transposed = _case(kind)
    X = _as_input(M, transposed, torch.float32)
    assert X.is_contiguous() != transposed
    packed, tau, perm = kernel_model(X, G)
    jp, jtau, jperm = _pallas_f32(kind)
    np.testing.assert_array_equal(perm.numpy(), jperm)
    np.testing.assert_allclose(packed.numpy(), jp, atol=5e-5)
    np.testing.assert_allclose(tau.numpy(), jtau, atol=5e-5)


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_model_matches_plain_f64(kind, G):
    M, transposed = _case(kind)
    X = _as_input(M, transposed, torch.float64)
    packed, tau, perm = kernel_model(X, G)
    pp, ptau, pperm = cb.cpqr_batched_packed_plain(X)
    assert torch.equal(perm, pperm)
    assert float((packed - pp).abs().max()) <= 1e-10
    assert float((tau - ptau).abs().max()) <= 1e-10
    if kind == "zero_lanes":
        assert float(packed[[1, 3]].abs().max()) == 0.0
        assert float(tau[[1, 3]].abs().max()) == 0.0
    if kind == "all_ties":
        # exact arithmetic throughout: equal to the plain version's bits
        assert torch.equal(packed, pp) and torch.equal(tau, ptau)


def test_all_ties_resolve_to_the_lowest_index():
    """On the unit-column lanes every step ties: each pivot is the lowest
    live column, so perm keeps the identity."""
    M, _ = _case("all_ties")
    for G in GROUPS:
        _, _, perm = kernel_model(tt(M), G)
        assert torch.equal(perm, torch.arange(9).repeat(8, 1))


@pytest.mark.parametrize("G", [2, 4, 8, 16, 32])
def test_group_sums_are_bit_identical(G):
    """Partials of very different magnitudes and signs, whose sum depends
    on the order of the additions: the butterfly still leaves every
    thread of a group with the same bits (the model asserts it), and
    another order gives other bits."""
    rng = np.random.default_rng(G)
    p = torch.tensor(rng.normal(size=(64, G, 7)) *
                     10.0 ** rng.integers(-8, 9, size=(64, G, 7)),
                     dtype=torch.float32)
    got = _butterfly(p, G)[:, 0]
    serial = p[:, 0].clone()
    for t in range(1, G):
        serial = serial + p[:, t]
    if G >= 4:
        assert not torch.equal(got, serial)
    np.testing.assert_allclose(got.double().numpy(),
                               p.double().sum(dim=1).numpy(),
                               rtol=1e-5, atol=1e-5 * float(p.abs().max()))
