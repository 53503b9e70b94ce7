"""B1's panel route (ops/cpqr_hopper.py, csrc/cpqr_panels.cu) on the CPU.

The kernel computes, for a matrix too large for the card's shared
memory, what the JAX package computes there: ``_cpqr_xla_panels``, the
geqp3 panel loop with downdated norms.  It cannot run here; what can be
tested without a card is tested here:

* its plain version ``cpqr_panels_packed_plain``, unpacked, against JAX's
  ``_cpqr_xla_panels`` at float64: perm equal, R / V / tau / T / diag
  within 1e-12 relative (the same arithmetic in another summation order),
  on a square and a wide matrix with small panel widths (partial last
  panels; zero columns, and a rank-deficient matrix factored to its
  rank, at the square shape), and at 9700 x 200 with NB = 128 (a partial
  second panel): random, and a masked J2-like buffer with 2 live
  trailing columns and nsteps = 2;
* a plain PyTorch model of the kernel's decomposition (columns owned by
  blocks and never moved, positions exchanged instead of columns, per
  block candidates, bcol and its sum of squares in 32-row slices, Vp^T v
  in row-slice partials, frozen F rows of chosen columns, the masked
  panel-end update with the next panel's norms, the reflectors kept as
  the tails of the packed output, the final packed write), held against
  JAX's panels and giving the same bits for every block count;
* the route rule ``b1_route`` at cr5000's and cr1000's shapes;
* C10: on a matrix the resident route cannot hold, exact-norm pivoting
  (what the removed stream route computed) and JAX's panels choose
  different perms, and the route ``b1_route`` names gives JAX's.

Three matrix shapes go through JAX, each compiled once (nsteps traced).
``chip_smoke.py`` (``b1_panels``) holds the kernel against the plain
version on the card, and ``tests/test_torch_cpqr_kernel.py`` the gpu
marked comparison; the gpu marked test here holds the kernel where the
first pivots take every column of one block (its W^T v sweep is dealt
over the whole grid, whoever owns the columns)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.ops.blocked_qr import _cpqr_xla_panels as j_panels
from enlsip_tpu_torch.ops import blocked_qr as tb
from enlsip_tpu_torch.ops import cpqr_hopper as ch

from torch_port_helpers import tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

RTOL = 1e-12
BIG = (9700, 200)     # oversized for an H100's shared memory at float64


def _matrix(kind: str, rows: int, cols: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(rows, cols))
    if kind == "masked_j2":
        M[:, :cols - 2] = 0.0            # the solver's J2: live columns last
    elif kind == "zero_columns":
        M[:, [1, 17, cols // 2, cols - 1]] = 0.0
    elif kind == "rank_deficient":
        rank = 5 * min(rows, cols) // 8
        M = rng.normal(size=(rows, rank)) @ rng.normal(size=(rank, cols))
    elif kind == "all_ties":
        # unit columns, shuffled: every pivot is decided by position
        M = np.zeros((rows, cols))
        M[np.arange(min(rows, cols)), np.arange(min(rows, cols))] = 1.0
        M = M[:, rng.permutation(cols)]
    elif kind == "c10":
        # tests/torch_dist_cases.large_qr_matrix at 9700 rows (noise
        # scaled so that its columns' norms stay as small): the first
        # downdate of column 5 cancels 2^54 against 2^54, so downdated
        # and exact norms choose different second pivots
        M = 0.002 * M
        M[:, 0], M[0, 0] = 0.0, 2.0 ** 28
        M[:, 5], M[0, 5], M[300, 5] = 0.0, 2.0 ** 27, 1.0
        M[:, 7], M[10, 7], M[250, 7] = 0.0, 0.5, 0.5
    elif kind != "random":
        raise ValueError(kind)
    return M


# name: (kind, shape, nb, nsteps, seed)
CASES = {
    "square": ("random", (64, 64), 24, 64, 1),        # panels 24, 24, 16
    "wide": ("random", (40, 72), 16, 40, 2),          # panels 16, 16, 8
    "partial_last_panel": ("random", BIG, tb.NB, 200, 3),   # 128 + 72
    "masked_j2": ("masked_j2", BIG, tb.NB, 2, 4),
    "zero_columns": ("zero_columns", (64, 64), 24, 64, 5),
    "rank_deficient": ("rank_deficient", (64, 64), 24, 40, 6),
    "c10": ("c10", BIG, tb.NB, 200, 13),
    "all_ties": ("all_ties", (64, 64), 24, 64, 7),
    "short_nsteps": ("masked_j2", (40, 72), 16, 2, 8),
}


@functools.lru_cache(maxsize=None)
def _jax_panels_fn(nb: int):
    return jax.jit(j_panels, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(M, nb, nsteps, JAX's CPQRF as numpy arrays) of a case."""
    kind, shape, nb, nsteps, seed = CASES[name]
    M = _matrix(kind, *shape, seed)
    jf = _jax_panels_fn(nb)(jnp.asarray(M), nb, jnp.asarray(nsteps, jnp.int32))
    return M, nb, nsteps, {k: np.asarray(v) for k, v in jf._asdict().items()}


def _hold_against_jax(f, want, nsteps):
    """perm equal; R, the live columns of V, tau, T and diag within RTOL
    relative to the reference's largest entry."""
    np.testing.assert_array_equal(f.perm.numpy(), want["perm"])
    got = {k: getattr(f, k).numpy() for k in ("R", "V", "tau", "T", "diag")}
    # V's columns past nsteps carry the trailing matrix in the packed
    # form (T makes them no-ops); the reference keeps zeros there
    got["V"], want_V = got["V"][:, :nsteps], want["V"][:, :nsteps]
    for k, w in (("R", want["R"]), ("V", want_V), ("tau", want["tau"]),
                 ("T", want["T"]), ("diag", want["diag"])):
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(got[k] - w).max()) if w.size else 0.0
        assert err <= RTOL * scale, (k, err, scale)


@pytest.mark.parametrize("name", ["square", "wide", "partial_last_panel",
                                  "masked_j2", "zero_columns",
                                  "rank_deficient"])
def test_plain_version_equals_jax_panels(name):
    M, nb, nsteps, want = _case(name)
    f = tb.unpack_packed(*tb.cpqr_panels_packed_plain(tt(M), nsteps, nb), nb=nb)
    _hold_against_jax(f, want, nsteps)
    if name == "masked_j2":
        # the live columns first, tau = 0 past them
        assert sorted(f.perm[:2].tolist()) == [M.shape[1] - 2, M.shape[1] - 1]
        assert float(f.tau[2:].abs().max()) == 0.0


def test_panel_wrapper_takes_the_plain_version_on_the_cpu():
    M, nb, nsteps, _ = _case("c10")
    before = (ch.cpqr_hopper.launches, ch.cpqr_hopper_panels.launches)
    got = ch.cpqr_hopper_panels(tt(M), nsteps)
    want = tb.cpqr_panels_packed_plain(tt(M), nsteps)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (ch.cpqr_hopper.launches, ch.cpqr_hopper_panels.launches) == before


# ------------------------------------------------------ the route rule

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_b1_route_at_cr5000_and_cr1000(dtype):
    for shape in ((5000, 4998), (9998, 5000)):      # cr5000: A_act^T, J2
        assert ch.b1_route(*shape, dtype, *ch.H100_LIMITS) == "panels"
        assert ch.fits_panels(*shape, dtype, 132, 232_448)
    for shape in ((1000, 998), (1998, 1000)):       # cr1000: A_act^T, J2
        assert ch.b1_route(*shape, dtype, *ch.H100_LIMITS) == "resident"
        # a card without cooperative launches has no resident route
        assert ch.b1_route(*shape, dtype, 132, 232_448, False) == "panels"
    assert ch.b1_route(*BIG, torch.float64, *ch.H100_LIMITS) == "panels"


def test_panel_layout_bounds_the_columns_not_the_rows():
    """The kernel's shared memory holds F rows of a block's columns: the
    formula against the block's limit, and the 128-columns-a-block cap."""
    need = ch._panels_shared_bytes(5000, 4998, 132, 128, 8)
    # the stage holds the whole of v (5,120 rows: ten 512-row segments);
    # a position a column of the block's own; a bit and a 16-bit list
    # entry a column of the matrix
    assert need == (5120 * 8 + (38 * (128 + 3) + 4 * 128) * 8 + 4 * 38
                    + 4 * 157 + 2 * 4998)
    assert ch.fits_panels(10 ** 6, 2000, torch.float64, 132, 232_448)
    for dtype in (torch.float32, torch.float64):
        assert ch.fits_panels(1000, 16_896, dtype, 132, 232_448)
        assert not ch.fits_panels(1000, 16_897, dtype, 132, 232_448)
    # with less shared memory a block the F rows bind first
    assert ch.fits_panels(1000, 6202, torch.float64, 132, 100_000)
    assert not ch.fits_panels(1000, 6203, torch.float64, 132, 100_000)


# --------------------------------------------------------------- C10

def test_c10_oversized_matrix_takes_downdated_norms():
    """9700 x 200 at float64 does not fit an H100's shared memory; its
    exact-norm order (the stream route's) differs from JAX's downdated
    one, and the dispatch's route gives JAX's: the single matrix and each
    lane of a batch."""
    M, nb, nsteps, want = _case("c10")
    assert ch.b1_route(*M.shape, torch.float64, *ch.H100_LIMITS) == "panels"
    exact = tb.cpqr_packed_plain(tt(M), nsteps)[2].numpy()
    assert want["perm"][:4].tolist() == [0, 7, 55, 92]
    assert exact[:4].tolist() == [0, 5, 7, 55]
    f = tb.unpack_packed(*ch.cpqr_hopper(tt(M), nsteps))
    _hold_against_jax(f, want, nsteps)
    lanes = ch.cpqr_hopper_lanes(tt(np.stack([M, M])),
                                 torch.tensor([nsteps, 2]))
    np.testing.assert_array_equal(lanes[2][0].numpy(), want["perm"])
    assert lanes[2][1, :2].tolist() == [0, 7]


# ------------------------------------------- the kernel's decomposition

def panels_model(M: torch.Tensor, nsteps: int, nb: int, blocks: int,
                 w2_chunk: int = 512):
    """The panel kernel's algorithm in plain PyTorch, step by step as
    ``csrc/cpqr_panels.cu`` runs it: column c owned by block c mod G and
    never moved, its position in ``pos``; per block candidates by
    (downdated norm, position); bcol over rows >= k with its sum of
    squares in 32-row slices; the reflector written as the tail of packed
    column k (unwritten output stays NaN, so a read of it shows); Vp^T v
    in ``w2_chunk``-row partials summed in slice order; W^T v, F[:, j],
    row k and the downdate for live columns only, chosen columns' F rows
    frozen; at panel end W -= Vp F^T over rows >= s from a masked Vp
    (zero above each reflector's row, its unit on it), on the live
    columns and above the diagonal of the chosen ones, the next panel's
    exact norms from the updated rows; finally every column to its packed
    position."""
    rows, cols = M.shape
    kmax = min(rows, cols)
    _, kp = tb.panel_width(kmax, nb)
    ns = max(0, min(nsteps, kmax))
    G = min(blocks, cols)
    W = M.t().clone()                               # (cols, rows)
    out = torch.full((cols, rows), float("nan"), dtype=M.dtype)
    tauv = torch.full((kp,), float("nan"), dtype=M.dtype)
    pos = list(range(cols))
    F = torch.zeros((cols, nb), dtype=M.dtype)
    nrm = (W * W).sum(dim=1)
    for s in range(0, ns, nb):
        jn = min(nb, ns - s)
        for j in range(jn):
            k = s + j
            # ---- candidates, then the first maximum over them
            offers = []
            for b in range(G):
                best = first = None
                for c in range(b, cols, G):
                    p = pos[c]
                    if p < k:
                        continue
                    v = float(nrm[c])
                    if v == v and (best is None or v > best[0]
                                   or (v == best[0] and p < best[1])):
                        best = (v, p, c)
                    if first is None or p < first[1]:
                        first = (-1.0, p, c)
                if best or first:
                    offers.append(best or first)
            val, piv, c = offers[0]
            for v, p, cc in offers[1:]:
                if v > val or (v == val and p < piv):
                    val, piv, c = v, p, cc
            for cc in range(cols):
                if cc == c:
                    pos[cc] = k
                elif pos[cc] == k:
                    pos[cc] = piv
            # ---- bcol in 32-row slices, rows >= k
            bcol = torch.zeros(rows, dtype=M.dtype)
            bcol[k:] = W[c, k:] - F[c, :j] @ out[s:s + j, k:]
            parts = [float((bcol[max(t, k):t + 32] ** 2).sum())
                     for t in range(k - k % 32, rows, 32)]
            ss = torch.tensor(0.0, dtype=M.dtype)
            for part in parts:
                ss = ss + part
            # ---- the reflector
            alpha = bcol[k].clone()
            signorm = torch.sqrt(ss)
            beta = -signorm if alpha >= 0 else signorm
            den = alpha - beta
            safe = bool(den.abs() > 0)
            tau = (beta - alpha) / beta if safe and beta != 0 else \
                torch.zeros((), dtype=M.dtype)
            denom = den if safe else torch.ones((), dtype=M.dtype)
            unit = 1.0 if safe else 0.0
            W[c, k] = beta if safe else alpha
            tauv[k] = tau
            out[k, k + 1:] = bcol[k + 1:] / denom
            v = torch.zeros(rows, dtype=M.dtype)
            v[k], v[k + 1:] = unit, bcol[k + 1:] / denom
            # ---- Vp^T v in row-slice partials
            w2 = torch.zeros(j, dtype=M.dtype)
            for u0 in range(k - k % w2_chunk, rows, w2_chunk):
                lo, hi = max(u0, k), min(rows, u0 + w2_chunk)
                w2 = w2 + out[s:s + j, lo:hi] @ v[lo:hi]
            # ---- the live columns: W^T v, F[:, j], row k, the downdate
            vpk = torch.cat([out[s:s + j, k],
                             torch.tensor([unit], dtype=M.dtype)])
            for cc in range(cols):
                if pos[cc] <= k:
                    continue
                w1 = W[cc, k:] @ v[k:]
                f = tau * (w1 - F[cc, :j] @ w2) if tau != 0 else 0.0
                F[cc, j] = f
                rowk = W[cc, k] - F[cc, :j + 1] @ vpk
                nrm[cc] = torch.clamp(nrm[cc] - rowk * rowk, min=0.0)
        # ---- panel end
        unitp = (tauv[s:s + jn] != 0).to(M.dtype)
        i = torch.arange(s, rows)[:, None]
        kq = s + torch.arange(jn)[None, :]
        Vm = torch.where(i > kq, out[s:s + jn, s:].t(),
                         torch.where(i == kq, unitp[None, :],
                                     torch.zeros((), dtype=M.dtype)))
        for cc in range(cols):
            p = pos[cc]
            if p < s:
                continue
            hi = rows if p >= s + jn else p
            W[cc, s:hi] -= Vm[:hi - s] @ F[cc, :jn]
            if p >= s + jn and s + nb < ns:
                nrm[cc] = (W[cc, s + nb:] ** 2).sum()
        F.zero_()
    for cc in range(cols):
        p = pos[cc]
        n = p + 1 if p < ns else rows
        out[p, :n] = W[cc, :n]
    tauv[ns:] = 0.0
    perm = torch.empty(cols, dtype=torch.int64)
    for cc in range(cols):
        perm[pos[cc]] = cc
    return out, tauv, perm


@pytest.mark.parametrize("name", ["square", "wide", "all_ties",
                                  "short_nsteps"])
def test_kernel_model_matches_jax_for_every_block_count(name):
    M, nb, nsteps, want = _case(name)
    ref = panels_model(tt(M), nsteps, nb, blocks=5)
    assert not any(bool(t.isnan().any()) for t in ref[:2])
    _hold_against_jax(tb.unpack_packed(*ref, nb=nb), want, nsteps)
    for blocks in (1, 3, 64, 100):
        got = panels_model(tt(M), nsteps, nb, blocks)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), blocks
    # row-slice partials of another width: the same factorization
    other = panels_model(tt(M), nsteps, nb, blocks=5, w2_chunk=16)
    _hold_against_jax(tb.unpack_packed(*other, nb=nb), want, nsteps)


@pytest.mark.gpu
def test_kernel_when_one_block_loses_its_columns_first():
    """Needs the card and nvcc (run with ``pytest -m gpu``).  The W^T v
    sweep is one stream dealt over the whole grid, whichever block owns
    the columns: here every column of block 0 (c = 0 mod G, G blocks) has
    10^3 times the others' norm, so the first pivots empty block 0 while
    the others keep theirs.  perm equal to the plain panel loop, the
    packed result and tau within 1e-9, and equal bits on 8 blocks (the
    fewest that hold 1,000 columns, 128 a block), 13 and all of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rows, cols = 1100, 1000
    G = min(ch._device_limits("cuda")[0], cols)
    M = np.random.default_rng(18).normal(size=(rows, cols))
    M[:, ::G] *= 1e3
    M = tt(M).cuda()
    Bt, tau, perm = ch.cpqr_hopper_panels(M, cols)
    Pt, ptau, pperm = tb.cpqr_panels_packed_plain(M, cols)
    assert torch.equal(perm, pperm)
    assert sorted(perm[:-(-cols // G)].tolist()) == list(range(0, cols, G))
    assert float((Bt - Pt).abs().max()) <= 1e-9 * float(Pt.abs().max())
    assert float((tau - ptau).abs().max()) <= 1e-9
    for blocks in (8, 13, G):
        got = ch._launch("panels", M, cols, blocks)
        assert all(torch.equal(a, b) for a, b in zip(got, (Bt, tau, perm))), \
            blocks
