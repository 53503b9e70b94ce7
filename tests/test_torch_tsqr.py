"""PyTorch port of ops/tsqr.py (the two-stage tall factorizations, one
device) against the JAX package, float64 on the CPU unless said, on the
inputs of tests/test_cholqr.py and tests/test_tallqr.py.

Tolerances: R, R1, R2, diag, G 1e-10 (absolute + relative: the entries
of R are O(sqrt(m)) and both sides factor the same LAPACK way); perm
exact; the float32 single pass 5e-5 relative (float32 Gram of 256 rows);
an ill-conditioned buffer is held by the factorization's own contract
(orthogonality of the implicit Q, energy of Q^T v), because cond^2
amplifies the last-bit differences of the two Gram products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.ops import tsqr as jt
from enlsip_tpu.ops.qr import pseudo_rank as jpseudo_rank
from enlsip_tpu_torch.ops import tsqr as tq
from enlsip_tpu_torch.ops.qr import pseudo_rank
from enlsip_tpu_torch.testing import assert_tree_close

from torch_port_helpers import ref_tree, to_port, tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

TOL = dict(atol=1e-10, rtol=1e-10)
M_ROWS, N_COLS = 8192, 12


def _j2_like(seed=5):
    """tests/test_cholqr.py's buffer: two dead trailing columns."""
    M = np.random.default_rng(seed).normal(size=(M_ROWS, N_COLS))
    M[:, 10:] = 0.0
    return M


_jchol = jax.jit(lambda M: jt.cholqr_cpqr(M, nsteps=N_COLS))
_jchol_live = jax.jit(lambda M, live: jt.cholqr_cpqr(
    M, nsteps=N_COLS - 2, col_live=live))
_jchol_gram = jax.jit(lambda G, y: jt.cholqr_cpqr(
    jnp.zeros((0, N_COLS)), nsteps=N_COLS, gram=G, jtrx=y))
_jtsqr = jax.jit(lambda M: jt.tsqr_cpqr(M, nsteps=N_COLS, axis=None))


def _same_factor(tf, jf, by_value=True):
    """perm exact; the first-stage factors by value; the stage-2 R and
    diag by value, or (``by_value=False``) up to one sign per row of R:
    with LEADING dead columns stage 2 builds reflectors on pivot entries
    that are zero up to rounding, whose sign is noise on both sides (no
    consumer reads a row's sign: the solves and prefix norms do not
    change)."""
    np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))
    skip = ("perm", "M", "qloc") + (() if by_value else ("f2",))
    assert_tree_close(tf, ref_tree(jf), skip=skip, **TOL)
    Rt, Rj = tf.R.numpy(), np.asarray(jf.R)
    dt, dj = tf.diag.numpy(), np.asarray(jf.diag)
    if not by_value:
        sign = np.sign(dt) * np.sign(dj)
        sign = np.where(sign == 0, 1.0, sign)
        Rt, dt = sign[:, None] * Rt, sign * dt
    np.testing.assert_allclose(Rt, Rj, **TOL)
    np.testing.assert_allclose(dt, dj, **TOL)
    assert tf.R.shape == (N_COLS, N_COLS) and tf.diag.shape == (N_COLS,)


@pytest.mark.parametrize("mode", ["plain", "col_live", "gram_jtrx"])
def test_cholqr_cpqr_matches_reference(mode):
    M = _j2_like()
    if mode == "plain":
        jf = _jchol(jnp.asarray(M))
        tf = tq.cholqr_cpqr(tt(M), nsteps=N_COLS)
        assert tf.M.shape == (M_ROWS, N_COLS) and tf.jtrx is None
    elif mode == "col_live":
        # an UNMASKED buffer with the first two columns declared dead
        M = np.random.default_rng(7).normal(size=(M_ROWS, N_COLS))
        live = np.arange(N_COLS) >= 2
        jf = _jchol_live(jnp.asarray(M), jnp.asarray(live))
        tf = tq.cholqr_cpqr(tt(M), nsteps=tt(N_COLS - 2), col_live=tt(live))
        assert float(tf.R1[:, :2].abs().max()) == 0.0
        # the kept Gram is the unmasked one
        np.testing.assert_allclose(tf.G.numpy(), M.T @ M, **TOL)
    else:
        # the caller holds the Gram and the projection (the fused
        # kernel's outputs); the buffer is a (0, n) placeholder
        G, y = M.T @ M, M.T @ np.random.default_rng(8).normal(size=M_ROWS)
        jf = _jchol_gram(jnp.asarray(G), jnp.asarray(y))
        tf = tq.cholqr_cpqr(torch.zeros((0, N_COLS), dtype=torch.float64),
                            nsteps=N_COLS, gram=tt(G), jtrx=tt(y))
        assert tf.M.shape == (0, N_COLS)
        assert torch.equal(tf.G, tt(G)) and torch.equal(tf.jtrx, tt(y))
    assert tf.R2 is not None and jf.R2 is not None      # float64: refined
    _same_factor(tf, jf, by_value=mode != "col_live")


def test_cholqr_float32_is_single_pass():
    M = np.random.default_rng(1).normal(size=(256, 6)).astype(np.float32)
    jf = jt.cholqr_cpqr(jnp.asarray(M), nsteps=6)
    tf = tq.cholqr_cpqr(torch.tensor(M), nsteps=6)
    assert tf.R2 is None and jf.R2 is None
    assert tf.R1.dtype == torch.float32
    np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))
    np.testing.assert_allclose(tf.R1.numpy(), np.asarray(jf.R1), rtol=5e-5,
                               atol=5e-5)
    np.testing.assert_allclose(tf.R.numpy(), np.asarray(jf.R), rtol=5e-5,
                               atol=5e-5)


@pytest.mark.parametrize("case", ["dependent_column", "all_zero"])
def test_cholqr_rank_deficiency(case):
    """tests/test_cholqr.py::test_cholqr_rank_deficiency_detected: a
    dependent live column is found by stage 2's diag; an all-dead buffer
    (whose Cholesky fails) gives finite zeros and rank 0."""
    m = 4096
    M = np.random.default_rng(6).normal(size=(m, 6))
    if case == "dependent_column":
        M[:, 5] = 2.0 * M[:, 0] + M[:, 1]
        want = 5
    else:
        M[:] = 0.0
        want = 0
    tf = tq.cholqr_cpqr(tt(M), nsteps=6)
    jf = jt.cholqr_cpqr(jnp.asarray(M), nsteps=6)
    assert bool(torch.isfinite(tf.R).all()) and bool(torch.isfinite(tf.R1).all())
    rank = int(pseudo_rank(tf.diag, tt(6), 1e-8))
    assert rank == want == int(jpseudo_rank(jf.diag, jnp.int32(6),
                                            jnp.asarray(1e-8)))
    np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))
    # entries within the numerical rank agree; the last pivot of the
    # dependent case is rounding noise on both sides
    np.testing.assert_allclose(tf.diag.numpy()[:want],
                               np.asarray(jf.diag)[:want], **TOL)
    if case == "all_zero":
        assert float(tf.R.abs().max()) == 0.0
        assert float(tq.qt_apply_cholqr(tf, tt(np.ones(m)))[6]) == \
            pytest.approx(np.sqrt(m), rel=1e-14)


@pytest.mark.parametrize("cond,max_ratio", [(1e4, 1.1), (1e6, 0.1),
                                            (1e8, 0.5)])
def test_cholqr2_refinement_improves_orthogonality(cond, max_ratio):
    """tests/test_cholqr.py::test_cholqr2_refinement_improves_
    orthogonality_f64 on the port: the refined implicit Q is more
    orthogonal than the single pass by the reference's factors, and the
    energy contract of qt_apply_cholqr holds at any conditioning.  Both
    sides get the reference's Gram: cond^2 amplifies the last-bit
    differences of two Gram products into the measured ratios."""
    rng = np.random.default_rng(0)
    m, n = 512, 8
    U, _ = np.linalg.qr(rng.normal(size=(m, n)))
    V, _ = np.linalg.qr(rng.normal(size=(n, n)))
    v = rng.normal(size=m)
    s = np.logspace(0, -np.log10(cond), n)
    M = (U * s) @ V.T
    jf = jt.cholqr_cpqr(jnp.asarray(M), nsteps=n)
    f = tq.cholqr_cpqr(tt(M), nsteps=n, gram=tt(np.asarray(jf.G)))

    def orthogonality(R1, R2):
        Q1 = np.linalg.solve(R1.T, M.T).T
        Q = np.linalg.solve(R2.T, Q1.T).T
        return (np.linalg.norm(Q1.T @ Q1 - np.eye(n)),
                np.linalg.norm(Q.T @ Q - np.eye(n)))

    orth1, orth = orthogonality(f.R1.numpy(), f.R2.numpy())
    jorth1, jorth = orthogonality(np.asarray(jf.R1), np.asarray(jf.R2))
    assert orth <= max_ratio * orth1, (cond, orth, orth1)
    # the same loss of orthogonality as the reference, to 5 %
    assert abs(orth - jorth) <= 0.05 * jorth, (cond, orth, jorth)
    out = tq.qt_apply_cholqr(f, tt(v))
    assert abs(float(torch.sum(out ** 2)) - float(v @ v)) < 1e-10
    np.testing.assert_array_equal(f.perm.numpy(), np.asarray(jf.perm))


@pytest.mark.parametrize("mode", ["plain", "col_live"])
def test_qt_apply_cholqr_matches_reference(mode):
    """Q^T v on the reference's own factor carried across: every entry of
    the (m,) embedding, the energy contract, and the consumer-level
    solves of tests/test_cholqr.py."""
    rng = np.random.default_rng(5)
    if mode == "plain":
        M = _j2_like()
        jf = _jchol(jnp.asarray(M))
    else:
        M = rng.normal(size=(M_ROWS, N_COLS))
        jf = _jchol_live(jnp.asarray(M), jnp.asarray(np.arange(N_COLS) >= 2))
    v = rng.normal(size=M_ROWS)
    want = np.asarray(jt.qt_apply_cholqr(jf, jnp.asarray(v)))
    tf = to_port(jf)
    assert isinstance(tf, tq.CholQRF)
    got = tq.qt_apply_cholqr(tf, tt(v))
    assert got.shape == (M_ROWS,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if mode == "plain":    # (with declared-dead columns Q spans fewer)
        np.testing.assert_allclose(float(torch.sum(got * got)), v @ v,
                                   rtol=1e-12)
    # the port's own factor gives the same coefficients
    own = tq.qt_apply_cholqr(tq.cholqr_cpqr(tt(M), nsteps=N_COLS) if
                             mode == "plain" else tq.cholqr_cpqr(
        tt(M), nsteps=N_COLS - 2, col_live=tt(np.arange(N_COLS) >= 2)), tt(v))
    # (prefix energies: with leading dead columns the sign of a
    # coefficient is the noise sign of its row of R, see _same_factor)
    np.testing.assert_allclose(np.cumsum(own.numpy()[:N_COLS + 1] ** 2),
                               np.cumsum(want[:N_COLS + 1] ** 2), rtol=1e-9)


def test_qt_apply_from_projection_with_placeholder():
    """The elided form: M is a (0, n) placeholder, the projection and
    ||v||^2 come from the caller, and the embedding compacts to
    (n + 1,) with the same leading entries."""
    rng = np.random.default_rng(11)
    M = _j2_like()
    v = rng.normal(size=M_ROWS)
    G, y = M.T @ M, M.T @ v
    jf = _jchol_gram(jnp.asarray(G), jnp.asarray(y))
    want = np.asarray(jt.qt_apply_cholqr_from_projection(
        jf, jnp.asarray(y), jnp.asarray(v @ v)))
    assert want.shape == (N_COLS + 1,)
    tf = tq.cholqr_cpqr(torch.zeros((0, N_COLS), dtype=torch.float64),
                        nsteps=N_COLS, gram=tt(G), jtrx=tt(y))
    got = tq.qt_apply_cholqr_from_projection(tf, tt(y), tt(v @ v))
    assert got.shape == (N_COLS + 1,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    full = tq.qt_apply_cholqr(tq.cholqr_cpqr(tt(M), nsteps=N_COLS), tt(v))
    np.testing.assert_allclose(got.numpy(), full.numpy()[:N_COLS + 1],
                               atol=1e-9)
    # the reference's placeholder factor carried across gives the same
    carried = tq.qt_apply_cholqr_from_projection(to_port(jf), tt(y),
                                                 tt(v @ v))
    np.testing.assert_allclose(carried.numpy(), want, **TOL)


def test_tsqr_cpqr_matches_reference():
    """tests/test_tallqr.py::test_tall_cpqr_matches_direct's buffer: the
    thin QR + pivoted QR of R, by value (both sides call LAPACK's geqrf
    on the CPU, so even the signs of R's rows agree)."""
    M = _j2_like()
    jf = _jtsqr(jnp.asarray(M))
    tf = tq.tsqr_cpqr(tt(M), nsteps=N_COLS)
    assert tf.axis is None and tf.qloc.shape == (M_ROWS, N_COLS)
    _same_factor(tf, jf)
    np.testing.assert_allclose(tf.qloc.numpy(), np.asarray(jf.qloc), **TOL)
    v = np.random.default_rng(5).normal(size=M_ROWS)
    want = np.asarray(jt.qt_apply_tsqr(jf, jnp.asarray(v)))
    got = tq.qt_apply_tsqr(tf, tt(v))
    assert got.shape == (M_ROWS,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(torch.sum(got * got)), v @ v, rtol=1e-12)
    carried = to_port(jf)
    assert isinstance(carried, tq.TSQRF)
    np.testing.assert_allclose(tq.qt_apply_tsqr(carried, tt(v)).numpy(), want,
                               **TOL)


def test_tsqr_row_sharded_axis_is_not_implemented():
    """(Named when the row-sharded form raised NotImplementedError.)  It
    needs the ambient row scope of its axis, as the reference's needs an
    ambient mesh: without one it raises ValueError; on a one-rank row
    mesh it is the single-device factorization.  The multi-rank form is
    held in tests/test_torch_rowsharded.py."""
    from enlsip_tpu_torch import _dist
    M = tt(_j2_like())
    with pytest.raises(ValueError, match="ambient row mesh"):
        tq.tsqr_cpqr(M, nsteps=N_COLS, axis="rows")
    mesh = _dist.make_mesh(device="cpu", axis="rows")
    with _dist.row_scope(mesh):
        f = tq.tsqr_cpqr(M, nsteps=N_COLS, axis="rows")
    one = tq.tsqr_cpqr(M, nsteps=N_COLS)
    assert torch.equal(f.perm, one.perm) and torch.equal(f.R, one.R)


@pytest.mark.parametrize("kind", ["cholqr", "tsqr"])
def test_lane_axis_matches_single_factorizations(kind):
    """A (B, m, n) batch of tall buffers (plain tensor operations that
    batch natively) gives each lane its single factorization."""
    rng = np.random.default_rng(2)
    Ms = rng.normal(size=(3, 4096, 6))
    Ms[1, :, 4:] = 0.0
    Ms[2] = 0.0 if kind == "cholqr" else Ms[2]
    v = rng.normal(size=(3, 4096))
    nsteps = torch.tensor([6, 4, 6])
    if kind == "cholqr":
        fb = tq.cholqr_cpqr(tt(Ms), nsteps=nsteps)
        qb = tq.qt_apply_cholqr(fb, tt(v))
    else:
        fb = tq.tsqr_cpqr(tt(Ms), nsteps=nsteps)
        qb = tq.qt_apply_tsqr(fb, tt(v))
    assert fb.R.shape == (3, 6, 6) and fb.diag.shape == (3, 6)
    for b in range(3):
        if kind == "cholqr":
            f1 = tq.cholqr_cpqr(tt(Ms[b]), nsteps=int(nsteps[b]))
            q1 = tq.qt_apply_cholqr(f1, tt(v[b]))
        else:
            f1 = tq.tsqr_cpqr(tt(Ms[b]), nsteps=int(nsteps[b]))
            q1 = tq.qt_apply_tsqr(f1, tt(v[b]))
        assert torch.equal(fb.perm[b], f1.perm)
        np.testing.assert_allclose(fb.R[b].numpy(), f1.R.numpy(), atol=1e-10)
        np.testing.assert_allclose(qb[b].numpy()[:7], q1.numpy()[:7],
                                   atol=1e-10)
