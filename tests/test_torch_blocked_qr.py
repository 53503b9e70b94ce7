"""PyTorch port of ops/blocked_qr.py against the JAX package (float64,
CPU, same numpy inputs).  Tolerance 1e-10 absolute on R, V, tau, T and
applied vectors; exact on perm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.ops import blocked_qr as jb
from enlsip_tpu_torch.ops import blocked_qr as tb
from enlsip_tpu_torch.testing import assert_tree_close

from torch_port_helpers import ref_tree, tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

ATOL = 1e-10


def _compare(tf, jf):
    np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))
    assert_tree_close(tf, ref_tree(jf), ATOL, skip=("perm",), what="CPQRF")


@pytest.mark.parametrize("k", [0, 2, 6])
@pytest.mark.parametrize("kind", ["random", "zero_tail", "negative_head"])
def test_householder_col(k, kind):
    rng = np.random.default_rng(k)
    col = rng.normal(size=7)
    if kind == "zero_tail":
        col[k:] = 0.0
    if kind == "negative_head":
        col[k] = -abs(col[k]) - 1.0
    jv, jtau, jbeta = jb._householder_col(jnp.asarray(col), jnp.int32(k))
    tv, ttau, tbeta = tb._householder_col(tt(col), k)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-14)
    np.testing.assert_allclose(float(ttau), float(jtau), atol=1e-14)
    np.testing.assert_allclose(float(tbeta), float(jbeta), atol=1e-14)


@pytest.mark.parametrize("shape", [(16, 12), (33, 20), (24, 40), (9, 9),
                                   (150, 130)])
def test_rank1_loop_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    M = rng.normal(size=shape)
    _compare(tb._cpqr_xla(tt(M), tb.NB, None),
             jb._cpqr_xla(jnp.asarray(M), jb.NB, None))


@pytest.mark.parametrize("nsteps", [0, 1, 9, 14])
def test_rank1_loop_nsteps_on_masked_buffer(nsteps):
    rng = np.random.default_rng(1)
    M = rng.normal(size=(20, 14))
    M[:, nsteps:] = 0.0
    _compare(tb._cpqr_xla(tt(M), tb.NB, torch.tensor(nsteps)),
             jb._cpqr_xla(jnp.asarray(M), jb.NB, jnp.int32(nsteps)))


@pytest.mark.parametrize("shape,nsteps", [((260, 200), None),
                                          ((200, 230), None),
                                          ((260, 200), 140)])
def test_panel_loop_matches_reference(shape, nsteps):
    rng = np.random.default_rng(5)
    M = rng.normal(size=shape)
    if nsteps is not None:
        M[:, nsteps:] = 0.0
    jn = None if nsteps is None else jnp.int32(nsteps)
    _compare(tb._cpqr_xla_panels(tt(M), tb.NB, nsteps),
             jb._cpqr_xla_panels(jnp.asarray(M), jb.NB, jn))


def test_dispatch_on_cpu_follows_reference():
    """kmax >= 192 -> panels, else the rank-1 loop, exactly as the JAX
    package dispatches on the CPU."""
    rng = np.random.default_rng(11)
    big, small = rng.normal(size=(210, 196)), rng.normal(size=(40, 30))
    _compare(tb.cpqr_blocked(tt(big), device="cpu"),
             jb.cpqr_blocked(jnp.asarray(big)))
    _compare(tb.cpqr_blocked(tt(small), nsteps=30, device="cpu"),
             jb.cpqr_blocked(jnp.asarray(small), nsteps=jnp.int32(30)))


def test_input_matrix_is_not_modified():
    rng = np.random.default_rng(2)
    A = tt(rng.normal(size=(6, 9)))
    keep = A.clone()
    tb.cpqr_blocked(A.t(), device="cpu")      # transposed view of A
    assert torch.equal(A, keep)


@pytest.mark.parametrize("shape", [(33, 20), (150, 140)])
def test_q_applications(shape):
    rng = np.random.default_rng(9)
    M = rng.normal(size=shape)
    jf = jb.cpqr_blocked(jnp.asarray(M))
    tf = tb.cpqr_blocked(tt(M), device="cpu")
    x = rng.normal(size=shape[0])
    X = rng.normal(size=(shape[0], 3))
    J = rng.normal(size=(5, shape[0]))
    for name, a in [("qt_apply", x), ("qt_apply", X), ("q_apply", x),
                    ("q_apply", X)]:
        np.testing.assert_allclose(
            getattr(tb, name)(tf, tt(a)).numpy(),
            np.asarray(getattr(jb, name)(jf, jnp.asarray(a))), atol=ATOL)
    np.testing.assert_allclose(tb.right_q_apply(tf, tt(J)).numpy(),
                               np.asarray(jb.right_q_apply(jf, jnp.asarray(J))),
                               atol=ATOL)
    # and Q is orthogonal and reproduces M
    Q = tb.q_apply(tf, torch.eye(shape[0], dtype=torch.float64)).numpy()
    R = np.zeros(shape)
    R[:min(shape)] = tf.R.numpy()
    np.testing.assert_allclose(Q @ R, M[:, tf.perm.numpy()], atol=ATOL)
