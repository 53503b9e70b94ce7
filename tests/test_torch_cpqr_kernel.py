"""The Hopper CPQR kernel's module (ops/cpqr_hopper.py) on the CPU.

The CUDA kernel cannot run here; its plain PyTorch version — which the
wrapper takes only for a CPU tensor — is held against the Pallas kernel
it replaces, run in interpret mode, and against the JAX rank-1 loop, on
the shapes of tests/test_pallas_qr2.py plus the masked-``nsteps`` case.
Tolerance 1e-10 absolute (as tests/test_pallas_qr2.py), perm exact.
``chip_smoke.py`` holds the kernel itself against the plain version on
the card."""

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


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Needs the card and nvcc (run with ``pytest -m gpu``);
    ``chip_smoke.py`` makes the same comparison at the main path's
    shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    M = tt(np.random.default_rng(0).normal(size=(257, 193))).cuda()
    Bt, tau, perm = ch.cpqr_hopper(M, 193)
    Pt, ptau, pperm = tb.cpqr_packed_plain(M, 193)
    assert torch.equal(perm, pperm)
    assert float((Bt - Pt).abs().max()) <= 1e-9 * float(Pt.abs().max())
    assert float((tau - ptau).abs().max()) <= 1e-9
