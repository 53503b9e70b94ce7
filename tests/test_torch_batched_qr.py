"""The batched tiny-matrix CPQR module (ops/cpqr_batched_hopper.py) on
the CPU.

The CUDA kernel cannot run here; its plain PyTorch version — which the
wrapper takes only for a CPU tensor — is held against the Pallas kernel
it replaces, run in interpret mode at float32 (atol 5e-5, perm equal:
the tolerance of tests/test_pallas_batched_qr.py), against the vmapped
JAX loop at float64 (1e-10, perm equal), and against the port's own
single rank-1 loop lane by lane.  ``chip_smoke.py`` holds the kernel
itself against the plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.ops import pallas_batched_qr as pbq
from enlsip_tpu.ops.blocked_qr import cpqr_blocked as j_cpqr_blocked
from enlsip_tpu_torch.ops import blocked_qr as tb
from enlsip_tpu_torch.ops import cpqr_batched_hopper as cb
from enlsip_tpu_torch.testing import assert_tree_close

from torch_port_helpers import ref_tree, tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

SHAPES = [(3, 7, 2), (7, 3, 3), (16, 20, 9), (5, 5, 5)]
B = 9


def _batch(rows, cols, live, seed=0, batch=B):
    M = np.random.default_rng(seed).normal(size=(batch, rows, cols))
    M[:, :, live:] = 0.0
    return M


@pytest.mark.parametrize("rows,cols,live", SHAPES)
def test_plain_version_matches_pallas_kernel_f32(rows, cols, live):
    M = _batch(rows, cols, live).astype(np.float32)
    jp, jtau, jperm = pbq.cpqr_batched_packed(jnp.asarray(M), interpret=True)
    packed, tau, perm = cb.cpqr_batched_packed(torch.tensor(M))
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(packed.numpy(), np.asarray(jp), atol=5e-5)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), atol=5e-5)


@pytest.mark.parametrize("rows,cols,live", SHAPES)
def test_batched_cpqrf_matches_pallas_cpqrf_f32(rows, cols, live):
    M = _batch(rows, cols, live).astype(np.float32)
    jf = pbq.cpqr_blocked_batched(jnp.asarray(M), interpret=True)
    tf = cb.cpqr_blocked_batched(torch.tensor(M), device="cpu")
    np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))
    for name in ("R", "V", "tau", "T", "diag"):
        np.testing.assert_allclose(getattr(tf, name).numpy(),
                                   np.asarray(getattr(jf, name)), atol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("rows,cols,live", SHAPES)
def test_matches_vmapped_jax_loop_f64(rows, cols, live):
    M = _batch(rows, cols, live)
    ns = jnp.full((B,), live, jnp.int32)
    jf = jax.vmap(lambda m, n: j_cpqr_blocked(m, nsteps=n))(jnp.asarray(M), ns)
    tf = tb.cpqr_blocked(tt(M), device="cpu")
    np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))
    assert_tree_close(tf, ref_tree(jf), 1e-10, skip=("perm",))


@pytest.mark.parametrize("rows,cols,live", SHAPES + [(40, 10, 10)])
def test_each_lane_equals_the_single_rank1_loop(rows, cols, live):
    """All kmax steps on a masked buffer == the single loop with that
    lane's own ``nsteps`` (the steps past it are exact no-ops)."""
    M = tt(_batch(rows, cols, live, seed=3))
    lives = [live, max(live - 1, 0), live, 0, live, 1, live, live, live]
    for b, nb_live in enumerate(lives):
        M[b, :, nb_live:] = 0.0
    f = tb.cpqr_blocked(M, device="cpu")
    for b, nb_live in enumerate(lives):
        g = tb._cpqr_xla(M[b], tb.NB, nb_live)
        assert torch.equal(f.perm[b], g.perm)
        for name in ("R", "V", "tau", "diag"):
            assert float((getattr(f, name)[b] - getattr(g, name)).abs().max()) \
                <= 1e-12, name
        assert float((f.T[b] - g.T).abs().max()) <= 1e-12


def test_batch_of_one_and_all_zero_lane():
    M = tt(_batch(6, 5, 5, seed=4, batch=1))
    f = tb.cpqr_blocked(M, device="cpu")
    g = tb._cpqr_xla(M[0], tb.NB, None)
    assert torch.equal(f.perm[0], g.perm)
    assert float((f.R[0] - g.R).abs().max()) <= 1e-12
    Z = tt(_batch(6, 5, 5, seed=5, batch=3))
    Z[1] = 0.0
    packed, tau, perm = cb.cpqr_batched_packed(Z)
    assert torch.equal(perm[1], torch.arange(5))
    assert float(packed[1].abs().max()) == 0.0 and float(tau[1].abs().max()) == 0.0
    assert bool(torch.isfinite(packed).all())


@pytest.mark.parametrize("view", ["contiguous", "transposed", "permuted"])
def test_input_is_not_modified(view):
    """Also when ``M`` is a permuted view, whose contiguous form can be
    the caller's own storage."""
    rng = np.random.default_rng(6)
    if view == "contiguous":
        M = tt(rng.normal(size=(4, 6, 5)))
    elif view == "transposed":
        M = tt(rng.normal(size=(4, 5, 6))).transpose(1, 2)
    else:
        M = tt(rng.normal(size=(5, 6, 4))).permute(2, 1, 0)
    before = M.clone()
    cb.cpqr_batched_packed(M)
    cb.cpqr_batched_packed_plain(M)
    tb.cpqr_blocked(M, device="cpu")
    assert torch.equal(M, before)


def test_beyond_the_gate_runs_the_masked_rank1_loop():
    """(70, 40) is past rows*cols <= 2048: the batched rank-1 loop with
    the per-lane step count as a mask; the kernel's wrapper rejects it."""
    M = tt(_batch(70, 40, 17, seed=7, batch=3))
    ns = torch.tensor([17, 5, 0])
    for b in range(3):
        M[b, :, int(ns[b]):] = 0.0
    f = tb.cpqr_blocked(M, nsteps=ns, device="cpu")
    for b in range(3):
        g = tb._cpqr_xla(M[b], tb.NB, int(ns[b]))
        assert torch.equal(f.perm[b], g.perm)
        assert float((f.R[b] - g.R).abs().max()) <= 1e-12
        assert float((f.tau[b] - g.tau[:40]).abs().max()) <= 1e-12
    assert not cb.in_gate(70, 40)


@pytest.mark.parametrize("shape", [(64, 64), (2048, 2)])
def test_gate_rejects(shape):
    with pytest.raises(ValueError, match="rows \\* cols|min\\(rows"):
        cb.cpqr_batched_packed(torch.zeros((2, *shape), dtype=torch.float64))


def test_wrapper_rejects_bad_input_and_counts_no_cpu_launch():
    with pytest.raises(TypeError):
        cb.cpqr_batched_packed(torch.zeros((2, 3, 3), dtype=torch.float16))
    with pytest.raises(ValueError):
        cb.cpqr_batched_packed(torch.zeros((3, 3), dtype=torch.float64))
    before = cb.cpqr_batched_packed.launches
    cb.cpqr_batched_packed(torch.ones((2, 3, 3), dtype=torch.float64))
    assert cb.cpqr_batched_packed.launches == before
    with pytest.raises(RuntimeError, match="CUDA device"):
        cb.cpqr_blocked_batched(torch.ones((2, 3, 3)))


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Needs the card and nvcc (run with ``pytest -m gpu``);
    ``chip_smoke.py`` makes the same comparison at the batched path's
    shapes.  Also on a transposed view, as ``factor_active`` hands over
    A_act^T: the kernel reads it in place through its strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    storage = tt(_batch(20, 16, 20, batch=513)).cuda()
    for M in (tt(_batch(16, 20, 9, batch=513)).cuda(),
              storage.transpose(-1, -2)):
        before = cb.cpqr_batched_packed.launches
        packed, tau, perm = cb.cpqr_batched_packed(M)
        assert cb.cpqr_batched_packed.launches == before + 1
        pp, ptau, pperm = cb.cpqr_batched_packed_plain(M)
        assert torch.equal(perm, pperm)
        assert float((packed - pp).abs().max()) <= 1e-9 * float(pp.abs().max())
        assert float((tau - ptau).abs().max()) <= 1e-9
        again = cb.cpqr_batched_packed(M)
        assert all(torch.equal(a, b) for a, b in zip((packed, tau, perm), again))
