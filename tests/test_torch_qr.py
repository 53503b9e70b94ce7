"""PyTorch port of ops/qr.py held against the JAX package on the same
numpy inputs (float64, CPU).  Tolerance: 1e-10 absolute on factor and
solve values (same arithmetic, other summation order); exact on
permutations and ranks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.ops import qr as jqr
from enlsip_tpu_torch.ops import qr as tqr

from torch_port_helpers import tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

ATOL = 1e-10


@pytest.mark.parametrize("shape", [(8, 5), (6, 6), (5, 9), (12, 7)])
def test_cpqr_oracle_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    M = rng.normal(size=shape)
    aug = rng.normal(size=(shape[0], 2))
    jr = jqr.cpqr(jnp.asarray(M), jnp.asarray(aug))
    tr = tqr.cpqr(tt(M), tt(aug))
    np.testing.assert_array_equal(tr.perm.numpy(), np.asarray(jr.perm))
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=ATOL)
    np.testing.assert_allclose(tr.qt_aug.numpy(), np.asarray(jr.qt_aug),
                               atol=ATOL)
    np.testing.assert_allclose(tr.diag.numpy(), np.asarray(jr.diag),
                               atol=ATOL)


def test_cpqr_oracle_masked_columns_and_nsteps():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(9, 7))
    M[:, 4:] = 0.0
    jr = jqr.cpqr(jnp.asarray(M), nsteps=4)
    tr = tqr.cpqr(tt(M), nsteps=4)
    np.testing.assert_array_equal(tr.perm.numpy(), np.asarray(jr.perm))
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=ATOL)
    assert tr.qt_aug is None and jr.qt_aug is None


@pytest.mark.parametrize("length", [0, 1, 3, 6])
@pytest.mark.parametrize("case", ["decay", "flat", "tiny_head", "gap"])
def test_pseudo_rank(length, case):
    diag = {"decay": [4.0, 1.0, 1e-3, 1e-9, 1e-12, 0.0],
            "flat": [2.0, -2.0, 2.0, 2.0, -2.0, 2.0],
            "tiny_head": [1e-9, 1e-9, 0.0, 0.0, 0.0, 0.0],
            "gap": [3.0, 1e-12, 2.0, 1.0, 0.5, 0.1]}[case]
    d = np.asarray(diag)
    eps_rank = float(np.sqrt(np.finfo(float).eps))
    want = int(jqr.pseudo_rank(jnp.asarray(d), jnp.int32(length), eps_rank))
    assert int(tqr.pseudo_rank(tt(d), length, eps_rank)) == want
    assert int(tqr.pseudo_rank(tt(d), torch.tensor(length), eps_rank)) == want


@pytest.mark.parametrize("k", [0, 1, 4, 6])
def test_masked_triangular_solves(k):
    rng = np.random.default_rng(k)
    R = np.triu(rng.normal(size=(6, 8))) + 3.0 * np.eye(6, 8)
    b = rng.normal(size=9)
    ju = jqr.solve_upper(jnp.asarray(R), jnp.asarray(b), jnp.int32(k))
    tu = tqr.solve_upper(tt(R), tt(b), k)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=ATOL)
    L = R[:, :6].T.copy()
    jl = jqr.solve_lower(jnp.asarray(L), jnp.asarray(b), jnp.int32(k))
    tl = tqr.solve_lower(tt(L), tt(b), torch.tensor(k))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert np.all(tu.numpy()[k:] == 0.0) and np.all(tl.numpy()[k:] == 0.0)


def test_invperm_and_prefix_reductions():
    rng = np.random.default_rng(7)
    perm = rng.permutation(11)
    np.testing.assert_array_equal(
        tqr.invperm(tt(perm)).numpy(),
        np.asarray(jqr.invperm(jnp.asarray(perm, jnp.int32))))
    v = rng.normal(size=11)
    for k in (0, 3, 11, 20):
        np.testing.assert_allclose(
            float(tqr.prefix_norm(tt(v), k)),
            float(jqr.prefix_norm(jnp.asarray(v), jnp.int32(k))), atol=1e-14)
        np.testing.assert_allclose(
            float(tqr.prefix_dot(tt(v), torch.tensor(k))),
            float(jqr.prefix_dot(jnp.asarray(v), jnp.int32(k))), atol=1e-14)
