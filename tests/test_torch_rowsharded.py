"""The row-sharded giant-m solve of the port (``parallel/rowsharded.py``)
on gloo ranks on the CPU, float64, against the JAX package's dense solve
and the port's own one-device solve.

One spawn of four ranks (``torch_dist_cases.py``) runs every rank-side
case at D = 2 (ranks {0, 1} and {2, 3}) and D = 4:

* the problem of tests/test_rowsharded.py (N = 8, M = 512, L = 4) with
  the distributed pivot loop (``tsqr=False``), ``tsqr=True`` (CholeskyQR
  over the ranks, as the reference takes it with the default
  ``tall_qr``) and ``tsqr=True, tall_qr="qr"`` (the TSQR of the ranks'
  blocks).  Against the JAX dense ``core_solve``: x within the JAX
  test's bounds (``assert_allclose(atol=1e-9)``), the iteration count
  equal (one JAX compile);
* the tall giant-m problem at 8192 x 16 (dense J on the ``cholqr`` and
  ``qr`` routes, the factored Jacobian with and without second
  derivatives), each rank drawing its rows with ``giant_m(shard=)``;
  at D = 2 each 4096-row block takes the fused WY form, at D = 4 the
  chain of products;
* ``tsqr_cpqr(axis=)``, the row-sharded CholeskyQR and the distributed
  pivot loop against the direct pivoted QR;
* every solver function that contracts the rows (WEIGHT, GNSRCH, NEWTON,
  STPLNG) on each rank's rows against the same function on all rows.

Every solve's per-iteration trace (method code, t, rankA) equals the
port's one-device solve, and every rank's x, f, exit code and iteration
count are equal to the bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enlsip_tpu as ej
import enlsip_tpu_torch as et
from enlsip_tpu.core.driver import Functions as JFunctions
from enlsip_tpu.core.types import Dims as JDims, Options as JOptions, \
    Tols as JTols
from enlsip_tpu_torch.ops.blocked_qr import cpqr_blocked, qt_apply

import torch_dist_cases as cases
from torch_port_helpers import computed_once
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

MESHES = [2, 4]
VARIANTS = ["tsqrFalse", "tsqrTrue", "tsqr_qr"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return computed_once(tmp_path_factory, "ranks_rows",
                         lambda: cases.spawn_ranks(
                             "rows", 4, tmp_path_factory.mktemp("ranks")))


def _ranks_of(D):
    return [[0, 1], [2, 3]] if D == 2 else [[0, 1, 2, 3]]


def _one_device(fns, x0, dims, opts, tols):
    trace = []
    res = et.core_solve(fns, x0, dims, opts, tols, device="cpu",
                        on_iteration=lambda c: trace.append(
                            cases.trace_of(c)))
    return res, trace


@pytest.fixture(scope="module")
def jax_dense(tmp_path_factory):
    """The JAX package's dense solve of tests/test_rowsharded.py's
    problem (the same numpy draws as ``cases.rows_problem``), once a run
    (``test_torch_sharded_graph.py`` takes it too)."""
    return computed_once(tmp_path_factory, "rowsharded_jax_dense",
                         _jax_dense_solve)


def _jax_dense_solve():
    rng = np.random.default_rng(0)
    T = np.linspace(0.0, 1.0, cases.ROWS_M)
    W = jnp.asarray(rng.normal(size=(cases.ROWS_M, cases.ROWS_N))
                    / np.sqrt(cases.ROWS_N))
    Y = jnp.asarray(np.sin(3 * T) + 0.1 * rng.normal(size=cases.ROWS_M))
    L = cases.ROWS_L

    def res(x):
        z = W @ x
        return Y - (z + 0.1 * jnp.tanh(z))

    def ineq(x):
        return jnp.concatenate([x[:L - 1] + 1.0,
                                jnp.array([4.0 - jnp.dot(x, x)])])

    import jax
    rel = float(np.sqrt(np.finfo(float).eps))
    return ej.core_solve(
        JFunctions(res=res, jac_res=jax.jacfwd(res), cons=ineq,
                   jac_cons=jax.jacfwd(ineq)),
        jnp.zeros(cases.ROWS_N), JDims(cases.ROWS_N, cases.ROWS_M, 0, L),
        JOptions(second_derivatives=False, max_iter=30),
        JTols(*(jnp.float64(v) for v in (1e-10, rel, rel, rel, rel))))


@pytest.fixture(scope="module")
def one_device():
    import dataclasses
    fns, dims, opts, tols = cases.rows_problem()
    x0 = torch.zeros(cases.ROWS_N, dtype=torch.float64)
    out = {v: _one_device(fns, x0, dims, opts, tols) for v in VARIANTS[:2]}
    out["tsqr_qr"] = _one_device(fns, x0, dims,
                                 dataclasses.replace(opts, tall_qr="qr"),
                                 tols)
    for case in cases.TALL_CASES:
        out[case] = _one_device(*cases.tall_solve_args(case))
    return out


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_rowsharded_matches_jax_dense(ranks, jax_dense, D, variant):
    got = ranks[0][f"rows_D{D}_{variant}"]
    assert jax_dense.exit_code > 0 and got["exit_code"] > 0
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(jax_dense.x),
                               atol=1e-9)
    assert got["n_iter"] == jax_dense.n_iter


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("variant", VARIANTS + list(cases.TALL_CASES))
def test_trace_matches_one_device(ranks, one_device, D, variant):
    key = f"rows_D{D}_{variant}" if variant in VARIANTS \
        else f"tall_{variant}_D{D}"
    got = ranks[0][key]
    res, trace = one_device["tsqrFalse" if variant == "tsqrTrue"
                            else variant]
    assert got["trace"] == trace
    assert (got["exit_code"], got["n_iter"]) == (res.exit_code, res.n_iter)
    np.testing.assert_allclose(got["x"].numpy(), res.x.numpy(), atol=1e-9)
    np.testing.assert_allclose(float(got["f"]), res.f, rtol=1e-12)
    if variant in cases.TALL_CASES:
        assert res.exit_code == 10000
        assert int(got["active"].sum()) >= 2


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("variant", VARIANTS + list(cases.TALL_CASES))
def test_every_rank_agrees_to_the_bit(ranks, D, variant):
    key = f"rows_D{D}_{variant}" if variant in VARIANTS \
        else f"tall_{variant}_D{D}"
    for group in _ranks_of(D):
        first = ranks[group[0]][key]
        for r in group[1:]:
            got = ranks[r][key]
            assert torch.equal(got["x"], first["x"]), (key, r)
            assert torch.equal(got["f"], first["f"]), (key, r)
            assert (got["exit_code"], got["n_iter"], got["trace"]) == \
                (first["exit_code"], first["n_iter"], first["trace"])


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("form", ["tsqr", "pivot_loop", "cholqr"])
def test_sharded_factorization_matches_direct(ranks, D, form):
    """R, perm and diag of the row-sharded factorizations match the
    direct CPQR up to row signs; Q^T v agrees on the leading entries
    and in norm (as tests/test_rowsharded.py holds the JAX TSQR)."""
    rng = np.random.default_rng(1)
    M = torch.tensor(rng.normal(size=(256, 8)))
    v = torch.tensor(rng.normal(size=256))
    direct = cpqr_blocked(M, nsteps=8, device="cpu")
    d_direct = qt_apply(direct, v)
    for r in range(4):
        got = ranks[r][f"{form}_D{D}"]
        assert torch.equal(got["perm"], direct.perm)
        np.testing.assert_allclose(got["R"].abs().numpy(),
                                   direct.R.abs().numpy(), atol=1e-10)
        assert got["d"].shape == (8 * (D if form == "tsqr" else 1) + 1,)
        np.testing.assert_allclose(got["d"][:8].abs().numpy(),
                                   d_direct[:8].abs().numpy(), atol=1e-10)
        np.testing.assert_allclose(float(torch.sum(got["d"] ** 2)),
                                   float(v @ v), rtol=1e-12)


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("kind", ["weights", "gn", "newton", "steplength"])
def test_row_contractions_match_unsharded(ranks, D, kind):
    """Every function of the solver that contracts the residual rows, run
    on each rank's rows inside the row scope, against the same function
    on all rows: WEIGHT (both norms, 12 random states), GNSRCH (the
    pivot loop and the two-stage form), NEWTON and STPLNG end to end (the
    six states of tests/test_torch_linesearch.py, both signs of p, both
    method codes) agree to 1e-12 relative, counts and codes exactly."""
    for r in range(4):
        got = {k: v for k, v in ranks[r][f"units_D{D}"].items()
               if k.startswith(kind + "_")}
        assert got, kind
        bad = {k: v for k, v in got.items() if not v <= 1e-12}
        assert not bad, (r, bad)


@pytest.mark.parametrize("D", MESHES)
def test_tsqr_needs_fewer_collectives_than_the_pivot_loop(ranks, D):
    """The pivot loop takes two collectives a pivot step, the two-stage
    forms one a factorization."""
    loop = ranks[0][f"rows_D{D}_tsqrFalse"]
    for variant in ("tsqrTrue", "tsqr_qr"):
        two = ranks[0][f"rows_D{D}_{variant}"]
        assert two["n_iter"] == loop["n_iter"]
        assert two["collectives"] < loop["collectives"], (variant, two,
                                                          loop)
