"""The port's sharded solves device-resident (``graph=True``) on gloo
ranks on the CPU, float64: the CPU rehearsal of the code a CUDA graph
captures (every read-back outside the control-flow helpers forbidden),
against the eager sharded loops (``graph=False``), the one-process
solves and the JAX package.

One spawn of four ranks (``torch_dist_cases.py``, suite ``graph``) runs
every case at D = 2 (ranks {0, 1} and {2, 3}) and D = 4:

* ``solve_batched_sharded`` (HS65, B = 8), ``solve_batched_sharded_mp``
  (``check_every`` 1 and 3) and ``solve_suite_fused(mesh=)`` (five
  families x 4): x, exit codes, iterations and trips equal to the bit to
  the eager sharded path, one read-back a solve;
* ``solve_rowsharded`` on tests/test_rowsharded.py's problem (the
  distributed pivot loop, ``tsqr=True``) and on the tall factored
  problem (8192 x 16): x, f, exit code and iterations equal to the bit
  to the eager loop, exactly one read-back a solve on every rank;
* the refusals: ``on_iteration`` with ``graph=True``, and a gloo group
  with tensors off the CPU (a meta device stands in for the card);
* the row-sharded pivot loop at kmax >= 192 (``LARGE_QR``), which must
  take the reference's downdated-norm panel loop.

The JAX side is compiled three times: the sharded HS65 batch, the dense
row-sharded problem and the 400 x 200 pivoted QR."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.core.types import Dims as JDims, Options as JOptions, \
    Tols as JTols
from enlsip_tpu.ops.blocked_qr import cpqr_blocked as j_cpqr_blocked
from enlsip_tpu.parallel import batch_mesh as j_batch_mesh
from enlsip_tpu.parallel import solve_batched_sharded as j_solve_sharded
import enlsip_tpu_torch as et
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.ops.blocked_qr import CPQRF, q_apply
from enlsip_tpu_torch.parallel import solve_batched

import torch_dist_cases as cases
from test_torch_rowsharded import jax_dense  # noqa: F401  (a fixture)
from torch_port_helpers import F64, computed_once, hs65_batch_setup
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

REL = float(np.sqrt(np.finfo(float).eps))
MESHES = [2, 4]
BATCH_CASES = ["hs65", "mp_every1", "mp_every3"]
ROW_PROBLEMS = ["dense", "tsqr", "factored"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return computed_once(tmp_path_factory, "ranks_graph",
                         lambda: cases.spawn_ranks(
                             "graph", 4, tmp_path_factory.mktemp("ranks")))


def _ranks_of(D):
    return [[0, 1], [2, 3]] if D == 2 else [[0, 1, 2, 3]]


def _batch_key(case, D, graph):
    if case.startswith("mp_"):
        return f"mp_D{D}_graph{graph}_{case[3:]}"
    return f"{case}_D{D}_graph{graph}"


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("case", BATCH_CASES)
def test_batch_graph_equals_eager_to_the_bit(ranks, D, case):
    """Every rank's global result and trip count from the rehearsal equal
    the eager sharded loop's to the bit; the rehearsal reads back once."""
    for r in range(4):
        g = ranks[r][_batch_key(case, D, True)]
        e = ranks[r][_batch_key(case, D, False)]
        for field in ("exit_code", "x", "f", "n_iter"):
            assert torch.equal(g[field], e[field]), (r, field)
        assert g["trips"] == e["trips"] > 0
        assert g["readbacks"] == 1, g["readbacks"]
        first = ranks[r - r % D][_batch_key(case, D, True)]
        assert torch.equal(first["x"], g["x"])


@pytest.mark.parametrize("D", MESHES)
def test_suite_graph_equals_eager_to_the_bit(ranks, D):
    for r in range(4):
        g, e = ranks[r][f"suite_D{D}_graphTrue"], \
            ranks[r][f"suite_D{D}_graphFalse"]
        assert set(g) == set(cases.SUITE_FAMILIES)
        for name in g:
            for field in ("exit_code", "x", "f", "n_iter"):
                assert torch.equal(g[name][field], e[name][field]), \
                    (r, name, field)


@pytest.fixture(scope="module")
def jax_hs65(eight_devices, tmp_path_factory):
    def solve():
        jtols = JTols(*(jnp.float64(v) for v in (1e-10, REL, REL, REL, REL)))
        jf, _, starts, dims = hs65_batch_setup(8, seed=1)
        np.testing.assert_array_equal(starts, cases.hs65_starts(8, 1))
        return j_solve_sharded(jf, starts, JDims(*dims), JOptions(), jtols,
                               mesh=j_batch_mesh(eight_devices))
    return computed_once(tmp_path_factory, "sharded_graph_jax_hs65", solve)


@pytest.mark.parametrize("D", MESHES)
def test_batch_graph_matches_jax_and_one_process(ranks, jax_hs65, D):
    """The rehearsal against the JAX package's sharded solve (codes and
    iterations equal, x within 1e-8 relative, as test_torch_sharding.py)
    and the port's one-process batch (x within 1e-12)."""
    got = ranks[0][f"hs65_D{D}_graphTrue"]
    np.testing.assert_array_equal(got["exit_code"].numpy(),
                                  np.asarray(jax_hs65.exit_code))
    np.testing.assert_array_equal(got["n_iter"].numpy(),
                                  np.asarray(jax_hs65.n_iter))
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(jax_hs65.x),
                               rtol=1e-8)
    one = solve_batched(cases.hs65_functions(), cases.hs65_starts(8, 1),
                        Dims(*cases.HS65_DIMS), Options(),
                        Tols.for_dtype(F64), dtype=F64, device="cpu")
    assert torch.equal(got["exit_code"], one.exit_code)
    assert torch.equal(got["n_iter"], one.n_iter)
    np.testing.assert_allclose(got["x"].numpy(), one.x.numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("problem", ROW_PROBLEMS)
def test_rows_graph_equals_eager_with_one_readback(ranks, D, problem):
    """The row-sharded rehearsal equals the eager loop to the bit on every
    rank, and every rank's result equals its group's first; the solve
    reads back exactly once (the exit code and the iteration count,
    ``solve_rowsharded.last``), where the eager loop reads back many times
    an iteration."""
    for group in _ranks_of(D):
        first = ranks[group[0]][f"rows_{problem}_D{D}_graphTrue"]
        for r in group:
            g = ranks[r][f"rows_{problem}_D{D}_graphTrue"]
            e = ranks[r][f"rows_{problem}_D{D}_graphFalse"]
            assert torch.equal(g["x"], e["x"]) and torch.equal(g["f"], e["f"])
            assert torch.equal(g["x"], first["x"])
            assert (g["exit_code"], g["n_iter"]) == \
                (e["exit_code"], e["n_iter"])
            assert g["exit_code"] > 0
            assert g["readbacks"] == 1, g["readbacks"]
            assert e["readbacks"] > 5 * e["n_iter"], e["readbacks"]
            assert g["last"] == (g["exit_code"], g["n_iter"])


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("problem", ["dense", "tsqr"])
def test_rows_graph_matches_jax_dense(ranks, jax_dense, D,  # noqa: F811
                                      problem):
    got = ranks[0][f"rows_{problem}_D{D}_graphTrue"]
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(jax_dense.x),
                               atol=1e-9)
    assert got["n_iter"] == jax_dense.n_iter


@pytest.mark.parametrize("D", MESHES)
def test_rows_graph_factored_matches_one_device(ranks, D):
    res = et.core_solve(*cases.tall_solve_args("factored"), device="cpu")
    got = ranks[0][f"rows_factored_D{D}_graphTrue"]
    assert (got["exit_code"], got["n_iter"]) == (res.exit_code, res.n_iter)
    assert res.exit_code == 10000
    np.testing.assert_allclose(got["x"].numpy(), res.x.numpy(), atol=1e-9)
    np.testing.assert_allclose(float(got["f"]), res.f, rtol=1e-12)


@pytest.mark.parametrize("D", MESHES)
def test_device_resident_refusals(ranks, D):
    """graph=True never switches by itself: ``on_iteration`` (the host
    each iteration) raises, and a gloo group with tensors off the CPU
    raises at the collective inside a device-resident solve and at the
    sharded entry points."""
    for r in range(4):
        rows, batch = ranks[r][f"refusals_rows_D{D}"], \
            ranks[r][f"refusals_batch_D{D}"]
        assert "on_iteration" in rows["on_iteration"]
        assert "graph=False" in rows["gloo_off_cpu"]
        assert "graph=False" in batch["gloo_off_cpu_sharded"]
        assert batch["gloo_collective_device_resident"].startswith(
            "RuntimeError") and "gloo" in \
            batch["gloo_collective_device_resident"]


@pytest.fixture(scope="module")
def jax_large_qr(tmp_path_factory):
    def factor():
        f = j_cpqr_blocked(jnp.asarray(cases.large_qr_matrix()))
        return {k: np.asarray(getattr(f, k)) for k in ("perm", "R", "diag")}
    return computed_once(tmp_path_factory, "sharded_graph_jax_large_qr",
                         factor)


@pytest.mark.parametrize("D", MESHES)
def test_large_pivot_loop_takes_downdated_norms(ranks, jax_large_qr, D):
    """At kmax = 200 >= 192 the reference's sharded ``cpqr_blocked`` is the
    downdated-norm panel loop: its perm puts column 7 second, where exact
    norms pick column 5 (``LARGE_QR``).  The row-sharded pivot loop gives
    the same perm, R's diagonal magnitudes within 1e-12 relative and a
    reconstruction Q [R; 0] = M[:, perm] within 1e-14 ||M||, run
    device-resident on every rank."""
    M = cases.large_qr_matrix()
    m, n = M.shape
    assert list(jax_large_qr["perm"][:2]) == [0, 7]
    for group in _ranks_of(D):
        got = [ranks[r][f"large_qr_D{D}"] for r in group]
        for res in got:
            np.testing.assert_array_equal(res["perm"].numpy(),
                                          jax_large_qr["perm"])
            np.testing.assert_allclose(
                np.abs(np.diagonal(res["R"].numpy())),
                np.abs(jax_large_qr["diag"]), rtol=1e-12)
            assert torch.equal(res["R"], got[0]["R"])
        first = got[0]
        V = torch.cat([g["V"] for g in got])
        f = CPQRF(R=first["R"], perm=first["perm"], V=V, tau=first["tau"],
                  T=first["T"], diag=torch.diagonal(first["R"]))
        QR = q_apply(f, torch.cat([first["R"], first["R"].new_zeros(
            (m - n, n))]))
        err = float(torch.linalg.norm(QR - torch.tensor(M)[:, first["perm"]]))
        assert err <= 1e-14 * float(np.linalg.norm(M)), err


@pytest.mark.parametrize("variant", ["dense", "tsqr_qr"])
def test_captured_branch_merges_keep_the_row_factorizations(monkeypatch,
                                                            variant):
    """On the card every 0-d branch of a captured solve computes both
    sides (one IF node each) and merges them by select, which the CPU
    rehearsal (one side read off its flag) never does.  Here the
    captured forms of ``_lanes.cond`` / ``while_loop`` run on the CPU
    (both IF bodies run, a WHILE body while its flag holds) through a
    row-sharded solve whose factorizations carry static leaves — the
    distributed pivot loop's mesh, the row-sharded TSQR's axis name — on a
    one-rank mesh without a process group: the merge passes them through
    and the solve equals the eager one to the bit."""
    import dataclasses

    from enlsip_tpu_torch import _graph
    from enlsip_tpu_torch._device import flag_value
    from enlsip_tpu_torch._dist import Mesh
    from enlsip_tpu_torch.parallel import solve_rowsharded
    fns, dims, opts, tols = cases.rows_problem()
    tsqr = variant == "tsqr_qr"
    if tsqr:
        opts = dataclasses.replace(opts, tall_qr="qr")
    mesh = Mesh(None, 1, 0, torch.device("cpu"), "rows")
    x0 = torch.zeros(cases.ROWS_N, dtype=F64)

    def solve():
        return solve_rowsharded(fns, x0, dims, opts, tols, mesh=mesh,
                                tsqr=tsqr, graph=False)

    eager = solve()

    def while_body(pred, trip):
        while flag_value(pred):
            pred = trip()

    def count_launch(fn, attr="launches"):
        setattr(fn, attr, getattr(fn, attr) + 1)

    monkeypatch.setattr(_graph, "capturing", lambda: True)
    monkeypatch.setattr(_graph, "if_body", lambda pred, fn: fn())
    monkeypatch.setattr(_graph, "while_body", while_body)
    monkeypatch.setattr(_graph, "count_launch", count_launch)
    merged = solve()
    assert (int(merged.exit_code), int(merged.nb_iter)) == \
        (int(eager.exit_code), int(eager.nb_iter))
    assert int(eager.exit_code) > 0
    assert torch.equal(merged.x, eager.x)
