"""Batch-sharded solves of the port (``parallel/sharding.py``) on gloo
ranks on the CPU, float64, against the JAX package's
``solve_batched_sharded`` on the 8-device CPU mesh and against the
port's own one-process solves.

One spawn of four ranks (``torch_dist_cases.py``) runs every rank-side
case: D = 2 (ranks {0, 1} and {2, 3}) and D = 4, HS65 with B = 8 and
B = 10 (padded to a multiple of D), ``solve_batched_sharded_mp`` with
each rank passing its own lanes, and the five-family fused and bucketed
suites with ``mesh=``.  Against the port's one-process solves: exit
codes and iteration counts equal, x within 1e-12.  Against JAX: exit
codes and iteration counts equal, x within 1e-8 relative, the bound
tests/test_torch_batch.py holds the unsharded batch to (the two packages'
last line searches run on a merit flat to rounding, so their x differ by
~2e-9 with or without sharding).  Every rank of a mesh returns the same
global result to the bit.  Two JAX compiles (B = 8, B = 10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.core.types import Dims as JDims, Options as JOptions, \
    Tols as JTols
from enlsip_tpu.parallel import batch_mesh as j_batch_mesh
from enlsip_tpu.parallel import solve_batched_sharded as j_solve_sharded
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.parallel import (batch_mesh, fuse_families,
                                       hs_scenario_batch, solve_batched,
                                       solve_batched_sharded,
                                       solve_suite_batched, solve_suite_fused)

import torch_dist_cases as cases
from torch_port_helpers import F64, computed_once, hs65_batch_setup
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

REL = float(np.sqrt(np.finfo(float).eps))
X_ATOL = 1e-12
BATCHES = [(8, 1), (10, 2)]
MESHES = [2, 4]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return computed_once(tmp_path_factory, "ranks_sharding",
                         lambda: cases.spawn_ranks(
                             "sharding", 4, tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def jax_sharded(eight_devices, tmp_path_factory):
    def solve():
        jtols = JTols(*(jnp.float64(v) for v in (1e-10, REL, REL, REL, REL)))
        out = {}
        for B, seed in BATCHES:
            jf, _, starts, dims = hs65_batch_setup(B, seed=seed)
            np.testing.assert_array_equal(starts, cases.hs65_starts(B, seed))
            out[B] = j_solve_sharded(jf, starts, JDims(*dims), JOptions(),
                                     jtols, mesh=j_batch_mesh(eight_devices))
        return out
    return computed_once(tmp_path_factory, "sharding_jax_sharded", solve)


def _ranks_of(D):
    return [[0, 1], [2, 3]] if D == 2 else [[0, 1, 2, 3]]


def _hold(got, want_codes, want_x, want_iter, **tol):
    np.testing.assert_array_equal(got["exit_code"].numpy(),
                                  np.asarray(want_codes))
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want_x),
                               **(tol or dict(rtol=0, atol=X_ATOL)))
    np.testing.assert_array_equal(got["n_iter"].numpy(),
                                  np.asarray(want_iter))


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("B", [b for b, _ in BATCHES])
def test_sharded_hs65_matches_jax(ranks, jax_sharded, B, D):
    got, want = ranks[0][f"hs65_B{B}_D{D}"], jax_sharded[B]
    assert got["x"].shape == (B, 3)
    assert (got["exit_code"] > 0).all()
    _hold(got, want.exit_code, want.x, want.n_iter, rtol=1e-8)


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("B", [b for b, _ in BATCHES])
def test_sharded_hs65_matches_one_process(ranks, B, D):
    seed = dict(BATCHES)[B]
    one = solve_batched(cases.hs65_functions(), cases.hs65_starts(B, seed),
                        Dims(*cases.HS65_DIMS), Options(),
                        Tols.for_dtype(F64), dtype=F64, device="cpu")
    _hold(ranks[0][f"hs65_B{B}_D{D}"], one.exit_code, one.x, one.n_iter)


@pytest.mark.parametrize("key", [f"hs65_B{B}_D{D}" for B, _ in BATCHES
                                 for D in MESHES]
                         + [f"mp_D{D}_every{k}" for D in MESHES
                            for k in (1, 3)])
def test_every_rank_returns_the_global_result_to_the_bit(ranks, key):
    D = int(key.split("_D")[1].split("_")[0])
    for group in _ranks_of(D):
        first = ranks[group[0]][key]
        for r in group[1:]:
            for field in ("exit_code", "x", "f", "n_iter"):
                assert torch.equal(ranks[r][key][field], first[field]), \
                    (key, r, field)
    if key.startswith("hs65"):
        # one check a trip and the last one, then one gather a field
        trips = first["trips"]
        assert all(ranks[r][key]["trips"] == trips for r in range(4))
        assert first["collectives"] == trips + 1 + 8, first["collectives"]


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("every", [1, 3])
def test_process_local_lanes_give_the_sharded_result(ranks, D, every):
    """``solve_batched_sharded_mp`` (each rank passes its own lanes, the
    convergence checked every ``every`` trips) equals the sharded solve
    of the same lanes to the bit; ``local_lanes`` and
    ``global_from_process_local`` invert each other."""
    base = ranks[0][f"hs65_B8_D{D}"]
    starts = torch.as_tensor(cases.hs65_starts(8, 1))
    per = 8 // D
    for r in range(4):
        mp = ranks[r][f"mp_D{D}_every{every}"]
        for field in ("exit_code", "x", "n_iter"):
            assert torch.equal(mp[field], base[field]), (r, field)
        lo = (r % D) * per
        assert torch.equal(mp["mine"], starts[lo:lo + per])
        assert torch.equal(mp["local_x"], base["x"][lo:lo + per])
        assert torch.equal(mp["regathered"]["x0"], starts)


@pytest.fixture(scope="module")
def unsharded_suites():
    fams = hs_scenario_batch(cases.SUITE_FAMILIES, per_family=4, seed=1,
                             device="cpu")
    opts = Options(max_iter=60, second_derivatives=False)
    return (solve_suite_fused(fams, opts, Tols.for_dtype, dtype=F64,
                              fused=fuse_families(fams, "cpu"),
                              device="cpu"),
            solve_suite_batched(fams, opts, Tols.for_dtype, dtype=F64,
                                device="cpu"))


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("kind", ["fused", "bucketed"])
def test_suites_with_mesh_match_unsharded(ranks, unsharded_suites, D, kind):
    want = unsharded_suites[0 if kind == "fused" else 1]
    got = ranks[0][f"suite_D{D}"][kind]
    assert set(got) == set(cases.SUITE_FAMILIES)
    for name, res in want.items():
        _hold(got[name], res.exit_code, res.x, res.n_iter)
    for r in range(1, 4):
        for name in want:
            assert torch.equal(ranks[r][f"suite_D{D}"][kind][name]["x"],
                               got[name]["x"])


def test_mesh_escalation_raises_and_one_rank_mesh_runs_unsharded():
    """Without a process group the mesh has one rank: the sharded entry
    point solves the whole batch here, to the bit of ``solve_batched``;
    ``escalate_f64`` with a mesh raises the reference's ValueError."""
    mesh = batch_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    fns, dims = cases.hs65_functions(), Dims(*cases.HS65_DIMS)
    starts = cases.hs65_starts(5, 3)
    one = solve_batched(fns, starts, dims, Options(), Tols.for_dtype(F64),
                        dtype=F64, device="cpu")
    sh = solve_batched_sharded(fns, starts, dims, Options(),
                               Tols.for_dtype(F64), mesh=mesh, dtype=F64)
    assert torch.equal(sh.x, one.x) and torch.equal(sh.exit_code,
                                                    one.exit_code)
    fams = hs_scenario_batch(["hs65"], per_family=2, device="cpu")
    with pytest.raises(ValueError, match="escalate_f64"):
        solve_suite_fused(fams, Options(), Tols.for_dtype, mesh=mesh,
                          escalate_f64=True)


@pytest.mark.gpu
def test_two_ranks_sharing_the_card(tmp_path):
    """Needs the card and nvcc (run with ``pytest -m gpu``): two gloo
    ranks on the one card split HS65 x 512 at float64; each rank launched
    the batched kernel and never its plain version, and the ranks' lanes
    equal the one-process solve of all 512 lanes on the card to the bit
    (a lane's arithmetic does not depend on how many lanes share its
    batch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batched kernel has no CPU mode")
    got = cases.spawn_ranks("card", 2, tmp_path)
    one = solve_batched(cases.hs65_functions("cuda"),
                        cases.hs65_starts(cases.CARD_LANES, 4),
                        Dims(*cases.HS65_DIMS), Options(),
                        Tols.for_dtype(F64, "cuda"), dtype=F64)
    for mine in got:
        assert mine["launches"] > 0 and mine["rank1_lanes"] == 0, mine
        assert torch.equal(mine["x"], one.x.cpu())
        assert torch.equal(mine["exit_code"], one.exit_code.cpu())
