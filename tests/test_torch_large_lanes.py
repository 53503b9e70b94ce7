"""Batches of large problems in the PyTorch port against the JAX package
(float64, CPU), and the batched factorization's route rule.

* A batched factorization with min(rows, cols) >= 192 pivots on
  downdated norms with NB-column panels on the CPU, as the JAX package's
  ``vmap`` of ``cpqr_blocked`` does there: the 400 x 200 matrix whose
  exact and downdated pivot orders differ, stacked twice, gives JAX's
  perm, |diag R| within 1e-12 relative, and reconstructs M[:, perm] to
  1e-14 ||M|| on every lane.
* Chained Rosenbrock's hand-written Jacobians are built out of place, so
  ``torch.func.vmap`` lifts them onto a batch; the lifted values equal
  the per-lane calls and the JAX problem's.
* ``solve_batched`` of Chained Rosenbrock n=200 on 2 lanes (kmax 198 >=
  192) against ``enlsip_tpu.parallel.solve_batched`` from the same numpy
  starts: exit codes and iterations equal, x within 1e-8 relative.
* ``batched_route`` at the edges of its gates on both device types.
* ``cpqr_hopper_lanes`` equal to per-lane ``cpqr_hopper`` calls: on the
  CPU (the plain version) and, marked ``gpu``, on the card to the bit,
  by the resident and the panel route.
* ``cpqr_blocked.cuda_rank1`` counts the rank-1 routes' calls on a CUDA
  tensor only (the card's half marked ``gpu``).

Two JAX compiles of the factorization and one of the batched solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enlsip_tpu as ej
import problems as jprob
from enlsip_tpu.core.driver import Functions as JFunctions
from enlsip_tpu.core.types import Dims as JDims, Options as JOptions, \
    Tols as JTols
from enlsip_tpu.models.model import _model_functions as j_model_functions
from enlsip_tpu.ops.blocked_qr import cpqr_blocked as j_cpqr_blocked
from enlsip_tpu.parallel import solve_batched as j_solve_batched

import enlsip_tpu_torch as et
from enlsip_tpu_torch.core.types import Dims, Options, Tols
from enlsip_tpu_torch.models.model import _model_functions
from enlsip_tpu_torch.ops import blocked_qr as tb
from enlsip_tpu_torch.ops import cpqr_hopper as ch
from enlsip_tpu_torch.parallel import solve_batched
from enlsip_tpu_torch.problems.classic import chained_rosenbrock

from torch_dist_cases import large_qr_matrix
from torch_port_helpers import CPU, F64, computed_once, tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

REL = float(np.sqrt(np.finfo(float).eps))


def _lanes_reconstruction(f, M):
    """max over lanes of ||Q R - M[:, perm]|| / ||M|| of a batched CPQRF."""
    lanes, rows, cols = M.shape
    RR = torch.zeros_like(M)
    RR[:, :f.R.shape[-2]] = f.R
    Mp = torch.gather(M, 2, f.perm[:, None, :].expand(lanes, rows, cols))
    err = torch.linalg.norm(tb.q_apply(f, RR) - Mp, dim=(-2, -1))
    return float((err / torch.linalg.norm(M, dim=(-2, -1))).max())


# --------------------------------------------------------------- C7

@pytest.mark.parametrize("nsteps", [None, (200, 160)],
                         ids=["all_steps", "per_lane_steps"])
def test_c7_batched_large_factorization_takes_downdated_norms(nsteps):
    M = np.stack([large_qr_matrix()] * 2)
    if nsteps is None:
        jf = jax.vmap(j_cpqr_blocked)(jnp.asarray(M))
        f = tb.cpqr_blocked(tt(M), device="cpu")
    else:
        jf = jax.vmap(lambda m, k: j_cpqr_blocked(m, nsteps=k))(
            jnp.asarray(M), jnp.asarray(nsteps, jnp.int32))
        f = tb.cpqr_blocked(tt(M), nsteps=torch.tensor(nsteps), device="cpu")
    # one lane's perm at the head: [0, 7, 179, 142] by downdated norms
    # ([0, 5, 7, 179] by exact ones)
    np.testing.assert_array_equal(f.perm.numpy(), np.asarray(jf.perm))
    assert f.perm[:, :4].tolist() == [[0, 7, 179, 142]] * 2
    assert tuple(f.T.shape) == tuple(jf.T.shape) == (2, 2, 128, 128)
    np.testing.assert_allclose(np.abs(f.diag.numpy()),
                               np.abs(np.asarray(jf.diag)), rtol=1e-12)
    # R reconstructs M[:, perm] on the lanes that factor every column
    whole = [b for b in range(2) if nsteps is None or nsteps[b] == 200]
    assert _lanes_reconstruction(type(f)(*(t[whole] for t in f)),
                                 tt(M[whole])) <= 1e-14


def test_lane_panels_equal_each_lane_alone():
    """The lanes' panel loop is the 2-D panel loop of each lane."""
    rng = np.random.default_rng(4)
    M = tt(rng.normal(size=(3, 230, 196)))
    ns = torch.tensor([196, 130, 0])
    f = tb.cpqr_blocked(M, nsteps=ns, device="cpu")
    for b in range(3):
        one = tb.cpqr_blocked(M[b], nsteps=int(ns[b]), device="cpu")
        for name in one._fields:
            assert torch.equal(getattr(f, name)[b], getattr(one, name)), name


# --------------------------------------------------------------- C9

def test_c9_chained_rosenbrock_jacobians_take_vmap():
    n = 10
    kw, jkw = chained_rosenbrock(n), jprob.chained_rosenbrock(n)
    x = np.random.default_rng(2).normal(size=(3, n))
    for key in ("jacobian_residuals", "jacobian_eqcons"):
        fn = kw[key]
        lifted = torch.func.vmap(fn)(tt(x))
        for b in range(3):
            one = fn(tt(x[b]))
            np.testing.assert_allclose(lifted[b].numpy(), one.numpy(),
                                       rtol=1e-15, atol=0)
            np.testing.assert_allclose(one.numpy(),
                                       np.asarray(jkw[key](jnp.asarray(x[b]))),
                                       rtol=1e-14, atol=1e-14)


# ------------------------------------------- a batch of large problems

@pytest.fixture(scope="module")
def cr200_batches(tmp_path_factory):
    return computed_once(tmp_path_factory, "large_lanes_cr200",
                         _cr200_batches)


def _cr200_batches():
    n, B = 200, 2
    kw = jprob.chained_rosenbrock(n)
    jmodel = ej.CnlsModel(**kw)
    jf = JFunctions(*j_model_functions(jmodel, jnp.float64))
    rng = np.random.default_rng(0)
    x0 = np.asarray(kw["starting_point"], float)
    starts = x0[None, :] + 0.1 * rng.normal(size=(B, n))
    dims = (n, 2 * (n - 1), n - 2, n - 2)
    jtols = JTols(*(jnp.float64(v) for v in (1e-10, REL, REL, REL, REL)))
    jres = j_solve_batched(jf, starts, JDims(*dims), JOptions(), jtols)
    tf = et.Functions(*_model_functions(
        et.CnlsModel(**chained_rosenbrock(n)), F64, CPU))
    calls = {"panels": 0}
    panels = tb._cpqr_xla_panels_lanes

    def counted(*a):
        calls["panels"] += 1
        return panels(*a)

    mp = pytest.MonkeyPatch()
    mp.setattr(tb, "_cpqr_xla_panels_lanes", counted)
    try:
        tres = solve_batched(tf, starts, Dims(*dims), Options(),
                             Tols.for_dtype(F64), dtype=F64, device="cpu")
    finally:
        mp.undo()
    return jres, tres, calls["panels"]


def test_cr200_batch_matches_jax(cr200_batches):
    jres, tres, _ = cr200_batches
    np.testing.assert_array_equal(tres.exit_code.numpy(),
                                  np.asarray(jres.exit_code))
    np.testing.assert_array_equal(tres.n_iter.numpy(), np.asarray(jres.n_iter))
    assert (tres.exit_code > 0).all()
    jx = np.asarray(jres.x)
    assert np.linalg.norm(tres.x.numpy() - jx) <= 1e-8 * np.linalg.norm(jx)
    np.testing.assert_allclose(tres.f.numpy(), np.asarray(jres.f), rtol=1e-12)


def test_cr200_batch_factors_on_the_panel_route(cr200_batches):
    """A_act^T (200 x 198) and J2 (398 x 200) of every lane take the
    panel loop: the batched rank-1 loop never sees kmax >= 192."""
    assert cr200_batches[2] >= 2 * int(cr200_batches[1].n_iter.max())


# --------------------------------------------------------- route rule

ROUTE_EDGES = [
    # rows, cols, cpu, cuda
    (32, 64, "b2", "b2"),            # kmax 32, rows * cols 2048
    (64, 32, "b2", "b2"),
    (33, 62, "rank1", "rank1"),      # kmax 33 inside 2048 elements
    (2, 1024, "b2", "b2"),           # 2048 elements
    (3, 683, "rank1", "rank1"),      # 2049 elements
    (191, 400, "rank1", "rank1"),    # kmax 191
    (400, 191, "rank1", "rank1"),
    (192, 400, "panels", "b1_lanes"),  # kmax 192
    (400, 192, "panels", "b1_lanes"),
    (1998, 1000, "panels", "b1_lanes"),
]


@pytest.mark.parametrize("rows,cols,cpu,cuda", ROUTE_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_batched_route_at_its_edges(rows, cols, cpu, cuda, dtype):
    assert tb.batched_route(rows, cols, dtype, "cpu") == cpu
    assert tb.batched_route(rows, cols, dtype, "cuda") == cuda


def test_batched_route_refuses_what_no_route_takes():
    with pytest.raises(TypeError):
        tb.batched_route(200, 200, torch.float16, "cuda")
    with pytest.raises(ValueError):
        tb.batched_route(200, 200, torch.float32, "mps")


# ---------------------------------------------------- the lane wrapper

def _lane_inputs(device):
    rng = np.random.default_rng(6)
    M = tt(rng.normal(size=(3, 257, 193))).to(device)
    ns = torch.tensor([193, 60, 0], dtype=torch.int32, device=device)
    return M, ns


def test_lane_wrapper_is_the_plain_version_a_lane_on_the_cpu():
    M, ns = _lane_inputs("cpu")
    before = ch.cpqr_hopper_lanes.launches
    got = ch.cpqr_hopper_lanes(M, ns)
    assert ch.cpqr_hopper_lanes.launches == before
    for b in range(3):
        for a, w in zip(got, tb.cpqr_packed_plain(M[b], int(ns[b]))):
            assert torch.equal(a[b], w)
    f = tb.unpack_packed(*got)
    assert tuple(f.T.shape) == (3, 2, 128, 128)
    for b in range(3):
        one = tb.unpack_packed(*(t[b] for t in got))
        for name in one._fields:
            assert torch.equal(getattr(f, name)[b], getattr(one, name)), name


@pytest.mark.gpu
def test_lane_wrapper_equals_single_calls_on_the_card():
    """Needs the card and nvcc (``pytest -m gpu``): every lane's launch
    gives the bits of a single call, by the resident route and by the
    panel route (a batch too large for shared memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    M, ns = _lane_inputs("cuda")
    rng = np.random.default_rng(7)
    big = tt(rng.normal(size=(2, 3000, 2600))).cuda()
    for batch, steps, route in ((M, ns, "resident"),
                                (big, torch.tensor([40, 7], dtype=torch.int32,
                                                   device="cuda"), "panels")):
        got = ch.cpqr_hopper_lanes(batch, steps)
        assert ch.cpqr_hopper_lanes.last_route == route
        for b in range(batch.shape[0]):
            one = ch.cpqr_hopper(batch[b], steps[b])
            assert ch.cpqr_hopper.last_route == route
            for a, w in zip(got, one):
                assert torch.equal(a[b], w)


# ------------------------------------------ rank-1 routes on the card

def _route_inputs(device):
    """One matrix a route of ``cpqr_blocked``: batched rank-1 (kmax 40),
    single rank-1, B2's gate, B1 a lane, B1."""
    rng = np.random.default_rng(8)
    return [tt(rng.normal(size=shape)).to(device)
            for shape in ((2, 60, 40), (60, 40), (2, 8, 6), (2, 257, 193),
                          (257, 193))]


def test_rank1_routes_count_only_cuda_tensors():
    counts = tb.cpqr_blocked.cuda_rank1
    before = dict(counts)
    for M in _route_inputs("cpu"):
        tb.cpqr_blocked(M, device="cpu")
    assert counts == before


@pytest.mark.gpu
def test_rank1_routes_are_counted_on_the_card():
    """Needs the card and nvcc (``pytest -m gpu``): the dispatch counts
    each rank-1 route's calls on a CUDA tensor, the batch's and the
    single matrix's, and no other route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    counts = tb.cpqr_blocked.cuda_rank1
    before = dict(counts)
    for M in _route_inputs("cuda"):
        tb.cpqr_blocked(M, device="cuda")
    assert counts == {"lanes": before["lanes"] + 1,
                      "single": before["single"] + 1}
