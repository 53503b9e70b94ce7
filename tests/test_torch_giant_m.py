"""The giant-m slice as a whole (tall J, CholeskyQR, the factored
Jacobian and ``res_trial`` hooks) against the JAX package: float64, CPU,
m = 8192, n = 16 (the tall shape of tests/test_factored_jac.py), the
same numpy data on both sides.

The four configurations are the ones that reach the four fused kernels
on a card (here their plain versions run):

  a  factored hooks, second derivatives off  -> Gram only, JQ1 elided
  b  factored hooks, second derivatives on   -> row-scaled apply + Gram
  c  dense Jacobian                          -> apply + Gram
  d  dense Jacobian, tall_qr="qr"            -> apply, thin QR

Tolerances: p, y and the multipliers 1e-9 absolute; d 1e-9 up to one
sign per coefficient (with leading dead columns the stage-2 reflectors
sit on pivot entries that are zero up to rounding, so the sign of a row
of R — and of its d entry — is noise on both sides; the solves and
prefix norms every consumer takes do not change).  Whole solves: exit
code, iteration count and per-iteration (method code, t, rankA) exactly,
f 1e-8 relative per iteration, x 1e-8 relative at the end."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.core import driver as jdrv
from enlsip_tpu.core import subproblem as js
from enlsip_tpu.core import types as jtypes
from enlsip_tpu.ops.qr import pseudo_rank as jpseudo_rank
from enlsip_tpu_torch.core import driver as tdrv
from enlsip_tpu_torch.core import subproblem as ts
from enlsip_tpu_torch.core import types as ttypes
from enlsip_tpu_torch.ops.tsqr import CholQRF, TSQRF
from enlsip_tpu_torch.parallel import solve_batched
from enlsip_tpu_torch.problems.giant_m import giant_m, giant_m_from_arrays

from torch_port_helpers import F64, to_port, tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

ATOL = 1e-9
M, N, L = 8192, 16, 3
REL = float(np.sqrt(np.finfo(float).eps))
TOLS = (1e-10, REL, REL, REL, REL)
# name -> (factored hooks, second_derivatives, tall_qr)
CONFIGS = {"a": (True, False, "cholqr"), "b": (True, True, "cholqr"),
           "c": (False, False, "cholqr"), "d": (False, False, "qr")}


def _data(m=M, n=N, seed=0):
    """tests/test_factored_jac.py::_problem's draw."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(m, n)) / np.sqrt(n)
    xtrue = rng.normal(size=n)
    z = W @ xtrue
    Y = z + 0.1 * np.tanh(z) + 0.01 * rng.normal(size=m)
    return W, Y, xtrue, xtrue[:2] + 0.2


def _jax_functions(W, Y, blo, factored, with_trial=False):
    W, Y, blo = jnp.asarray(W), jnp.asarray(Y), jnp.asarray(blo)
    n = W.shape[1]

    def res(x):
        z = W @ x
        return Y - (z + 0.1 * jnp.tanh(z))

    def rowscale(x):
        return -(1.0 + 0.1 * (1.0 - jnp.tanh(W @ x) ** 2))

    def jac(x):
        return rowscale(x)[:, None] * W

    def res_trial(x, p):
        zx, zp = W @ x, W @ p
        return lambda a: Y - ((zx + a * zp) + 0.1 * jnp.tanh(zx + a * zp))

    def cons(x):
        return jnp.concatenate(
            [x[:2] - blo, jnp.array([float(n) * 4.0 - jnp.dot(x, x)])])

    kw = dict(res=res, cons=cons, jac_cons=jax.jacfwd(cons),
              res_trial=res_trial if with_trial else None)
    if factored:
        return jdrv.Functions(jac_res=None, jac_rowscale=rowscale,
                              jac_base=lambda: W, **kw)
    return jdrv.Functions(jac_res=jac, **kw)


@pytest.fixture(scope="module")
def problem():
    W, Y, xtrue, blo = _data()
    gm = giant_m_from_arrays(W, Y, xtrue, blo, L, F64, "cpu")
    return dict(W=W, Y=Y, blo=blo, gm=gm)


# ------------------------------------------------- GNSRCH and LEAEST

@pytest.fixture(scope="module")
def state(problem):
    """The reference's factorization chain at a point off the start,
    with the two bound constraints active."""
    W, Y, blo = problem["W"], problem["Y"], problem["blo"]
    x = np.random.default_rng(1).normal(size=N) * 0.3
    jf = _jax_functions(W, Y, blo, factored=True)
    jx = jnp.asarray(x)
    rx, s = jf.res(jx), jf.jac_rowscale(jx)
    cx, A = jf.cons(jx), jf.jac_cons(jx)
    dims = jtypes.Dims(N, M, 0, L)
    view = jtypes.working_view(jnp.asarray([True, True, False]))
    act = js.gather_active(A, cx, view, dims, False)
    gf = jnp.asarray(W).T @ (s * rx)
    F_A = js.factor_active(act, gf, view.t, dims)
    rankA = jpseudo_rank(F_A.diag, view.t, REL)
    return dict(rx=rx, s=s, J=s[:, None] * jnp.asarray(W), W=jnp.asarray(W),
                dims=dims, view=view, act=act, F_A=F_A, rankA=rankA,
                F_L11=js.zeros_factor_l11(dims, jnp.float64))


def _gn_both(state, factored, elide, tall_qr):
    s = state
    jJ = s["s"][:, None] if factored else s["J"]
    jgn = js.gn_search_direction(
        jJ, s["rx"], s["act"], s["F_A"], s["F_L11"], s["rankA"], s["view"].t,
        REL, s["dims"], None, None, tall_qr,
        jac_base=s["W"] if factored else None, elide_jq1=elide)
    tdims = ttypes.Dims(N, M, 0, L)
    base = tt(np.asarray(s["W"])) if factored else None
    tJ = tt(np.asarray(jJ))
    tgn = ts.gn_search_direction(
        tJ, tt(np.asarray(s["rx"])), to_port(s["act"]), to_port(s["F_A"]),
        to_port(s["F_L11"]), tt(int(s["rankA"])), tt(int(s["view"].t)), REL,
        tdims, None, tall_qr, base, elide)
    return jgn, tgn, tJ, base


@pytest.mark.parametrize("config", ["a", "b", "c", "d", "factored_qr"])
def test_gn_search_direction_and_second_mult_estimate(state, config):
    factored, second, tall_qr = CONFIGS.get(config, (True, True, "qr"))
    elide = factored and not second
    jgn, tgn, tJ, base = _gn_both(state, factored, elide, tall_qr)
    kind = TSQRF if tall_qr == "qr" else CholQRF
    assert isinstance(tgn.F_J2.f, kind)
    if elide:       # no (m, n) buffer anywhere in the result
        assert tgn.JQ1.shape == (0, N) and tgn.F_J2.f.M.shape == (0, N)
        assert tgn.d.shape == (N + 1,)
    else:
        assert tgn.JQ1.shape == (M, N) and tgn.d.shape == (M,)
        np.testing.assert_allclose(tgn.JQ1.numpy(), np.asarray(jgn.JQ1),
                                   atol=ATOL)
    assert int(tgn.rankA) == int(jgn.rankA) == 2
    assert int(tgn.rankJ2) == int(jgn.rankJ2) == N - 2
    np.testing.assert_array_equal(tgn.F_J2.perm.numpy(),
                                  np.asarray(jgn.F_J2.perm))
    np.testing.assert_allclose(tgn.p.numpy(), np.asarray(jgn.p), atol=ATOL)
    np.testing.assert_allclose(tgn.y.numpy(), np.asarray(jgn.y), atol=ATOL)
    np.testing.assert_allclose(tgn.b.numpy(), np.asarray(jgn.b), atol=ATOL)
    # d: leading coefficients up to their sign, then the complement norm
    dt, dj = tgn.d.numpy()[:N + 1], np.asarray(jgn.d)[:N + 1]
    np.testing.assert_allclose(np.abs(dt), np.abs(dj), atol=ATOL)
    np.testing.assert_allclose(float(torch.sum(tgn.d ** 2)),
                               float(jnp.sum(jgn.d ** 2)), rtol=1e-12)
    s = state
    jlam = js.second_mult_estimate(
        s["F_A"], jgn.JQ1, s["rx"], s["s"][:, None] if factored else s["J"],
        jgn.p, s["view"].t, s["act"], s["dims"], False, F_J2=jgn.F_J2,
        y_gn=jgn.y, jac_base=s["W"] if factored else None)
    tlam = ts.second_mult_estimate(
        to_port(s["F_A"]), tgn.JQ1, tt(np.asarray(s["rx"])), tJ, tgn.p,
        tt(int(s["view"].t)), to_port(s["act"]), ttypes.Dims(N, M, 0, L),
        False, F_J2=tgn.F_J2, y_gn=tgn.y, jac_base=base)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), atol=ATOL)
    assert float(np.abs(np.asarray(jlam)).max()) > 1e-3


def test_gram_branch_equals_streamed_branch(state):
    """Within the port: LEAEST and the d-vector through the kept Gram
    equal the materialized-v forms (no F_J2 / the direct transform)."""
    _, tgn, tJ, _ = _gn_both(state, False, False, "cholqr")
    s = state
    args = (to_port(s["F_A"]), tgn.JQ1, tt(np.asarray(s["rx"])), tJ, tgn.p,
            tt(int(s["view"].t)), to_port(s["act"]), ttypes.Dims(N, M, 0, L),
            False)
    gram = ts.second_mult_estimate(*args, F_J2=tgn.F_J2, y_gn=tgn.y)
    streamed = ts.second_mult_estimate(*args)
    np.testing.assert_allclose(gram.numpy(), streamed.numpy(), atol=ATOL)
    nog = tgn.F_J2._replace(f=tgn.F_J2.f._replace(G=None))
    p1n = torch.zeros(N, dtype=F64)
    p1n[:2] = tgn.y[:2]
    from enlsip_tpu_torch.ops.tsqr import qt_apply_cholqr
    v = -(tgn.JQ1 @ p1n) - tt(np.asarray(s["rx"]))
    np.testing.assert_allclose(
        ts.j2_transform_d(tgn.F_J2, tgn.JQ1, p1n,
                          tt(np.asarray(s["rx"]))).numpy()[:N + 1],
        qt_apply_cholqr(nog.f, v).numpy()[:N + 1], atol=ATOL)


# --------------------------------------------------------- whole solves

def _row(carry):
    prev = carry.prev
    return (int(prev.code), int(prev.t), int(prev.rankA),
            int(carry.exit_code), float(carry.rx @ carry.rx))


def _torch_solve(gm, config, with_trial=True, max_iter=25):
    factored, second, tall_qr = CONFIGS[config]
    fns = gm.factored if factored else gm.dense
    if not with_trial:
        fns = fns._replace(res_trial=None)
    rows = []
    res = tdrv.solve(fns, gm.x0, gm.dims,
                     ttypes.Options(second_derivatives=second,
                                    max_iter=max_iter, tall_qr=tall_qr),
                     ttypes.Tols(*(tt(v) for v in TOLS)), dtype=F64,
                     device="cpu", on_iteration=lambda c: rows.append(_row(c)))
    return rows, res


@pytest.fixture(scope="module")
def solves(problem):
    cache = {}

    def get(config):
        if config not in cache:
            cache[config] = _torch_solve(problem["gm"], config)
        return cache[config]

    return get


@pytest.mark.parametrize("config", list(CONFIGS))
def test_whole_solve_matches_reference(problem, solves, config):
    factored, second, tall_qr = CONFIGS[config]
    jf = _jax_functions(problem["W"], problem["Y"], problem["blo"], factored,
                        with_trial=factored)
    jd = jtypes.Dims(N, M, 0, L)
    jo = jtypes.Options(second_derivatives=second, max_iter=25,
                        tall_qr=tall_qr)
    jt = jtypes.Tols(*(jnp.float64(v) for v in TOLS))
    step = jax.jit(partial(jdrv.iterate_body, fns=jf, dims=jd, opts=jo,
                           tols=jt))
    carry = jdrv.init_carry(jf, jnp.zeros(N), jd, jo, jnp.float64)
    jrows = []
    while int(carry.exit_code) == 0 and len(jrows) < 30:
        carry = step(carry)
        jrows.append(_row(carry))
    trows, tres = solves(config)
    assert len(trows) == len(jrows), (trows, jrows)
    for k, (tr, jr) in enumerate(zip(trows, jrows)):
        assert tr[:4] == jr[:4], (config, k, tr, jr)   # code, t, rankA, exit
        np.testing.assert_allclose(tr[4], jr[4], rtol=1e-8,
                                   err_msg=f"{config}: f at {k}")
    assert tres.exit_code == int(carry.exit_code) > 0
    assert tres.n_iter == int(carry.nb_iter)
    assert (tres.counters.nb_jacres, tres.counters.nb_jaccons) == \
        (int(carry.counters.nb_jacres), int(carry.counters.nb_jaccons))
    assert abs(tres.counters.nb_res - int(carry.counters.nb_res)) <= 4
    jx = np.asarray(carry.x)
    np.testing.assert_allclose(tres.x.numpy(), jx, rtol=1e-8,
                               atol=1e-8 * float(np.abs(jx).max()))
    # the two bound constraints end active at their bounds
    assert int(carry.active_mask.sum()) >= 2
    np.testing.assert_allclose(tres.x.numpy()[:2], problem["blo"], atol=1e-7)


@pytest.mark.parametrize("config", ["b", "c", "d"])
def test_configurations_agree_within_the_port(solves, config):
    """Factored == dense, cholqr == qr: same exit class, iterations and
    solution (products reassociate, s (W v) against (s W) v, so
    rounding-close at float64, not equal bits)."""
    rows_a, res_a = solves("a")
    rows, res = solves(config)
    assert res.exit_code == res_a.exit_code and res.n_iter == res_a.n_iter
    assert [r[:3] for r in rows] == [r[:3] for r in rows_a]
    np.testing.assert_allclose(res.x.numpy(), res_a.x.numpy(), rtol=1e-8,
                               atol=1e-10)


def test_res_trial_hook_matches_black_box(problem, solves):
    """The directional residual factory against the black-box default:
    same trajectory; the residual counter follows the same contract (one
    bump per merit trial), and W (x + a p) against W x + a (W p) can flip
    a knife-edge trial, so it may differ by a few."""
    _, with_hook = solves("a")
    _, black_box = _torch_solve(problem["gm"], "a", with_trial=False)
    assert with_hook.exit_code == black_box.exit_code > 0
    assert with_hook.n_iter == black_box.n_iter
    assert abs(with_hook.counters.nb_res - black_box.counters.nb_res) <= 4
    np.testing.assert_allclose(with_hook.x.numpy(), black_box.x.numpy(),
                               atol=1e-8)


def test_short_problem_takes_the_dense_path(problem):
    """m = 200, n = 10 is not tall: the factored hooks work there too
    (plain chain, direct CPQR) and agree with the dense Jacobian
    (tests/test_factored_jac.py's second shape)."""
    gm = giant_m_from_arrays(*_data(200, 10), 3, F64, "cpu")
    out = {}
    for config in ("a", "b", "c"):
        out[config] = _torch_solve(gm, config)[1]
        assert out[config].exit_code > 0
    for config in ("b", "c"):
        assert out[config].n_iter == out["a"].n_iter
        np.testing.assert_allclose(out[config].x.numpy(), out["a"].x.numpy(),
                                   rtol=1e-8, atol=1e-10)


# --------------------------------------------------------------- batches

def test_init_batch_rejects_the_factored_hook(problem):
    gm = problem["gm"]
    with pytest.raises(ValueError, match="single-solve"):
        solve_batched(gm.factored, np.zeros((4, N)), gm.dims,
                      ttypes.Options(), ttypes.Tols.for_dtype(F64), dtype=F64,
                      device="cpu")


@pytest.mark.parametrize("with_trial", [False, True])
def test_two_tall_lanes_agree_with_their_single_solves(with_trial):
    """Tall lanes in ``solve_batched`` take the lane-generic CholeskyQR
    branch (plain chain: the kernels serve 2-D J only).  Per lane: exit
    code, iterations and Jacobian counters equal the single solve's,
    x within 1e-8 (as tests/test_torch_batch.py holds a lane against
    ``core_solve``); with ``res_trial`` mapped over the lanes too."""
    gm = giant_m_from_arrays(*_data(4096, 8, seed=4), 3, F64, "cpu")
    fns = gm.dense._replace(
        res_trial=gm.factored.res_trial if with_trial else None)
    opts = ttypes.Options(second_derivatives=False, max_iter=25)
    tols = ttypes.Tols.for_dtype(F64)
    starts = 0.2 * np.random.default_rng(2).normal(size=(2, 8))
    starts[0] = 0.0
    res = solve_batched(fns, starts, gm.dims, opts, tols, dtype=F64,
                        device="cpu")
    for b in range(2):
        one = tdrv.solve(fns, tt(starts[b]), gm.dims, opts, tols, dtype=F64,
                         device="cpu")
        assert int(res.exit_code[b]) == one.exit_code > 0
        assert int(res.n_iter[b]) == one.n_iter
        assert int(res.counters.nb_jacres[b]) == one.counters.nb_jacres
        assert abs(int(res.counters.nb_res[b]) - one.counters.nb_res) <= 4
        np.testing.assert_allclose(res.x[b].numpy(), one.x.numpy(), rtol=1e-8,
                                   atol=1e-10)


# ------------------------------------------------------------ the problem

def test_giant_m_draws_its_data_on_the_device():
    """``giant_m`` at a small size on the CPU: shapes, the constraint
    layout of the benchmark (l = 50: 5 cutting bounds, 44 slack bounds,
    one ball), analytic Jacobians against autodiff, and the hooks
    against the dense callables."""
    gm = giant_m(m=4096, n=60, l=50, seed=3, dtype=F64, device="cpu")
    assert gm.dims == ttypes.Dims(n=60, m=4096, q=0, l=50)
    assert gm.W.shape == (4096, 60) and gm.Y.shape == (4096,)
    again = giant_m(m=4096, n=60, l=50, seed=3, dtype=F64, device="cpu")
    assert torch.equal(gm.W, again.W) and torch.equal(gm.Y, again.Y)
    x = torch.tensor(np.random.default_rng(0).normal(size=60) * 0.3)
    p = torch.tensor(np.random.default_rng(1).normal(size=60))
    c = gm.dense.cons(x)
    assert c.shape == (50,)
    np.testing.assert_allclose(c[:5].numpy(), (x[:5] - gm.blo).numpy())
    np.testing.assert_allclose(c[5:49].numpy(), (x[5:49] + 5.0).numpy())
    np.testing.assert_allclose(float(c[49]), 240.0 - float(x @ x))
    np.testing.assert_allclose(
        gm.dense.jac_cons(x).numpy(),
        torch.func.jacfwd(gm.dense.cons)(x).numpy(), atol=1e-12)
    J = gm.dense.jac_res(x)
    np.testing.assert_allclose(
        J.numpy(), torch.func.jacfwd(gm.dense.res)(x).numpy(), atol=1e-12)
    np.testing.assert_allclose(
        (gm.factored.jac_rowscale(x)[:, None] * gm.factored.jac_base()).numpy(),
        J.numpy(), atol=1e-14)
    a = torch.tensor(0.37)
    np.testing.assert_allclose(gm.factored.res_trial(x, p)(a).numpy(),
                               gm.dense.res(x + a * p).numpy(), atol=1e-12)
    with pytest.raises(RuntimeError, match="CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA device present: nothing to check")
        giant_m(m=4096, n=8, l=6)
