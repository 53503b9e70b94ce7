"""PyTorch port of core/direction.py against the JAX package (float64,
CPU).  Decisions (method codes, dimensions) compare exactly; direction
vectors at 1e-9 absolute."""

import jax.numpy as jnp
import numpy as np
import pytest

from enlsip_tpu.core import direction as jdir
from enlsip_tpu.core import subproblem as js
from enlsip_tpu.core import types as jtypes
from enlsip_tpu.ops.qr import pseudo_rank as jpseudo_rank
from enlsip_tpu_torch.core import direction as tdir
from enlsip_tpu_torch.core import types as ttypes

from torch_port_helpers import to_port, tt, twin_functions
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

ATOL = 1e-9
EPS_RANK = float(np.sqrt(np.finfo(float).eps))


def _prev(rng, n, l, code=None):
    f = lambda: float(rng.uniform(0.0, 2.0))
    vals = dict(
        x=rng.normal(size=n), rx_sum=f(), cx_sum=f(),
        t=int(rng.integers(0, l + 1)), alpha=float(rng.choice([0.01, 0.5, 1.0])),
        beta=f(), code=int(rng.choice([1, -1, 2]) if code is None else code),
        w=rng.uniform(0.1, 1.0, l), progress=f(), predicted_reduction=f(),
        rankA=int(rng.integers(0, 3)), rankJ2=int(rng.integers(0, 4)),
        dimA=int(rng.integers(-2, 3)), dimJ2=int(rng.integers(-3, 4)))
    jp = jtypes.PrevIter(**{k: (jnp.int32(v) if isinstance(v, int)
                                else jnp.asarray(v)) for k, v in vals.items()})
    return jp, to_port(jp)


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("seed", range(25))
def test_check_gn_direction(seed, scaling):
    rng = np.random.default_rng(seed)
    n, m, q, l = 5, int(rng.choice([3, 8])), 1, 6
    t = int(rng.integers(q, n + 1))
    rankA = int(rng.integers(max(t - 1, 0), t + 1))
    jp, tp = _prev(rng, n, l)
    sc = [float(rng.uniform(0, 3)) for _ in range(5)]
    lam = rng.normal(size=l)
    valid = np.arange(l) < t
    ds = rng.uniform(0.5, 2.0, l)
    flags = [bool(rng.random() < 0.3) for _ in range(3)]
    it = int(rng.integers(0, 3))
    cmin = float(rng.choice([0.05, 1.0, np.inf]))
    jc, jb = jdir.check_gn_direction(
        *[jnp.asarray(v) for v in sc], jnp.int32(it), jnp.int32(rankA),
        jtypes.Dims(n, m, q, l), *[jnp.asarray(v) for v in flags],
        jnp.int32(t), jnp.asarray(lam), jnp.asarray(valid), jnp.asarray(cmin),
        jp, scaling, jnp.asarray(ds))
    tc, tbeta = tdir.check_gn_direction(
        *[tt(v) for v in sc], it, tt(rankA), ttypes.Dims(n, m, q, l),
        *flags, tt(t), tt(lam), tt(valid), tt(cmin), tp, scaling, tt(ds))
    assert int(tc) == int(jc)
    np.testing.assert_allclose(float(tbeta), float(jb), atol=1e-14)


@pytest.mark.parametrize("seed", range(20))
def test_determine_solving_dim(seed):
    rng = np.random.default_rng(seed)
    C = 7
    rank = int(rng.integers(0, C + 1))
    prev_dim = int(rng.integers(-1, C + 1))
    diagR = np.sort(np.abs(rng.normal(size=C)))[::-1] * rng.choice([1, -1], C)
    y = rng.normal(size=C + 2) * (10.0 ** -rng.integers(0, 4, C + 2))
    sc = [float(rng.uniform(0, 2)) for _ in range(3)]
    alpha = float(rng.choice([0.05, 0.5, 1.0]))
    restart = bool(seed % 4 == 0)
    want = jdir.determine_solving_dim(
        jnp.int32(prev_dim), jnp.int32(rank), *[jnp.asarray(v) for v in sc],
        jnp.asarray(diagR), jnp.asarray(y), jnp.asarray(alpha),
        jnp.asarray(restart))
    got = tdir.determine_solving_dim(
        tt(prev_dim), tt(rank), *[tt(v) for v in sc], tt(diagR), tt(y),
        tt(alpha), restart)
    assert int(got) == int(want)


def _analysis_state(seed, dup_eq=False):
    jf, tf, x0, (n, m, q, l) = twin_functions(seed, 5, 8, 3, 2, dup_eq=dup_eq)
    jd, td = jtypes.Dims(n, m, q, l), ttypes.Dims(n, m, q, l)
    x = jnp.asarray(x0)
    rx, J, cx, A = jf[0](x), jf[1](x), jf[2](x), jf[3](x)
    mask = np.arange(l) < q
    view = jtypes.working_view(jnp.asarray(mask))
    act = js.gather_active(A, cx, view, jd, False)
    F_A = js.factor_active(act, J.T @ rx, view.t, jd)
    rankA = jpseudo_rank(F_A.diag, view.t, EPS_RANK)
    F_L11 = js.factor_l11(F_A, act, view.t)
    gn = js.gn_search_direction(J, rx, act, F_A, F_L11, rankA, view.t,
                                EPS_RANK, jd)
    lam, _ = js.first_mult_estimate(F_A, act, view.t, jd, False, EPS_RANK)
    acs = jnp.sum(jnp.where(act.valid, act.cx_act ** 2, 0.0))
    return dict(jf=jf, tf=tf, x0=x0, jd=jd, td=td, rx=rx, cx=cx, view=view,
                act=act, F_A=F_A, F_L11=F_L11, gn=gn, lam=lam, acs=acs)


@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("seed,dup", [(0, False), (1, True), (2, False)])
def test_choose_subspace_dimensions(seed, dup, restart):
    s = _analysis_state(seed, dup)
    jp, tp = _prev(np.random.default_rng(seed), 5, s["jd"].l, code=-1)
    gn, t = s["gn"], s["view"].t
    rx_sum = jnp.sum(s["rx"] ** 2)
    jdA, jdJ = jdir.choose_subspace_dimensions(
        rx_sum, s["rx"], s["acs"], t, gn.rankJ2, gn.rankA, s["F_L11"],
        gn.F_J2, gn.JQ1, jp, jnp.asarray(restart), s["jd"])
    tdA, tdJ = tdir.choose_subspace_dimensions(
        tt(np.asarray(rx_sum)), tt(np.asarray(s["rx"])),
        tt(np.asarray(s["acs"])), tt(int(t)), tt(int(gn.rankJ2)),
        tt(int(gn.rankA)), to_port(s["F_L11"]), to_port(gn.F_J2),
        tt(np.asarray(gn.JQ1)), tp, restart, s["td"])
    assert (int(tdA), int(tdJ)) == (int(jdA), int(jdJ))


@pytest.mark.parametrize("prev_code,restart,second", [
    (1, False, True),     # Gauss-Newton branch
    (-1, False, True),    # subspace branch
    (2, False, True),     # Newton branch, second derivatives allowed
    (2, False, False),    # Newton branch, disallowed -> error code -4
    (1, True, True),      # restart forces the subspace/Newton decision
])
@pytest.mark.parametrize("seed,dup", [(0, False), (1, True)])
def test_search_direction_analysis_all_branches(seed, dup, prev_code, restart,
                                                second):
    s = _analysis_state(seed, dup)
    jp, tp = _prev(np.random.default_rng(seed + 7), 5, s["jd"].l,
                   code=prev_code)
    gn, t = s["gn"], s["view"].t
    x = jnp.asarray(s["x0"])
    ja = jdir.search_direction_analysis(
        s["jf"][0], s["jf"][2], x, s["rx"], s["cx"], s["act"], s["acs"], gn,
        s["F_A"], s["F_L11"], s["view"], t, s["lam"], jnp.int32(3), jp,
        jnp.asarray(restart), jnp.asarray(False), jnp.asarray(False),
        s["jd"], False, second)
    ta = tdir.search_direction_analysis(
        s["tf"][0], s["tf"][2], tt(s["x0"]), tt(np.asarray(s["rx"])),
        tt(np.asarray(s["cx"])), to_port(s["act"]), tt(np.asarray(s["acs"])),
        to_port(gn), to_port(s["F_A"]), to_port(s["F_L11"]),
        to_port(s["view"]), tt(int(t)), tt(np.asarray(s["lam"])), 3, tp,
        restart, False, False, s["td"], False, second)
    assert int(ta.code) == int(ja.code)
    assert int(ta.error_code) == int(ja.error_code)
    assert (int(ta.dimA), int(ta.dimJ2)) == (int(ja.dimA), int(ja.dimJ2))
    assert bool(ta.newton_taken) == bool(ja.newton_taken)
    for name in ("p", "b", "d", "beta", "speed"):
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(getattr(ja, name)), atol=1e-8,
                                   err_msg=name)
