"""PyTorch port of core/linesearch.py against the JAX package (float64,
CPU).  Scalar model routines agree to 1e-12 relative (same formulas;
cbrt/acos/cos may differ in the last bits); step lengths and merit
values from full searches to 1e-9; evaluation counters and error flags
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from enlsip_tpu.core import linesearch as jls
from enlsip_tpu.core import subproblem as js
from enlsip_tpu.core import types as jtypes
from enlsip_tpu.ops.qr import pseudo_rank as jpseudo_rank
from enlsip_tpu_torch.core import linesearch as tls
from enlsip_tpu_torch.core import types as ttypes

from torch_port_helpers import to_port, tt, twin_functions
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

EPS_RANK = float(np.sqrt(np.finfo(float).eps))


def _close(a, b, rtol=1e-12, atol=1e-13):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", range(12))
def test_minrn_and_quadratic(seed):
    rng = np.random.default_rng(seed)
    xs = np.sort(rng.uniform(0, 2, 3))
    if seed % 4 == 0:
        xs[1] = xs[0]                       # degenerate abscissae
    ys = rng.uniform(0, 5, 3)
    args = [xs[0], ys[0], xs[1], ys[1], xs[2], ys[2], 1e-3, 3.0, 2.0]
    ja, jpa = jls.minrn(*[jnp.asarray(v) for v in args])
    ta, tpa = tls.minrn(*[tt(v) for v in args])
    _close(ta, ja)
    _close(tpa, jpa)


@pytest.mark.parametrize("seed", range(16))
def test_minrm_cardano_and_newton_raphson(seed):
    """Both the analytic (one and three real roots) and the
    Newton-Raphson branches occur over these seeds."""
    rng = np.random.default_rng(seed)
    k = 9
    v0, v1 = rng.normal(size=k), rng.normal(size=k)
    v2 = rng.normal(size=k) * (10.0 ** -(seed % 4) if seed % 2 else 1e-9)
    x_min = float(rng.uniform(0, 1))
    jo = jls.minrm(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                   jnp.asarray(x_min), jnp.asarray(1e-4), jnp.asarray(3.0))
    to = tls.minrm(tt(v0), tt(v1), tt(v2), tt(x_min), tt(1e-4), tt(3.0))
    for a, b in zip(to, jo):
        _close(a, b, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("seed", range(8))
def test_check_reduction(seed):
    v = np.random.default_rng(seed).uniform(0, 2, 4)
    want = jls.check_reduction(*[jnp.asarray(x) for x in v[:3]], 0.3,
                               jnp.asarray(v[3]))
    got = tls.check_reduction(*[tt(x) for x in v[:3]], 0.3, tt(v[3]))
    assert bool(got) == bool(want)


@pytest.mark.parametrize("seed", range(6))
def test_upper_bound_steplength(seed):
    rng = np.random.default_rng(seed)
    n, l = 4, 7
    A, cx = rng.normal(size=(l, n)), rng.normal(size=l)
    p, x = rng.normal(size=n), rng.normal(size=n)
    mask = rng.random(l) < 0.4
    idel = int(rng.integers(-1, l))
    ja, ji = jls.upper_bound_steplength(
        jnp.asarray(A), jnp.asarray(cx), jnp.asarray(p), jnp.asarray(x),
        jnp.asarray(mask), jnp.int32(idel), jtypes.Dims(n, 5, 0, l))
    ta, ti = tls.upper_bound_steplength(tt(A), tt(cx), tt(p), tt(x), tt(mask),
                                        tt(idel), ttypes.Dims(n, 5, 0, l))
    _close(ta, ja)
    assert int(ti) == int(ji)


def _search_state(seed, scale=1.0):
    """A GN direction at the start point of a twin problem."""
    jf, tf, x0, (n, m, q, l) = twin_functions(seed, 5, 8, 2, 2, lower=(0, 3),
                                              scale=scale)
    jd, td = jtypes.Dims(n, m, q, l), ttypes.Dims(n, m, q, l)
    x = jnp.asarray(x0)
    rx, J, cx, A = jf[0](x), jf[1](x), jf[2](x), jf[3](x)
    mask = np.arange(l) < q
    view = jtypes.working_view(jnp.asarray(mask))
    act = js.gather_active(A, cx, view, jd, False)
    F_A = js.factor_active(act, J.T @ rx, view.t, jd)
    rankA = jpseudo_rank(F_A.diag, view.t, EPS_RANK)
    gn = js.gn_search_direction(J, rx, act, F_A,
                                js.zeros_factor_l11(jd, jnp.float64), rankA,
                                view.t, EPS_RANK, jd)
    return dict(jf=jf, tf=tf, x0=x0, jd=jd, td=td, rx=rx, J=J, cx=cx, A=A,
                mask=mask, view=view, act=act, gn=gn, l=l, n=n)


def _prev(s, alpha=1.0, rankJ2=0):
    l, n = s["l"], s["n"]
    jp = jtypes.PrevIter(
        x=jnp.asarray(s["x0"]), rx_sum=jnp.asarray(1.0),
        cx_sum=jnp.asarray(1.0), t=jnp.int32(2), alpha=jnp.asarray(alpha),
        beta=jnp.asarray(0.0), code=jnp.int32(1),
        w=jnp.minimum(jnp.abs(s["cx"]) + 0.01, 0.1),
        progress=jnp.asarray(0.0), predicted_reduction=jnp.asarray(0.0),
        rankA=jnp.int32(0), rankJ2=jnp.int32(rankJ2), dimA=jnp.int32(0),
        dimJ2=jnp.int32(0))
    return jp, to_port(jp)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("seed", range(3))
def test_psi_and_check_derivatives(seed, sign):
    s = _search_state(seed)
    p = np.asarray(s["gn"].p) * sign
    w = np.random.default_rng(seed).uniform(0.1, 1.0, s["l"])
    x = jnp.asarray(s["x0"])
    jres_at = lambda a: s["jf"][0](x + a * jnp.asarray(p))
    tres_at = lambda a: s["tf"][0](tt(s["x0"]) + a * tt(p))
    jv, jc = jls.psi(x, jnp.asarray(0.3), jnp.asarray(p), jnp.asarray(w),
                     jnp.asarray(s["mask"]), jres_at, s["jf"][2],
                     jtypes.Counters.zeros())
    tv, tc = tls.psi(tt(s["x0"]), tt(0.3), tt(p), tt(w), tt(s["mask"]),
                     tres_at, s["tf"][2], ttypes.Counters.zeros())
    _close(tv, jv)
    assert tuple(tc) == tuple(int(c) for c in jc) == (1, 0, 1, 0)
    je, _ = jls.check_derivatives(
        jnp.asarray(-1.0), jnp.asarray(2.0), jv, x, jnp.asarray(0.3),
        jnp.asarray(p), jnp.asarray(w), jnp.asarray(s["mask"]), jres_at,
        s["jf"][2], jtypes.Counters.zeros())
    te, _ = tls.check_derivatives(
        tt(-1.0), tt(2.0), tv, tt(s["x0"]), tt(0.3), tt(p), tt(w),
        tt(s["mask"]), tres_at, s["tf"][2], ttypes.Counters.zeros())
    assert int(te) == int(je)


@pytest.mark.parametrize("code", [1, 2])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("seed,scale,alpha_prev", [
    (0, 1.0, 1.0), (1, 1.0, 1.0), (2, 1.0, 0.05), (3, 8.0, 1.0),
    (4, 8.0, 0.3), (5, 30.0, 1.0)])
def test_compute_steplength(seed, scale, alpha_prev, flip, code):
    """STPLNG end to end (weights, UPBND, LINEC with its refinement and
    Goldstein-Armijo branches, the derivative check after a failed
    search).  ``flip`` searches along -p, an ascent direction: the
    non-descent exit.  ``code`` 2 is the undamped Newton step."""
    s = _search_state(seed, scale)
    jp, tp = _prev(s, alpha_prev, rankJ2=int(seed % 2) * 9)
    p = np.asarray(s["gn"].p) * (-1.0 if flip else 1.0)
    K = np.full((4, s["l"]), 0.1)
    t = s["view"].t
    jres_trial = lambda xx, pp: (lambda a: s["jf"][0](xx + a * pp))
    tres_trial = lambda xx, pp: (lambda a: s["tf"][0](xx + a * pp))
    jo = jls.compute_steplength(
        jres_trial, s["jf"][2], jnp.asarray(s["x0"]), s["rx"], s["J"],
        s["cx"], s["A"], s["act"], s["view"], t, jnp.asarray(p), t,
        s["gn"].rankJ2, jnp.int32(code), jnp.int32(-1), jp, jnp.asarray(K),
        jnp.asarray(s["mask"]), s["jd"], 2, jtypes.Counters.zeros(), 30, 60,
        16, False)
    to = tls.compute_steplength(
        tres_trial, s["tf"][2], tt(s["x0"]), tt(np.asarray(s["rx"])),
        tt(np.asarray(s["J"])), tt(np.asarray(s["cx"])),
        tt(np.asarray(s["A"])), to_port(s["act"]), to_port(s["view"]),
        tt(int(t)), tt(p), tt(int(t)), tt(int(s["gn"].rankJ2)), code, tt(-1),
        tp, tt(K), tt(s["mask"]), s["td"], 2, ttypes.Counters.zeros(), 30, 60,
        16, False)
    assert tuple(to.counters) == tuple(int(c) for c in jo.counters)
    assert int(to.psi_error) == int(jo.psi_error)
    assert int(to.index_alpha_upp) == int(jo.index_alpha_upp)
    assert bool(to.updated_progress) == bool(jo.updated_progress)
    for name in ("alpha", "w", "K", "predicted_reduction", "progress"):
        _close(getattr(to, name).numpy(), getattr(jo, name), rtol=1e-9,
               atol=1e-9)


def test_goldstein_armijo_step_halves_until_exit():
    s = _search_state(0)
    p = -np.asarray(s["gn"].p)            # ascent: never satisfied
    w = np.full(s["l"], 0.1)
    x = jnp.asarray(s["x0"])
    jres_at = lambda a: s["jf"][0](x + a * jnp.asarray(p))
    tres_at = lambda a: s["tf"][0](tt(s["x0"]) + a * tt(p))
    ju, jext, jc = jls.goldstein_armijo_step(
        jnp.asarray(1.0), jnp.asarray(-1.0), jnp.asarray(1e-3), 0.25,
        jnp.asarray(2.0), x, jnp.asarray(1.0), jnp.asarray(p), jnp.asarray(w),
        jnp.asarray(s["mask"]), jres_at, s["jf"][2], jtypes.Counters.zeros(),
        60)
    tu, text, tc = tls.goldstein_armijo_step(
        tt(1.0), tt(-1.0), tt(1e-3), 0.25, tt(2.0), tt(s["x0"]), tt(1.0),
        tt(p), tt(w), tt(s["mask"]), tres_at, s["tf"][2],
        ttypes.Counters.zeros(), 60)
    _close(tu, ju)
    assert bool(text) == bool(jext)
    assert tuple(tc) == tuple(int(c) for c in jc)
