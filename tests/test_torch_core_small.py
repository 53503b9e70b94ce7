"""PyTorch port of core/working_set.py, core/weights.py,
core/termination.py and core/types.py against the JAX package (float64,
CPU, same numpy inputs).  Masks, indices and exit codes compare exactly;
weights and merit scalars within 1e-12 absolute (element-wise
arithmetic in the same order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.core import termination as jterm
from enlsip_tpu.core import types as jtypes
from enlsip_tpu.core import weights as jw
from enlsip_tpu.core import working_set as jws
from enlsip_tpu_torch.core import termination as tterm
from enlsip_tpu_torch.core import types as ttypes
from enlsip_tpu_torch.core import weights as tw
from enlsip_tpu_torch.core import working_set as tws

from torch_port_helpers import tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)

ATOL = 1e-12


def _ji(v):
    return jnp.int32(v)


# ------------------------------------------------------------------ types

@pytest.mark.parametrize("seed", range(4))
def test_working_view(seed):
    mask = np.random.default_rng(seed).random(9) < 0.5
    jv = jtypes.working_view(jnp.asarray(mask))
    tv = ttypes.working_view(tt(mask))
    np.testing.assert_array_equal(tv.active_list.numpy(),
                                  np.asarray(jv.active_list))
    assert int(tv.t) == int(jv.t)


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_tols_for_dtype(name):
    jt = jtypes.Tols.for_dtype(jnp.dtype(name))
    tl = ttypes.Tols.for_dtype(getattr(torch, name))
    for a, b in zip(tl, jt):
        assert float(a) == float(b)


def test_dims_and_options_defaults_agree():
    assert ttypes.Dims(5, 7, 1, 9).tmax == jtypes.Dims(5, 7, 1, 9).tmax
    assert ttypes.Dims(5, 7, 1, 9).ka == jtypes.Dims(5, 7, 1, 9).ka
    jo, to = jtypes.Options(), ttypes.Options()
    for f in ("scaling", "second_derivatives", "weight_code", "max_iter",
              "linesearch_max_refine", "gac_max_halvings",
              "eucmod_max_passes", "matmul_precision",
              "rank_deficient_deletion"):
        assert getattr(jo, f) == getattr(to, f), f


def test_matmul_precision_scope_restores_process_setting():
    before = torch.get_float32_matmul_precision()
    with ttypes.matmul_precision_scope(
            ttypes.Options(matmul_precision="tensorfloat32")):
        assert torch.get_float32_matmul_precision() == "high"
    assert torch.get_float32_matmul_precision() == before
    with ttypes.matmul_precision_scope(ttypes.Options(matmul_precision=None)):
        assert torch.get_float32_matmul_precision() == before


# ------------------------------------------------------------ working set

@pytest.mark.parametrize("seed", range(4))
def test_init_working_set(seed):
    rng = np.random.default_rng(seed)
    n, l, q = 4, 7, 2
    cx = rng.normal(size=l)
    cx[3] = 0.0
    cx[4] = 1e-18
    A, x = rng.normal(size=(l, n)), rng.normal(size=n)
    jm, jwt, jK = jws.init_working_set(jnp.asarray(cx), jnp.asarray(A),
                                       jnp.asarray(x), jtypes.Dims(n, 5, q, l))
    tm, twt, tK = tws.init_working_set(tt(cx), tt(A), tt(x),
                                       ttypes.Dims(n, 5, q, l))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(twt.numpy(), np.asarray(jwt), atol=ATOL)
    np.testing.assert_array_equal(tK.numpy(), np.asarray(jK))


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_deletion_and_minmax_multipliers(seed, scaling):
    rng = np.random.default_rng(seed)
    l, q = 8, 2
    t = int(rng.integers(0, l + 1))
    lam = rng.normal(size=l) * (np.arange(l) < t)
    if seed % 2:
        lam[q:t] = np.round(lam[q:t], 1)      # ties
    valid = np.arange(l) < t
    ds = rng.uniform(0.5, 2.0, l)
    for grad_res in (0.0, 5.0):
        js = jws.check_constraint_deletion(q, jnp.asarray(lam),
                                           jnp.asarray(valid), _ji(t), scaling,
                                           jnp.asarray(ds), grad_res)
        ts = tws.check_constraint_deletion(q, tt(lam), tt(valid), tt(t),
                                           scaling, tt(ds), tt(grad_res))
        assert int(ts) == int(js)
    jmm = jws.minmax_lagrangian_mult(jnp.asarray(lam), jnp.asarray(valid),
                                     _ji(t), q, scaling, jnp.asarray(ds))
    tmm = tws.minmax_lagrangian_mult(tt(lam), tt(valid), tt(t), q, scaling,
                                     tt(ds))
    for a, b in zip(tmm, jmm):
        assert float(a) == float(b)


@pytest.mark.parametrize("seed", range(8))
def test_evadd(seed):
    """Includes saturated working sets (t == min(l, n)) where a swap-out
    is needed, and the steplength-capping constraint's wider window."""
    rng = np.random.default_rng(100 + seed)
    n, q = 3, 1
    l = 7
    mask = np.zeros(l, bool)
    mask[:q] = True
    mask[q + rng.permutation(l - q)[:int(rng.integers(0, n))]] = True
    cx = rng.normal(size=l) * 0.2
    cx[rng.integers(q, l)] = 0.05
    cap = int(rng.integers(-1, l))
    dj, dt = jtypes.Dims(n, 4, q, l), ttypes.Dims(n, 4, q, l)
    jm, jadd = jws.evaluate_violated_constraints(
        jnp.asarray(cx), jnp.asarray(mask), _ji(cap), dj)
    tm, tadd = tws.evaluate_violated_constraints(tt(cx), tt(mask), tt(cap), dt)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(tadd) == bool(jadd)


# ---------------------------------------------------------------- weights

def _weight_case(seed, l=6, m=5):
    rng = np.random.default_rng(seed)
    t = int(rng.integers(0, l + 1))
    dimA = int(rng.integers(0, t + 1))
    perm = rng.permutation(l)
    ag = np.concatenate([np.sort(perm[:t]), np.sort(perm[t:])])
    valid = np.arange(l) < t
    w_old = rng.uniform(0.01, 0.2, l)
    K = np.sort(rng.uniform(0.01, 0.3, (4, l)), axis=0)[::-1].copy()
    Jp, rx = rng.normal(size=m), rng.normal(size=m)
    cx, aAp = rng.normal(size=l), rng.normal(size=l) * valid
    if seed % 5 == 0:
        cx[:] = 0.0               # the fcx = 0 rule
    return t, dimA, ag, valid, w_old, K, Jp, rx, cx, aAp


@pytest.mark.parametrize("code", [2, 0])
@pytest.mark.parametrize("seed", range(12))
def test_penalty_weight_update(seed, code):
    t, dimA, ag, valid, w_old, K, Jp, rx, cx, aAp = _weight_case(seed)
    l, m = len(cx), len(rx)
    jr = jw.penalty_weight_update(
        jnp.asarray(w_old), jnp.asarray(Jp), jnp.asarray(aAp), jnp.asarray(K),
        jnp.asarray(rx), jnp.asarray(cx), jnp.asarray(ag, jnp.int32),
        jnp.asarray(valid), _ji(t), _ji(dimA), code, jtypes.Dims(4, m, 0, l),
        16)
    tr = tw.penalty_weight_update(
        tt(w_old), tt(Jp), tt(aAp), tt(K), tt(rx), tt(cx), tt(ag), tt(valid),
        tt(t), tt(dimA), code, ttypes.Dims(4, m, 0, l), 16)
    for a, b, name in zip(tr, jr, ("w", "dpsi0", "dpsi_scale", "K")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)
    assert tr[1].dtype == torch.float64      # decision precision


@pytest.mark.parametrize("ctrl", [1, 2])
@pytest.mark.parametrize("seed", range(5))
def test_min_norm_w(seed, ctrl):
    rng = np.random.default_rng(50 + seed)
    l = 7
    ag = rng.permutation(l)
    w_old = rng.uniform(0.0, 0.5, l)
    y = rng.normal(size=l)
    pos = (y > 0) & (rng.random(l) < 0.8)
    tau = float(rng.uniform(0.1, 3.0))
    jr = jw.min_norm_w(ctrl, jnp.asarray(w_old), jnp.asarray(y),
                       jnp.asarray(tau), jnp.asarray(pos),
                       jnp.asarray(ag, jnp.int32), 16)
    tr = tw.min_norm_w(ctrl, tt(w_old), tt(y), tt(tau), tt(pos), tt(ag), 16)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL)


def test_assort_keeps_largest_four():
    rng = np.random.default_rng(3)
    l = 6
    K = np.sort(rng.uniform(size=(4, l)), axis=0)[::-1].copy()
    w = rng.uniform(size=l)
    ag, valid = rng.permutation(l), np.arange(l) < 4
    np.testing.assert_array_equal(
        tw.assort(tt(K), tt(w), tt(ag), tt(valid)).numpy(),
        np.asarray(jw.assort(jnp.asarray(K), jnp.asarray(w),
                             jnp.asarray(ag, jnp.int32), jnp.asarray(valid))))


# ------------------------------------------------------------ termination

def _term_state(seed):
    """A converged-looking state; the cases below perturb it."""
    rng = np.random.default_rng(seed)
    n, m, l, q, t = 4, 6, 5, 1, 2
    x = rng.normal(size=n)
    s = dict(
        p=1e-9 * rng.normal(size=n), code=1, restart=False, deleted=False,
        d_gn=1e-9 * rng.normal(size=m), dimJ2=2, grad_res=1e-12,
        act_cx=np.array([1e-12, -1e-12, 0, 0, 0.0]),
        act_A=rng.normal(size=(l, n)) * (np.arange(l) < t)[:, None],
        act_valid=np.arange(l) < t, t=t, x=x, prev_x=x + 1e-12,
        cx=np.array([0.0, 0.0, 1.0, 2.0, 0.5]),
        mask=np.array([True, True, False, False, False]), rx_sum=2.5,
        gf=rng.normal(size=n), nb_iter=7, error_code=0, sigma_min=0.4,
        lam_abs_max=1.0, psi_error=0, nb_newton_steps=0,
        w=rng.uniform(0.1, 2.0, l), active_global=np.arange(l))
    return s, (n, m, q, l)


TERM_CASES = {
    "converged": {},
    "zero_residual": {"rx_sum": 1e-25},
    "restart": {"restart": True},
    "deleted": {"deleted": True},
    "infeasible_active": {"act_cx": np.array([0.3, 0, 0, 0, 0.0])},
    "inactive_violated": {"cx": np.array([0.0, 0.0, -1.0, 2.0, 0.5])},
    "negative_multiplier": {"sigma_min": -0.5},
    "large_gradient": {"grad_res": 10.0},
    "max_iter": {"nb_iter": 100, "grad_res": 10.0},
    "cholesky_failure": {"error_code": -3, "restart": True},
    "newton_disallowed": {"error_code": -4, "restart": True},
    "too_many_newton": {"nb_newton_steps": 6, "grad_res": 10.0},
    "non_descent": {"psi_error": -1, "grad_res": 10.0},
    "stuck": {"grad_res": 10.0, "w": np.full(5, 3.0)},
    "subspace_noise": {"code": -1},
    "moving": {"p": np.ones(4), "prev_x": np.full(4, 9.0), "grad_res": 10.0},
}


@pytest.mark.parametrize("case", sorted(TERM_CASES))
def test_check_termination(case):
    s, (n, m, q, l) = _term_state(1)
    s.update(TERM_CASES[case])
    rel = float(np.sqrt(np.finfo(float).eps))
    tv = (1e-10, rel, rel, rel, rel)
    order = ["p", "code", "restart", "deleted", "d_gn", "dimJ2", "grad_res",
             "act_cx", "act_A", "act_valid", "t", "x", "prev_x", "cx", "mask",
             "rx_sum", "gf", "nb_iter"]
    tail = ["error_code", "sigma_min", "lam_abs_max", "psi_error",
            "nb_newton_steps", "w", "active_global"]

    def jval(k):
        v = s[k]
        if isinstance(v, (bool, np.bool_)):
            return jnp.asarray(v)
        if isinstance(v, (int, np.integer)):
            return jnp.int32(v)
        return jnp.asarray(v)

    def tval(k):
        if k in ("nb_iter", "nb_newton_steps"):
            return s[k]                   # host ints in the port
        return tt(s[k])

    jout = jterm.check_termination(
        *[jval(k) for k in order], 100,
        jtypes.Tols(*(jnp.float64(v) for v in tv)),
        *[jval(k) for k in tail], jtypes.Dims(n, m, q, l))
    tout = tterm.check_termination(
        *[tval(k) for k in order], 100,
        ttypes.Tols(*(tt(v) for v in tv)),
        *[tval(k) for k in tail], ttypes.Dims(n, m, q, l))
    assert int(tout) == int(jout), case


def test_termination_cases_cover_the_lattice():
    """The cases above reach convergence codes and every abnormal code
    the function itself assigns."""
    s0, (n, m, q, l) = _term_state(1)
    rel = float(np.sqrt(np.finfo(float).eps))
    tols = ttypes.Tols(*(tt(v) for v in (1e-10, rel, rel, rel, rel)))
    seen = set()
    for case, upd in TERM_CASES.items():
        s = dict(s0)
        s.update(upd)
        v = lambda k: s[k] if k in ("nb_iter", "nb_newton_steps") else tt(s[k])
        seen.add(int(tterm.check_termination(
            v("p"), v("code"), v("restart"), v("deleted"), v("d_gn"),
            v("dimJ2"), v("grad_res"), v("act_cx"), v("act_A"),
            v("act_valid"), v("t"), v("x"), v("prev_x"), v("cx"), v("mask"),
            v("rx_sum"), v("gf"), v("nb_iter"), 100, tols, v("error_code"),
            v("sigma_min"), v("lam_abs_max"), v("psi_error"),
            v("nb_newton_steps"), v("w"), v("active_global"),
            ttypes.Dims(n, m, q, l))))
    assert {0, -2, -3, -4, -6, -9, -10} <= seen, seen
    assert any(c > 0 for c in seen), seen
