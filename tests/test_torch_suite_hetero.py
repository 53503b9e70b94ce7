"""Bucketed and fused heterogeneous scenario batches of the PyTorch port
(``parallel/suite.py``, ``parallel/hetero.py``) against the JAX package
and against each other (float64 unless stated, CPU).

Fixtures mirror ``tests/test_hetero.py``: the robust families hs14,
hs65, hs26, hs53 (distinct (n, m, q, l)) and the knife-edge hs42, eight
lanes each, seed 1.  Tolerances are that file's: the fused lanes hold
the bucketed ones to x 1e-7, f 1e-7 relative and n_iter within 1, the
robust families' exit codes exactly, hs42's codes positive or -10.

Also here: C1 (``init_carry`` and the single body mask the padding
constraint rows out of ||c||^2, held against ``enlsip_tpu`` to 1e-13),
C3 (the union closures give every lane its own family's values and
Hessian contractions, finite at float32 where another family's branch
overflows), and that every padded factorization shape of the HS-suite
paths lies inside the batched kernel's gate.  JAX compiles: the fused
solve, and one init / one body of a single solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enlsip_tpu.core import driver as jdrv
from enlsip_tpu.core.types import Options as JOptions, RDims as JRDims, \
    Tols as JTols
from enlsip_tpu.parallel.batch import _run_batch_chunk_jit
from enlsip_tpu.parallel.batch import init_batch as j_init_batch
from enlsip_tpu.parallel.hetero import fuse_families as j_fuse
from enlsip_tpu.parallel.hetero import solve_suite_fused as j_solve_fused
from enlsip_tpu.parallel.suite import hs_scenario_batch as j_scenarios
from enlsip_tpu_torch.core import driver as tdrv
from enlsip_tpu_torch.core.batched import (bind_data, lane_functions,
                                           lane_hessians)
from enlsip_tpu_torch.core.subproblem import hessian_contractions
from enlsip_tpu_torch.core.types import Options, RDims, Tols
from enlsip_tpu_torch.ops.cpqr_batched_hopper import in_gate
from enlsip_tpu_torch.parallel import (FusedSuite, fuse_families,
                                       hs_scenario_batch, init_batch,
                                       run_batch, solve_batched,
                                       solve_suite_batched,
                                       solve_suite_fused)
from enlsip_tpu_torch.parallel.hetero import PAD_CX, _pad_family
from enlsip_tpu_torch.problems import problem_names

from torch_port_helpers import F64

ROBUST = ["hs14", "hs65", "hs26", "hs53"]
KNIFE_EDGE = ["hs42"]
NAMES = ROBUST + KNIFE_EDGE
B_FAM = 8
TOLS = Tols.for_dtype(F64)


def _d(dims):
    return (dims.n, dims.m, dims.q, dims.l)


def _tols(dtype):
    return Tols.for_dtype(dtype)


def _jtols(dtype):
    eps = float(jnp.finfo(dtype).eps)
    rel = float(np.sqrt(eps))
    return JTols(*(jnp.asarray(v, dtype) for v in (1e-10, rel, rel, rel, rel)))


@pytest.fixture(scope="module")
def suites():
    tfams = hs_scenario_batch(NAMES, per_family=B_FAM, seed=1, device="cpu")
    buck = solve_suite_batched(tfams, Options(), _tols, dtype=F64,
                               device="cpu")
    tfs = fuse_families(tfams, device="cpu")
    fused = solve_suite_fused(tfams, Options(), _tols, dtype=F64, fused=tfs,
                              device="cpu")
    return tfams, buck, tfs, fused


@pytest.fixture(scope="module")
def jax_side():
    jfams = j_scenarios(NAMES, per_family=B_FAM, seed=1)
    jfs = j_fuse(jfams)
    jres = j_solve_fused(jfams, JOptions(), _jtols, dtype=jnp.float64,
                         fused=jfs)
    return jfams, jfs, jres


# ------------------------------------------------------------ layout

def test_scenario_starts_are_bit_equal_to_jax(suites, jax_side):
    tfams = suites[0]
    jfams = jax_side[0]
    assert list(tfams) == list(jfams) == NAMES
    for name in NAMES:
        t, j = tfams[name], jfams[name]
        assert _d(t.dims) == _d(j.dims)
        assert t.fstar == j.fstar
        assert t.x0_batch.dtype == F64
        np.testing.assert_array_equal(t.x0_batch.numpy(),
                                      np.asarray(j.x0_batch))


def test_fused_layout_and_rdims_equal_jax(suites, jax_side):
    tfs, jfs = suites[2], jax_side[1]
    assert isinstance(tfs, FusedSuite)
    assert _d(tfs.dims) == _d(jfs.dims)
    assert tfs.slices == jfs.slices and tfs.fstar == jfs.fstar
    np.testing.assert_array_equal(tfs.x0.numpy(), np.asarray(jfs.x0))
    np.testing.assert_array_equal(tfs.data["fam"].numpy(),
                                  np.asarray(jfs.data["fam"]))
    for a, b in zip(tfs.rdims, jfs.rdims):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the padding rows of a family with l < L hold PAD_CX
    lane = tfs.slices["hs14"].start
    c = lane_functions(tfs.fns, tfs.data)
    cx = c.cons(tfs.x0)[lane]
    assert torch.all(cx[2:] == PAD_CX) and tfs.dims.l == 13


def test_bucketed_suite_on_the_suite_batch_inputs():
    names = ["hs65", "hs28", "hs48", "hs51"]
    fams = hs_scenario_batch(names, per_family=4, seed=1, scale=0.05,
                             device="cpu")
    results = solve_suite_batched(fams, Options(), _tols, dtype=F64,
                                  device="cpu")
    for name in names:
        res, fstar = results[name], fams[name].fstar
        ok = res.exit_code.numpy() > 0
        match = np.abs(res.f.numpy() - fstar) <= 1e-4 * (1 + abs(fstar))
        assert (ok & match).mean() >= 0.75, (name, res.exit_code, res.f)


def test_mesh_is_not_ported_yet(suites):
    tfams = suites[0]
    with pytest.raises(NotImplementedError, match="A13"):
        solve_suite_batched(tfams, Options(), _tols, mesh=object(),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        solve_suite_fused(tfams, Options(), _tols, mesh=object(),
                          device="cpu")


# ------------------------------------------- fused against bucketed

def _hold(f, b, name):
    np.testing.assert_allclose(f.x.numpy(), np.asarray(b.x), rtol=0,
                               atol=1e-7, err_msg=name)
    np.testing.assert_allclose(f.f.numpy(), np.asarray(b.f), rtol=1e-7,
                               atol=1e-12, err_msg=name)
    assert np.max(np.abs(f.n_iter.numpy().astype(np.int64)
                         - np.asarray(b.n_iter, np.int64))) <= 1, name
    codes = f.exit_code.numpy()
    if name in ROBUST:
        np.testing.assert_array_equal(codes, np.asarray(b.exit_code),
                                      err_msg=name)
    else:
        assert np.all((codes > 0) | (codes == -10)), (name, codes)


@pytest.mark.parametrize("name", NAMES)
def test_fused_matches_bucketed(suites, name):
    _, buck, _, fused = suites
    _hold(fused[name], buck[name], name)
    assert fused[name].x.shape == buck[name].x.shape
    assert fused[name].counters.nb_res.shape == (B_FAM,)


def test_fused_single_family_is_bitwise():
    fams = hs_scenario_batch(["hs42"], per_family=8, seed=1, device="cpu")
    buck = solve_suite_batched(fams, Options(), _tols, dtype=F64,
                               device="cpu")["hs42"]
    fused = solve_suite_fused(fams, Options(), _tols, dtype=F64,
                              device="cpu")["hs42"]
    assert torch.equal(fused.exit_code, buck.exit_code)
    assert torch.equal(fused.x, buck.x) and torch.equal(fused.f, buck.f)
    assert torch.equal(fused.n_iter, buck.n_iter)
    for a, b in zip(fused.counters, buck.counters):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_fused_lanes_match_enlsip_tpu_fused(suites, jax_side, name):
    fused, jres = suites[3], jax_side[2]
    _hold(fused[name], jres[name], name)


# ---------------------------------------------------------------- C1

# prev.cx_sum is held to 1e-13 relative, not 1e-14: the constraint values
# themselves round differently in the two libraries where they cancel
# (hs26's (1 + x1^2) x0 + x2^4 - 3 = -0.42 differs by 3.6e-15 on one lane,
# 1.7e-14 relative in its square).  The padding rows, when counted, add
# PAD_CX^2 = 1e8 a row.
CX_RTOL = 1e-13


def _cx_rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


def test_c1_batched_prev_cx_sum_masks_padding(suites, jax_side):
    """init_batch and the first lockstep trip with rdims.l < L: prev.cx_sum
    and the first dimA choice equal enlsip_tpu's."""
    tfs = suites[2]
    jfs = jax_side[1]
    jo = JOptions()
    jc0 = j_init_batch(jfs.fns, jnp.asarray(jfs.x0, jnp.float64), jfs.dims,
                       jo, jnp.float64, jfs.data, jfs.rdims)
    jc1 = _run_batch_chunk_jit(jc0, _jtols(jnp.float64), jnp.int32(1),
                               jfs.data, jfs.rdims, jfs.fns, jfs.dims, jo)
    tc0 = init_batch(tfs.fns, tfs.x0, tfs.dims, Options(), F64, tfs.data,
                     tfs.rdims, device="cpu")
    tc1 = run_batch(tc0, tfs.fns, tfs.dims, Options(), TOLS, max_steps=1,
                    data=tfs.data, rdims=tfs.rdims)
    assert bool(torch.any(tfs.rdims.l < tfs.dims.l))
    assert _cx_rel(tc0.prev.cx_sum.numpy(), jc0.prev.cx_sum) <= CX_RTOL
    assert float(tc0.prev.cx_sum.max()) < PAD_CX
    assert _cx_rel(tc1.prev.cx_sum.numpy(), jc1.prev.cx_sum) <= CX_RTOL
    np.testing.assert_array_equal(tc1.prev.dimA.numpy(),
                                  np.asarray(jc1.prev.dimA))
    np.testing.assert_array_equal(tc1.prev.code.numpy(),
                                  np.asarray(jc1.prev.code))


def test_c1_single_solve_body_masks_padding(suites, jax_side):
    """One lane of family hs14 (l = 2 of L = 13) as a single solve with
    its RDims: init_carry and iterate_body against enlsip_tpu's."""
    tfs = suites[2]
    jfs = jax_side[1]
    lane = tfs.slices["hs14"].start
    jo = JOptions()
    jd = jfs.fns
    jfam = {"fam": jnp.asarray(jfs.data["fam"][lane])}
    bind = lambda f: (lambda x: f(x, jfam))
    jf1 = jdrv.Functions(*(bind(f) for f in (jd.res, jd.jac_res, jd.cons,
                                             jd.jac_cons)))
    jrd = JRDims(*(jnp.asarray(v[lane]) for v in jfs.rdims))
    jinit = jax.jit(lambda x0, rd: jdrv.init_carry(jf1, x0, jfs.dims, jo,
                                                   jnp.float64, rd))
    jstep = jax.jit(lambda c, rd: jdrv.iterate_body(
        c, jf1, jfs.dims, jo, _jtols(jnp.float64), rd))
    jc0 = jinit(jnp.asarray(jfs.x0[lane]), jrd)
    jc1 = jstep(jc0, jrd)

    tf1 = bind_data(tfs.fns, {"fam": tfs.data["fam"][lane]})
    trd = RDims(*(int(v[lane]) for v in tfs.rdims))
    tc0 = tdrv.init_carry(tf1, tfs.x0[lane], tfs.dims, Options(), F64, trd,
                          device="cpu")
    tc1 = tdrv.iterate_body(tc0, tf1, tfs.dims, Options(), TOLS, trd)
    assert trd.l < tfs.dims.l
    assert _cx_rel(float(tc0.prev.cx_sum), jc0.prev.cx_sum) <= CX_RTOL
    assert _cx_rel(float(tc1.prev.cx_sum), jc1.prev.cx_sum) <= CX_RTOL
    assert int(tc1.prev.dimA) == int(jc1.prev.dimA)
    assert int(tc1.prev.code) == int(jc1.prev.code)
    assert tc1.exit_code == int(jc1.exit_code)
    np.testing.assert_allclose(tc1.x.numpy(), np.asarray(jc1.x), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------- C3

def _c3_union():
    """hs57 fused with hs65 lanes whose x1 = -3.5: hs57's exp(-x1 (a - 8))
    overflows float32 at every hs65 lane."""
    fams = hs_scenario_batch(["hs57", "hs65"], per_family=4, seed=0,
                             device="cpu")
    s = fams["hs65"]
    x0 = s.x0_batch.clone()
    x0[:, 1] = -3.5
    fams["hs65"] = s._replace(x0_batch=x0)
    return fams, fuse_families(fams, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_c3_union_gives_each_lane_its_own_family(dtype):
    fams, fs = _c3_union()
    x = fs.x0.to(dtype)
    B, N = x.shape
    lf = lane_functions(fs.fns, fs.data)
    r, J, c, A = lf.res(x), lf.jac_res(x), lf.cons(x), lf.jac_cons(x)
    rng = np.random.default_rng(0)
    lam = torch.as_tensor(rng.normal(size=(B, fs.dims.l)), dtype=dtype)
    r_mat, c_mat = lane_hessians(fs.fns, fs.data)(x, r, lam)
    # the overflow is real: hs57's own closure at an hs65 lane's point
    hs57 = fams["hs57"].fns
    lane65 = fs.slices["hs65"].start
    overflow = not torch.all(torch.isfinite(hs57.res(x[lane65, :2])))
    assert overflow == (dtype == torch.float32)
    for name, sl in fs.slices.items():
        pad = _pad_family(fams[name].fns, fams[name].dims, fs.dims)
        xs = x[sl]
        own = [torch.func.vmap(f)(xs) for f in pad[:4]]
        oh = torch.func.vmap(lambda z, rz, lz: hessian_contractions(
            pad.res, pad.cons, z, rz, lz))(xs, own[0], lam[sl])
        for what, got, want in zip(
                ("r", "J", "c", "A", "r_mat", "c_mat"),
                (r[sl], J[sl], c[sl], A[sl], r_mat[sl], c_mat[sl]),
                (*own, *oh)):
            assert torch.all(torch.isfinite(got)), (name, what, dtype)
            assert torch.equal(got, want), (name, what, dtype)


# ----------------------------------------------------- B2's gate

def _padded_dims(names):
    fams = hs_scenario_batch(names, per_family=1, seed=0, device="cpu")
    return fuse_families(fams, device="cpu").dims


@pytest.mark.parametrize("names", [
    problem_names(),
    ["hs14", "hs65", "hs26", "hs53", "hs79"],
    ["hs14", "hs65", "hs26", "hs53", "hs79", "hs42"]],
    ids=["hs_suite_28", "hetero_suite_5", "hetero_newton_6"])
def test_padded_factorizations_lie_inside_the_batched_kernel_gate(names):
    d = _padded_dims(names)
    ka = min(d.n, d.l)
    # J2 (m, n), A_act^T (n, l) and L11 (l, ka): every batched CPQR
    for rows, cols in ((d.m, d.n), (d.n, d.l), (d.l, ka)):
        assert in_gate(rows, cols), (names, rows, cols)
    if len(names) == 28:
        assert (d.n, d.m, d.q, d.l) == (5, 44, 3, 13)
    else:
        assert (d.n, d.m, d.q, d.l) == (5, 5, 3, 13)


# ------------------------------------------------------- escalation

def test_float32_fused_escalation_carries_rdims():
    fams = hs_scenario_batch(["hs16", "hs14", "hs65"], per_family=4, seed=1,
                             device="cpu")
    fs = fuse_families(fams, device="cpu")
    out = solve_suite_fused(fams, Options(), _tols, dtype=torch.float32,
                            fused=fs, escalate_f64=True, device="cpu")
    esc = torch.cat([out[n].escalated for n in fs.slices])
    sel = torch.nonzero(esc)[:, 0]
    assert sel.numel() > 0
    ref = solve_batched(fs.fns, fs.x0[sel], fs.dims, Options(), TOLS,
                        dtype=F64, data={"fam": fs.data["fam"][sel]},
                        rdims=RDims(*(v[sel] for v in fs.rdims)),
                        device="cpu")
    x = torch.cat([torch.nn.functional.pad(
        out[n].x, (0, fs.dims.n - out[n].x.shape[1])) for n in fs.slices])
    code = torch.cat([out[n].exit_code for n in fs.slices])
    f = torch.cat([out[n].f for n in fs.slices])
    assert x.dtype == F64
    assert torch.equal(code[sel], ref.exit_code)
    assert torch.equal(x[sel], ref.x) and torch.equal(f[sel], ref.f)
