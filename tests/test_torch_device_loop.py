"""The device-resident solve loop (``_graph``, ``_lanes`` control flow,
``core.driver.solve`` / ``run_chunk`` and ``parallel.batch``'s graph
paths) against the JAX package and against the port's own eager loop
(float64, CPU).

On the CPU the executor runs the device-resident code eagerly with every
read-back outside the control-flow helpers forbidden
(``_device.forbid_readbacks``): a solve whose body read anything back
would raise here.  The single solves hold the JAX package's per-iteration
(method code, t, rankA), exit codes and evaluation counters exactly; the
batches hold the eager ``run_batch`` to the bit and the JAX package to
the tolerances of ``test_torch_batch.py`` / ``test_torch_ode_fit.py``.
The ``gpu`` cases capture a solve into a CUDA graph and replay it twice.
One JAX compile per problem."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enlsip_tpu as ej
import enlsip_tpu_torch as et
from enlsip_tpu.core import driver as jdrv
from enlsip_tpu.core import types as jtypes
from enlsip_tpu.core import working_set as jws
from enlsip_tpu.models.model import _model_functions as j_model_functions
from enlsip_tpu.models.model import total_nb_constraints
from enlsip_tpu.parallel import solve_batched as j_solve_batched
from enlsip_tpu_torch import _device, _graph, _lanes
from enlsip_tpu_torch.core import driver as tdrv
from enlsip_tpu_torch.core import types as ttypes
from enlsip_tpu_torch.core import working_set as tws
from enlsip_tpu_torch.models.model import _model_functions as t_model_functions
from enlsip_tpu_torch.ops.blocked_qr import cpqr_blocked, cpqr_packed_plain
from enlsip_tpu_torch.ops.cpqr_batched_hopper import cpqr_batched_packed_plain
from enlsip_tpu_torch.parallel import (finalize, init_batch, run_batch,
                                       solve_batched)

import problems as jprob
from torch_port_helpers import CPU, F64, hs65_batch_setup, ref_tree, to_port, tt
from torch_port_helpers import release_jax_executables  # noqa: F401  (autouse)
from test_torch_driver import PROBLEMS, _row, compare_traces, jax_trace
from test_torch_ode_fit import (_JCONS, _j_cons, _j_jac, _j_jac_cons,
                                _torch_setup)

REL = float(np.sqrt(np.finfo(float).eps))


# ------------------------------------------------------ single solves

@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(name):
        if name not in cache:
            jkw, tkw, tols = PROBLEMS[name]
            jm, tm = ej.CnlsModel(**jkw()), et.CnlsModel(**tkw())
            n, m, q = jm.nb_parameters, jm.nb_residuals, jm.nb_eqcons
            l = total_nb_constraints(jm)
            jf = jdrv.Functions(*j_model_functions(jm, jnp.float64))
            jd, jo = jtypes.Dims(n, m, q, l), jtypes.Options()
            jt = jtypes.Tols(*(jnp.float64(v) for v in tols))
            step = jax.jit(partial(jdrv.iterate_body, fns=jf, dims=jd,
                                   opts=jo, tols=jt))
            jc0 = jdrv.init_carry(jf, jnp.asarray(jm.starting_point), jd, jo,
                                  jnp.float64)
            jrows, jc = jax_trace(step, jc0)
            cache[name] = dict(
                jrows=jrows, jc=jc, jc0=jc0,
                tfns=tdrv.Functions(*t_model_functions(tm, F64, CPU)),
                x0=tm.starting_point, dims=ttypes.Dims(n, m, q, l),
                tols=ttypes.Tols(*(tt(v) for v in tols)))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_device_loop_traces_match_reference(reference, name):
    """Chunks of one iteration through the chunk graph's rehearsal: the
    per-iteration (code, t, rankA), exit codes and counters of the JAX
    package; two read-backs a chunk (the chunk's codes, nothing in the
    body), none forbidden."""
    s = reference(name)
    rows = []
    _device.reset_readback_count()
    res = tdrv.solve(s["tfns"], s["x0"], s["dims"], ttypes.Options(),
                     s["tols"], dtype=F64, device="cpu",
                     on_iteration=lambda c: rows.append(_row(c)))
    compare_traces(s["jrows"], s["jc"], rows, res, name)
    # one read of (exit code, iterations) a chunk, one of the packed result
    assert _device.readback_count() == len(rows) + 1


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_unlimited_solve_is_one_program_and_one_readback(reference, name):
    """Init, the whole loop and the packed result as one device program:
    exactly ONE read-back, and the JAX package's exit code, iteration
    count, counters and x."""
    s = reference(name)
    _device.reset_readback_count()
    res = tdrv.solve(s["tfns"], s["x0"], s["dims"], ttypes.Options(),
                     s["tols"], dtype=F64, device="cpu")
    assert _device.readback_count() == 1
    jc = s["jc"]
    assert res.exit_code == int(jc.exit_code) > 0
    assert res.n_iter == int(jc.nb_iter)
    assert tuple(res.counters) == tuple(int(c) for c in jc.counters)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jc.x), rtol=1e-8,
                               atol=1e-8 * float(np.abs(np.asarray(jc.x)).max()))


@pytest.mark.parametrize("name", ["hs65", "chained_wood_20"])
def test_graph_path_equals_eager_loop_to_the_bit(reference, name):
    """The device-resident form and the eager loop (one read-back a
    branch) run the same operations: equal bits, equal counts."""
    s = reference(name)
    args = (s["tfns"], s["x0"], s["dims"], ttypes.Options(), s["tols"])
    _device.reset_readback_count()
    eager = tdrv.solve(*args, dtype=F64, device="cpu", graph=False)
    assert _device.readback_count() > eager.n_iter      # a branch a read
    resident = tdrv.solve(*args, dtype=F64, device="cpu")
    assert torch.equal(eager.x, resident.x)
    assert torch.equal(eager.display, resident.display)
    assert (eager.exit_code, eager.n_iter, eager.f, tuple(eager.counters)) \
        == (resident.exit_code, resident.n_iter, resident.f,
            tuple(resident.counters))


def test_pack_result_layout_is_the_reference_layout(reference):
    s = reference("osborne2")
    jc = s["jc"]
    f = jnp.dot(jc.rx, jc.rx)
    jflat = np.asarray(jdrv._pack_result(jc, f))
    tc = to_port(jc)
    tflat = tdrv._pack_result(tc, tc.rx @ tc.rx)
    assert tflat.shape == jflat.shape
    np.testing.assert_allclose(tflat.numpy(), jflat, rtol=1e-15, atol=0)
    res = tdrv._unpack_result(tflat, s["dims"].n, 0.0)
    assert res.exit_code == int(jc.exit_code)
    assert res.n_iter == int(jc.nb_iter)
    assert tuple(res.counters) == tuple(int(c) for c in jc.counters)


def test_finite_time_limit_takes_the_chunk_schedule(reference):
    s = reference("osborne2")
    args = (s["tfns"], s["x0"], s["dims"], ttypes.Options(), s["tols"])
    gone = tdrv.solve(*args, dtype=F64, device="cpu", time_limit=-1.0)
    assert gone.exit_code == -11 and gone.n_iter == 0
    _device.reset_readback_count()
    ample = tdrv.solve(*args, dtype=F64, device="cpu", time_limit=1e6)
    # the measured chunk of one iteration, one chunk for the rest, and
    # the packed result
    assert _device.readback_count() == 3
    whole = tdrv.solve(*args, dtype=F64, device="cpu")
    assert torch.equal(ample.x, whole.x) and ample.exit_code == \
        whole.exit_code > 0 and ample.n_iter == whole.n_iter


def test_max_iter_gives_minus_2_through_the_chunk_schedule(reference):
    s = reference("osborne2")
    opts = ttypes.Options(max_iter=3)
    for limit in (None, 1e6):
        res = tdrv.solve(s["tfns"], s["x0"], s["dims"], opts, s["tols"],
                         dtype=F64, device="cpu", time_limit=limit)
        assert res.exit_code == -2 and res.n_iter == 3


# -------------------------------------------------------------- batches

@pytest.fixture(scope="module")
def hs65_batch():
    jf, tf, starts, (n, m, q, l) = hs65_batch_setup(8, seed=4)
    jtols = jtypes.Tols(*(jnp.float64(v) for v in (1e-10, REL, REL, REL,
                                                   REL)))
    jres = j_solve_batched(jf, starts, jtypes.Dims(n, m, q, l),
                           jtypes.Options(), jtols)
    return jres, tf, starts, ttypes.Dims(n, m, q, l)


def _same_bits(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _same_bits(x, y)
        elif x is not None:
            assert torch.equal(x, y)


def test_hs65_batch_executor_equals_eager_run_batch(hs65_batch):
    jres, tf, starts, dims = hs65_batch
    tols = ttypes.Tols.for_dtype(F64)
    _device.reset_readback_count()
    resident = solve_batched(tf, starts, dims, ttypes.Options(), tols,
                             dtype=F64, device="cpu")
    assert _device.readback_count() == 1
    trips = run_batch.last_trips
    eager = solve_batched(tf, starts, dims, ttypes.Options(), tols,
                          dtype=F64, device="cpu", graph=False)
    assert run_batch.last_trips == trips
    _same_bits(resident, eager)
    np.testing.assert_array_equal(resident.exit_code.numpy(),
                                  np.asarray(jres.exit_code))
    np.testing.assert_array_equal(resident.n_iter.numpy(),
                                  np.asarray(jres.n_iter))
    np.testing.assert_allclose(resident.x.numpy(), np.asarray(jres.x),
                               rtol=1e-8)


def test_run_batch_chunks_equal_one_program(hs65_batch):
    _, tf, starts, dims = hs65_batch
    tols = ttypes.Tols.for_dtype(F64)
    carry = init_batch(tf, starts, dims, ttypes.Options(), F64, device="cpu")
    whole = finalize(run_batch(carry, tf, dims, ttypes.Options(), tols))
    chunked = finalize(run_batch(carry, tf, dims, ttypes.Options(), tols,
                                 time_limit=1e6))
    eager = finalize(run_batch(carry, tf, dims, ttypes.Options(), tols,
                               graph=False))
    _same_bits(whole, chunked)
    _same_bits(whole, eager)
    late = run_batch(carry, tf, dims, ttypes.Options(), tols,
                     time_limit=-1.0)
    assert (late.exit_code == -11).all()


def test_ode_fit_batch_executor_equals_eager_run_batch():
    from enlsip_tpu.models.model import build_constraint_functions as j_build
    from enlsip_tpu.problems import ode_fit as jode
    from enlsip_tpu_torch.problems import ode_fit as tode

    _JCONS["cons"], _JCONS["jac"] = j_build(ej.CnlsModel(**jode.model_kwargs()))
    jf = jdrv.Functions(res=jode.residuals_data, jac_res=_j_jac,
                        cons=_j_cons, jac_cons=_j_jac_cons)
    tf, dims = _torch_setup()
    starts = tode.perturbed_starts(8)
    ys = tode.scenario_observations(8)
    opts = ttypes.Options(second_derivatives=False)
    tols = ttypes.Tols.for_dtype(F64)
    _device.reset_readback_count()
    resident = solve_batched(tf, starts, dims, opts, tols, dtype=F64,
                             data=ys, device="cpu")
    assert _device.readback_count() == 1
    eager = solve_batched(tf, starts, dims, opts, tols, dtype=F64, data=ys,
                          device="cpu", graph=False)
    _same_bits(resident, eager)
    jtols = jtypes.Tols(*(jnp.float64(v) for v in (1e-10, REL, REL, REL,
                                                   REL)))
    jres = j_solve_batched(jf, starts, jtypes.Dims(10, 40, 0, 20),
                           jtypes.Options(second_derivatives=False), jtols,
                           data=ys)
    np.testing.assert_allclose(resident.f.numpy(), np.asarray(jres.f),
                               rtol=1e-8)
    conv = resident.exit_code.numpy() > 0
    np.testing.assert_array_equal(conv, np.asarray(jres.exit_code) > 0)
    np.testing.assert_allclose(resident.x.numpy()[conv],
                               np.asarray(jres.x)[conv], rtol=1e-6,
                               atol=1e-12)


# ------------------------------------------------------ EVADD, plain QRs

def _evadd_case(seed, l=14, n=5, q=1, batch=None):
    """More violated candidates than the capacity min(l, n) leaves."""
    rng = np.random.default_rng(700 + seed)
    shape = (l,) if batch is None else (batch, l)
    mask = np.zeros(shape, bool)
    mask[..., :q] = True
    rows = [mask] if batch is None else list(mask)
    for r in rows:
        r[q + rng.permutation(l - q)[:int(rng.integers(1, n))]] = True
    cx = rng.normal(size=shape) * 0.3
    cx[..., rng.permutation(l)[:6]] = -np.abs(rng.normal(size=6)) * 0.1
    cap = rng.integers(-1, l, size=() if batch is None else (batch,))
    return cx, mask, cap, n, q, l


@pytest.mark.parametrize("seed", range(6))
def test_evadd_device_loop_matches_reference(seed):
    cx, mask, cap, n, q, l = _evadd_case(seed)
    assert (~mask & (cx < 0)).sum() + mask.sum() > min(l, n)
    jm, jadd = jws.evaluate_violated_constraints(
        jnp.asarray(cx), jnp.asarray(mask), jnp.int32(int(cap)),
        jtypes.Dims(n, 4, q, l))
    args = (tt(cx), tt(mask), tt(cap), ttypes.Dims(n, 4, q, l))
    with _graph._mode("emulate"), _device.forbid_readbacks():
        tm, tadd = tws.evaluate_violated_constraints(*args)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(tadd) == bool(jadd)


def test_evadd_batched_device_loop_matches_each_lane():
    cx, mask, cap, n, q, l = _evadd_case(9, batch=6)
    args = (tt(cx), tt(mask), tt(cap), ttypes.Dims(n, 4, q, l))
    with _graph._mode("emulate"), _device.forbid_readbacks():
        tm, tadd = tws.evaluate_violated_constraints(*args)
    for b in range(6):
        jm, jadd = jws.evaluate_violated_constraints(
            jnp.asarray(cx[b]), jnp.asarray(mask[b]), jnp.int32(int(cap[b])),
            jtypes.Dims(n, 4, q, l))
        np.testing.assert_array_equal(tm[b].numpy(), np.asarray(jm))
        assert bool(tadd[b]) == bool(jadd)


@pytest.mark.parametrize("shape,nsteps", [((9, 6), 6), ((9, 6), 2),
                                          ((6, 9), 0), ((40, 25), 11)])
def test_b1_plain_version_takes_a_tensor_count(shape, nsteps):
    M = tt(np.random.default_rng(sum(shape) + nsteps).normal(size=shape))
    want = cpqr_packed_plain(M, nsteps)
    # a tensor count runs all kmax steps, those past it exact no-ops
    got = cpqr_packed_plain(M, torch.tensor(nsteps))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    f_int = cpqr_blocked(M, nsteps=nsteps, device="cpu")
    f_dev = cpqr_blocked(M, nsteps=torch.tensor(nsteps), device="cpu")
    for a, b in zip(f_int, f_dev):
        assert torch.equal(a, b)


def test_b2_plain_version_masks_without_a_readback():
    rng = np.random.default_rng(5)
    M = tt(rng.normal(size=(5, 12, 7)))
    steps = [7, 3, 0, 5, 7]
    want = cpqr_batched_packed_plain(M, steps)
    count = torch.tensor(steps)
    with _device.forbid_readbacks():
        got = cpqr_batched_packed_plain(M, count)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # all kmax steps, the masked ones no-ops: as on the card
    for row, k in enumerate(steps):
        one = cpqr_packed_plain(M[row], k)
        assert torch.equal(want[1][row, k:], torch.zeros_like(want[1][row, k:]))
        assert torch.equal(want[2][row], one[2])


@pytest.mark.parametrize("m,n", [(3000, 12), (700, 30), (60, 40)])
def test_householder_loop_is_geqrf(m, n):
    """The card's tall QR (blocked reflector steps; cuSOLVER's geqrf of
    more than 4,096 rows cannot be captured in a conditional body) gives
    LAPACK's reflectors, tau and R, over one panel and over several."""
    from enlsip_tpu_torch.ops.tsqr import _householder_thin
    M = tt(np.random.default_rng(m + n).normal(size=(m, n)))
    M[:, 3] = 0.0                       # a zero column: tau = 0
    V, tau, r = _householder_thin(M)
    a, tau0 = torch.geqrf(M)
    V0 = torch.tril(a, -1)
    V0.diagonal().fill_(1.0)
    scale = float(M.abs().max())
    assert float((tau - tau0).abs().max()) <= 1e-13
    assert float((V - V0).abs().max()) <= 1e-12
    assert float((r - torch.triu(a[:n])).abs().max()) <= 1e-12 * scale


# ------------------------------------------------- the forbidding scope

def test_forbid_readbacks_raises_on_every_host_read():
    t = torch.arange(4.0)
    with _device.forbid_readbacks():
        for bad in (lambda: _device.to_host(t[0]),
                    lambda: _device.to_host_list(t),
                    lambda: t.sum().item(), lambda: bool(t[1] > 0),
                    lambda: torch.nonzero(t), lambda: t[t > 1],
                    lambda: torch.as_tensor([1.0, 2.0])):
            with pytest.raises(_device.ReadbackError):
                bad()
        assert _device.flag_value(t[1] > 0) is True
        assert _device.cpu_int(torch.tensor(3)) == 3
        t2 = t.clone()
        t2[1:] = 5.0                # a slice filled by a number: a fill
        with pytest.raises(_device.ReadbackError):
            t2[0] = 5.0             # one element: a copy of host data
        with pytest.raises(_device.ReadbackError):
            t2[torch.tensor([0, 2])] = 5.0
    assert _device.to_host(t[2]) == 2.0


def test_control_flow_helpers_in_a_rehearsal():
    x, two = torch.tensor([1.0, -2.0, 3.0]), torch.tensor(2)
    with _graph._mode("emulate"), _device.forbid_readbacks():
        c = _lanes.cond(x.sum() > 0, lambda: x * 2, lambda: x)
        sw = _lanes.switch(two, [lambda: x, lambda: x + 1, lambda: x + 2])
        y, k = _lanes.while_loop(lambda s: s[0].abs().sum() < 50,
                                 lambda s: (s[0] * 2, s[1] + 1), (x, 0))
        per_lane = _lanes.while_loop(lambda s: s < 10, lambda s: s * 3 + 1,
                                     x.abs())
        with pytest.raises(TypeError):
            _lanes.while_loop(lambda s: s.sum() < 10,
                              lambda s: s.to(torch.float32) + 1,
                              torch.zeros(2, dtype=F64))
    assert torch.equal(c, x * 2) and torch.equal(sw, x + 2)
    assert int(k) == 4 and torch.equal(y, x * 16)
    assert torch.equal(per_lane, torch.tensor([13.0, 22.0, 10.0]))


def test_loop_state_keeps_the_closures_layout():
    """A column-major leaf stays column-major through the loop (the eager
    loop hands cuBLAS what the closure returned); a broadcast leaf, as a
    lane-mapped constant Jacobian comes, is made dense at entry, so the
    first trip reads what the later ones read."""
    J = torch.arange(6.0, dtype=F64).reshape(3, 2).t().contiguous().t()
    A = torch.ones(3, 2, dtype=F64).expand(4, 3, 2)
    lanes = torch.tensor([True, True, False, True])
    with _graph._mode("emulate"), _device.forbid_readbacks():
        Jo, k = _lanes.while_loop(lambda s: s[1] < 3,
                                  lambda s: (s[0] * 2 + 1, s[1] + 1), (J, 0))
        Ao = _lanes.while_loop(lambda s: lanes & (s.sum(dim=(1, 2)) < 20),
                               lambda s: s * 2, A)
    assert Jo.stride() == J.stride() and int(k) == 3
    assert torch.equal(Jo, J * 8 + 7)
    assert Ao.stride() == (6, 2, 1)
    assert torch.equal(Ao[:, 0, 0], torch.tensor([4.0, 4.0, 1.0, 4.0],
                                                 dtype=F64))


# ----------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: a captured CUDA graph has "
                    "no CPU form")


@pytest.mark.gpu
def test_captured_single_solve_replays_to_the_same_bits():
    """Needs the card and nvcc (run with ``pytest -m gpu``)."""
    _needs_card()
    from enlsip_tpu_torch.problems import classic as tprob
    tm = et.CnlsModel(**tprob.HS65)
    fns = tdrv.Functions(*t_model_functions(tm, F64, "cuda"))
    args = (fns, tm.starting_point, ttypes.Dims(3, 3, 0, 7), ttypes.Options(),
            ttypes.Tols.for_dtype(F64, "cuda"))
    eager = tdrv.solve(*args, dtype=F64, graph=False)
    _device.reset_readback_count()
    first = tdrv.solve(*args, dtype=F64)
    second = tdrv.solve(*args, dtype=F64)
    assert _device.readback_count() == 2
    for r in (first, second):
        assert torch.equal(r.x, eager.x) and r.exit_code == eager.exit_code
        assert tuple(r.counters) == tuple(eager.counters)


@pytest.mark.gpu
def test_captured_batch_replays_to_the_same_bits():
    """Needs the card and nvcc (run with ``pytest -m gpu``)."""
    _needs_card()
    _, tf, starts, (n, m, q, l) = hs65_batch_setup(64, seed=2)
    from enlsip_tpu_torch.problems import classic as tprob
    tf = tdrv.Functions(*t_model_functions(et.CnlsModel(**tprob.HS65), F64,
                                           "cuda"))
    args = (tf, starts, ttypes.Dims(n, m, q, l), ttypes.Options(),
            ttypes.Tols.for_dtype(F64, "cuda"))
    eager = solve_batched(*args, dtype=F64, graph=False)
    for _ in range(2):
        _same_bits(solve_batched(*args, dtype=F64), eager)
