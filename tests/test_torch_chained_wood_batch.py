"""Chained Wood n = 20 as scenario batches (the benchmark's
``wood20.f64.b65536`` cell at a size the CPU holds), float64, no JAX.

- The benchmark's plain reference (``portbench/reference/chained_wood.py``)
  against the port's own problem (``problems/classic.py``) and the
  configuration's closures, and its derivatives against autograd.
- A 16-lane rehearsal of the cell, traced: every lane within the cell's
  limits at f* = 474.2585640745832, and the ``newton``, ``hessian`` and
  ``subspace`` spans of the lockstep body: their payloads sum to the lanes
  that took code 2 and code -1, ``hessian`` nests inside ``newton``, and
  the readers of the cell read them.  The float32 control fails the limits.
- Tracing off: no stamp runs and no payload is counted, and the
  device-resident loop equals the eager loop to the bit.
"""

import io
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import enlsip_tpu_torch as et  # noqa: E402
from enlsip_tpu_torch._device import cpu_int  # noqa: E402
from enlsip_tpu_torch.core import batched as tbat  # noqa: E402
from enlsip_tpu_torch.problems import classic  # noqa: E402
from enlsip_tpu_torch.utils import profiling  # noqa: E402
from portbench import entries, generate, harness  # noqa: E402

from torch_port_helpers import CPU, F64  # noqa: E402

WORKLOAD = "wood20.f64.b65536"
F_STAR = 474.2585640745832
LANES = 16
SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def cell():
    return harness.Cell(WORKLOAD)


def _points(prob, k=5, seed=7):
    rng = np.random.default_rng(seed)
    return torch.tensor(prob["x0"] + 0.3 * rng.normal(size=(k, prob["n"])),
                        dtype=F64)


def test_reference_equations_agree_with_the_port_and_the_closures(cell):
    ref = cell.reference
    prob = cell.problem_module.problem(F64, CPU)
    kw = classic.chained_wood(20)
    assert (prob["n"], prob["m"], prob["q"]) == (kw["nb_parameters"],
                                                 kw["nb_residuals"],
                                                 kw["nb_eqcons"])
    np.testing.assert_array_equal(prob["x0"], kw["starting_point"])
    X = _points(prob)
    R = ref.residuals(X)
    for x, r_ref, f, g, c, A in zip(X, R, ref.objective(X), ref.gradient(X),
                                    ref.constraints(X),
                                    ref.constraint_jacobian(X)):
        r = prob["res"](x)
        # the reference holds its residuals block after block, the port
        # residual kind after residual kind
        by_kind = r_ref.reshape(9, 6).T.reshape(-1)
        torch.testing.assert_close(by_kind, kw["residuals"](x), rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(by_kind, r, rtol=1e-12, atol=1e-12)
        assert float(f) == pytest.approx(float(r @ r), rel=1e-12)
        J = prob["jac_res"](x)
        torch.testing.assert_close(g, 2.0 * J.T @ r, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(c, kw["eq_constraints"](x), rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(c, prob["eq"](x), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(A, prob["jac_eq"](x), rtol=1e-12,
                                   atol=1e-12)


def test_reference_derivatives_agree_with_autograd(cell):
    ref = cell.reference
    X = _points(cell.problem_module.problem(F64, CPU), seed=11)
    Xg = X.clone().requires_grad_(True)
    (g_auto,) = torch.autograd.grad(ref.objective(Xg).sum(), Xg)
    torch.testing.assert_close(ref.gradient(X), g_auto, rtol=1e-12,
                               atol=1e-12)
    for x, A in zip(X, ref.constraint_jacobian(X)):
        A_auto = torch.autograd.functional.jacobian(
            lambda z: ref.constraints(z[None])[0], x)
        torch.testing.assert_close(A, A_auto, rtol=1e-12, atol=1e-12)


def _rehearse(cell, monkeypatch, dtype=None, trace=False):
    """A run of the cell on the CPU at 16 lanes; returns the result and
    every batch's answers."""
    answers = []
    call = entries.BatchEntry.call

    def keep(self, x0):
        got = call(self, x0)
        answers.append((got["x"], got["f"]))
        return got
    monkeypatch.setattr(entries.BatchEntry, "call", keep)
    cell.traffic["lanes"] = LANES
    cell.traffic["traced_calls"] = 1
    got = harness.run_cell(WORKLOAD, SEED, 0.5, trace, time.perf_counter(),
                           device="cpu", dtype=dtype, cell=cell,
                           log=io.StringIO())
    return got, answers


def test_rehearsal_is_correct_and_spans_count_the_sections(cell,
                                                           monkeypatch):
    counted = {"newton": 0, "subspace": 0}
    decide = tbat.analysis_decide
    direction = tbat.batched_direction_analysis
    seen = {}

    def record_code(*a, **k):
        mc, beta = decide(*a, **k)
        seen["mc"] = mc
        return mc, beta

    def count_lanes(x, rx, cx, active_cx_sum, wsr, alive, *a, **k):
        ana = direction(x, rx, cx, active_cx_sum, wsr, alive, *a, **k)
        # cpu_int: a count on the CPU that the rehearsal's ban on
        # read-backs lets through
        counted["newton"] += cpu_int(((ana.code == 2) & alive).sum())
        counted["subspace"] += cpu_int(((seen["mc"] == -1) & alive).sum())
        return ana
    monkeypatch.setattr(tbat, "analysis_decide", record_code)
    monkeypatch.setattr(tbat, "batched_direction_analysis", count_lanes)
    profiling.clear()
    got, answers = _rehearse(cell, monkeypatch, trace=True)

    assert got["correct"], got["checks"]
    assert got["attempted"] >= 2 * LANES      # the window, the traced call
    f = torch.cat([torch.as_tensor(a[1]) for a in answers])
    assert f.numel() >= 4 * LANES      # set-up (2), window, traced call
    assert float((f - F_STAR).abs().max()) <= 1e-9

    recs = profiling.spans()
    payloads = {name: [r.payload for r in recs if r.name == name]
                for name in ("newton", "subspace")}
    assert counted["newton"] > 0 and counted["subspace"] > 0
    for name, values in payloads.items():
        assert values and None not in values
        assert sum(values) == counted[name], name
    hessians = [r for r in recs if r.name == "hessian"]
    assert len(hessians) == len(payloads["newton"])
    for r in hessians:
        outer = recs[r.parent]
        assert outer.name == "newton"
        assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
    for name in ("newton_ms.batch", "hessian_ms.batch", "subspace_ms.batch",
                 "newton_lanes.batch"):
        assert got["metrics"][name]["value"] > 0, name


def test_float32_control_fails_the_limits(cell, monkeypatch):
    got, _ = _rehearse(cell, monkeypatch, dtype="float32")
    assert got["attempted"] >= LANES
    assert not got["correct"], got["checks"]


def test_untraced_graph_equals_the_eager_loop_and_stamps_nothing(
        cell, monkeypatch):
    prob = cell.problem_module.problem(F64, CPU)
    entry = entries.make(et, "solve_batched", prob, F64, CPU,
                         cell.config["options"], 6)
    x0 = generate.Starts(prob["x0"], 0.3, SEED, 6).next()
    counts = []
    lane_count = tbat._lane_count
    monkeypatch.setattr(tbat, "_lane_count",
                        lambda pred: counts.append(1) or lane_count(pred))
    profiling.clear()
    profiling.enable(False)
    try:
        outs = [entry.solve_batched(entry.fns, x0, entry.dims, entry.opts,
                                    entry.tols, dtype=F64, device=CPU,
                                    graph=graph) for graph in (True, False)]
    finally:
        profiling.enable(None)
    assert profiling.spans() == [] and counts == []
    a, b = outs
    assert torch.equal(a.exit_code, b.exit_code)
    assert torch.equal(a.n_iter, b.n_iter)
    assert torch.equal(a.x, b.x) and torch.equal(a.f, b.f)
    assert (a.exit_code != 0).all()
