"""The plain reference: its equations against the configurations' own
closures, and its judgement of answers at float64 and float32."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference.judge import judge

CONFIGS = {"chained_rosenbrock": {"n": 9}, "hs65": {}}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_reference_equations_agree_with_the_closures(config):
    cell = next(harness.Cell(w["name"]) for w in
                harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]
                if w["config"] == config)
    prob = cell.problem_module.problem(torch.float64, "cpu",
                                       **CONFIGS[config])
    ref = cell.reference
    rng = np.random.default_rng(7)
    X = torch.tensor(prob["x0"] + 0.3 * rng.normal(size=(5, prob["n"])))
    for x, f, g, c, A in zip(X, ref.objective(X), ref.gradient(X),
                             ref.constraints(X), ref.constraint_jacobian(X)):
        r = prob["res"](x)
        J = prob["jac_res"](x)
        assert float(f) == pytest.approx(float(r @ r), rel=1e-13)
        torch.testing.assert_close(g, 2.0 * J.T @ r, rtol=1e-12, atol=1e-12)
        parts, jparts = [], []
        for fn, jn in (("eq", "jac_eq"), ("ineq", "jac_ineq")):
            if prob[fn] is not None:
                parts.append(torch.atleast_1d(prob[fn](x)))
                jparts.append(torch.atleast_2d(prob[jn](x)))
        if prob["x_low"] is not None:
            lo, up = torch.tensor(prob["x_low"]), torch.tensor(prob["x_upp"])
            parts += [x - lo, up - x]
            eye = torch.eye(prob["n"], dtype=x.dtype)
            jparts += [eye, -eye]
        torch.testing.assert_close(c, torch.cat(parts), rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(A, torch.cat(jparts), rtol=1e-12,
                                   atol=1e-12)
        # the closures' Jacobians against their own forward derivatives
        torch.testing.assert_close(J, torch.func.jacfwd(prob["res"])(x))


def test_judge_holds_a_kkt_point_and_rejects_its_float32_rounding():
    from portbench.reference import hs65 as ref
    xs = torch.tensor([[3.650461821, 3.65046168, 4.6204170507]],
                      dtype=torch.float64)
    # polish the published optimum onto the sphere 48 = |x|^2
    xs = xs * torch.sqrt(48.0 / (xs * xs).sum())
    got = judge(ref, xs, ref.objective(xs), "cpu")
    assert got["c_viol"].max() < 1e-13 and got["f_gap"].max() < 1e-15
    # the published optimum holds about seven digits
    assert got["kkt"].max() < 1e-5
    x32 = xs.float().double()
    got32 = judge(ref, x32, ref.objective(x32).float().double(), "cpu")
    assert got32["f_gap"].max() > 1e-9 or got32["c_viol"].max() > 1e-9


@pytest.mark.parametrize("workload", ["cr1000.f64", "hs65.f64.b4096"])
def test_plain_reference_rejects_a_float32_answer(rehearse, workload):
    """The control: the port at float32 in place of the configuration's
    float64 comes out not correct; the same run at float64 is correct."""
    ok = rehearse(workload)
    assert ok["correct"], ok["checks"]
    bad = rehearse(workload, dtype="float32")
    assert not bad["correct"], bad["checks"]
