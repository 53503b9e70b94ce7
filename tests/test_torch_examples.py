"""The PyTorch port's examples (``examples/torch_*.py``, twins of the JAX
package's examples) run on the CPU at a small size with ``--device cpu``
and print the outcome their JAX twins print; without ``--device cpu``
they raise here, where there is no card, instead of falling back to the
CPU.  The twins of the examples that take no size argument
(``single_solve``, ``multistart``, ``checkpoint_resume``) are held
against their JAX example, run as it is on the same inputs: exit code, x
and f."""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (one torch thread a worker)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

# example, its arguments at a small size
RUNS = {
    "torch_single_solve": [],
    "torch_batched_scenarios": ["--batch", "32"],
    "torch_multistart": [],
    "torch_checkpoint_resume": [],
    "torch_giant_m": ["--rows", "20000"],
    "torch_mixed_suite": ["--per-family", "8"],
}


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_example(name, **patches):
    """Run the JAX example ``name`` as it is, with the module attributes
    in ``patches`` replaced (each a recorder around the original), its
    floats printed at full precision; returns its standard output."""
    mod = _load(name)
    for attr, wrap in patches.items():
        setattr(mod, attr, wrap(getattr(mod, attr)))
    out = io.StringIO()
    with np.printoptions(precision=17, floatmode="unique"), \
            contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def _recorder(into):
    def wrap(fn):
        def call(*args, **kwargs):
            into.append((args, fn(*args, **kwargs)))
            return into[-1][1]
        return call
    return wrap


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _number(pattern, text):
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return float(m.group(1))


def test_single_solve(capsys, monkeypatch):
    import enlsip_tpu
    import enlsip_tpu_torch as et
    model = _load("torch_single_solve").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "status: found_first_order_stationary_point" in out
    assert abs(_number(r"objective: ([0-9.eE+-]+)", out) - 0.9535288567) < 1e-6
    # the JAX example at the same dtype (float64: the tests enable x64)
    solved = []
    monkeypatch.setattr(enlsip_tpu, "solve",
                        _recorder(solved)(enlsip_tpu.solve))
    _run_jax_example("single_solve")
    jm = solved[0][1]
    assert np.asarray(enlsip_tpu.solution(jm)).dtype == np.float64
    assert model.status_code == jm.status_code
    assert _rel(et.solution(model), enlsip_tpu.solution(jm)) <= 1e-9
    assert abs(et.sum_sq_residuals(model) - enlsip_tpu.sum_sq_residuals(jm)) \
        <= 1e-12 * enlsip_tpu.sum_sq_residuals(jm)


def test_batched_scenarios(capsys):
    share = _load("torch_batched_scenarios").main(
        ["--device", "cpu"] + RUNS["torch_batched_scenarios"])
    out = capsys.readouterr().out
    assert "32 instances (per-lane observations)" in out
    assert share >= 0.95 and f"{share:.1%}" in out


def test_multistart(capsys):
    ms = _load("torch_multistart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    # lane 0 at the alternate point, the best lane at the published f*
    assert abs(_number(r"lane 0\):\s+f = ([0-9.]+)", out) - 4.941) < 1e-3
    assert abs(_number(r"converged lanes: f = ([0-9.]+)", out)
               - 0.0504261879) < 1e-5
    assert int(ms.exit_code) > 0
    # the JAX example: the same 16 starts at float32, escalated lanes at
    # float64
    got = []
    _run_jax_example("multistart", solve_multistart=_recorder(got))
    jms = got[0][1]
    assert int(ms.exit_code) == int(jms.exit_code)
    assert _rel(ms.x, jms.x) <= 1e-5
    assert abs(float(ms.f) - float(jms.f)) <= 1e-5 * float(jms.f)
    assert _rel(ms.batch.f, jms.batch.f) <= 1e-5


def test_checkpoint_resume(capsys):
    resumed = _load("torch_checkpoint_resume").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "after 3 iterations" in out and "checkpointed to" in out
    assert int(resumed.exit_code) > 0
    assert abs(_number(r"f = ([0-9.]+)", out) - 0.9535289) < 1e-4
    # the JAX example (float32): its last line prints exit code, x and f
    line = _run_jax_example("checkpoint_resume").strip().splitlines()[-1]
    m = re.fullmatch(r"resumed -> exit (\d+), x = \[(.*)\], f = ([0-9.]+)",
                     line)
    assert m, line
    assert int(resumed.exit_code) == int(m.group(1))
    assert _rel(resumed.x, np.array(m.group(2).split(), float)) <= 1e-5
    f = float(resumed.rx @ resumed.rx)
    assert abs(f - float(m.group(3))) <= 1e-6


def test_giant_m(capsys):
    res, active = _load("torch_giant_m").main(
        ["--device", "cpu"] + RUNS["torch_giant_m"])
    out = capsys.readouterr().out
    assert "20,000 rows x 100 params, 20 constraints" in out
    assert res.exit_code > 0 and active >= 5
    assert _number(r"x_true\|\| = ([0-9.]+)", out) < 0.2


def test_mixed_suite(capsys):
    shares = _load("torch_mixed_suite").main(
        ["--device", "cpu"] + RUNS["torch_mixed_suite"])
    out = capsys.readouterr().out
    assert "40 instances across 5 families in one batch" in out
    assert min(shares.values()) >= 0.95, shares


@pytest.mark.parametrize("name", sorted(RUNS))
def test_no_card_and_no_cpu_flag_raises(name):
    """Where there is no card the default device is refused, not
    replaced by the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        _load(name).main(RUNS[name])
