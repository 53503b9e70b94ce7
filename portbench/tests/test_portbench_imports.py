"""Nothing of JAX or of the JAX package is loaded by a run: after a
rehearsal in a fresh process, no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``enlsip_tpu`` is in ``sys.modules`` (compared
whole: ``enlsip_tpu_torch`` is the port and allowed); nor does anything
under the benchmark's folder read the JAX package's benchmarks, the
smoke script or the repository's tests."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import io, json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from portbench import harness
for wl, sizes in (("cr1000.f64", {{"n": 12}}), ("hs65.f64.b4096", {{}})):
    cell = harness.Cell(wl)
    cell.traffic["traced_calls"] = 1
    if wl.startswith("hs65"):
        cell.traffic["lanes"] = 4
    r = harness.run_cell(wl, 3, 0.2, True, time.perf_counter(),
                         device="cpu", sizes=sizes, cell=cell,
                         log=io.StringIO())
    assert r["attempted"] > 0
print(json.dumps({{"loaded": harness.forbidden_loaded(),
                   "port": "enlsip_tpu_torch" in sys.modules}}))
"""


def test_no_jax_after_a_rehearsal():
    out = subprocess.run([sys.executable, "-c",
                          SCRIPT.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"loaded": [], "port": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "enlsip_tpu_torch_shadow", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert "enlsip_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "enlsip_tpu.core", sys)
    assert "enlsip_tpu" in harness.forbidden_loaded()


def test_sources_name_no_jax_bench_smoke_or_tests():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|enlsip_tpu)\b"
                         r"(?!_torch)|bench\.py|chip_smoke|benchmarks/",
                         re.M)
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        assert not pattern.search(path.read_text()), path
