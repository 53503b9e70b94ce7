"""BENCHMARK.json against the benchmark's contract, and the harness
finding what a cell needs by name."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["portbench"]
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    for word in MANIFEST["command"]:
        assert ONE_LINE.match(word) and not word.startswith("/")
        assert ".." not in word


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and ONE_LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert ONE_LINE.match(m["layer"])
        names.append(m["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def _reports(cell):
    return {m["name"] for m in MANIFEST["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_every_moved_metric_is_reported_where_its_reader_reads():
    cells = [w["name"] for w in MANIFEST["workloads"]]
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in _reports(cell), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in MANIFEST["workloads"]:
        got = _reports(w["name"])
        assert "setup_s" in got and len(got) >= 2
        layers = [m for m in MANIFEST["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert layers


@pytest.mark.parametrize("workload",
                         [w["name"] for w in MANIFEST["workloads"]])
def test_cell_loads_by_name(workload):
    cell = harness.Cell(workload)
    assert cell.limits and cell.traffic["entry"] in ("solve", "solve_batched")
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    for reader in cell.readers.values():
        assert callable(reader.read)


def test_a_new_cell_is_found_with_no_edit(tmp_path):
    """A configuration, a traffic mix, a metric and a cell's limits added
    as files, with entries added to a copy of the manifest, load without
    an edit to any file that was there."""
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "configs" / "dummy.json").write_text(
        json.dumps({"dtype": "float64", "options": {"max_iter": 5}}))
    (base / "configs" / "dummy.py").write_text(
        "def problem(dtype, device):\n    return {'n': 1}\n")
    (base / "reference" / "dummy.py").write_text(
        "def objective(X):\n    return X.sum(1)\n")
    (base / "traffic" / "dummy_mix.json").write_text(
        json.dumps({"entry": "solve", "start_noise": 0.0}))
    (base / "reference" / "limits" / "dummy.cell.json").write_text(
        json.dumps({"f_gap": 0.0}))
    (base / "metrics" / "dummy.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "dummy", "source": "x",
                                "file": "portbench/configs/dummy.json",
                                "reduced": [], "why": "x"})
    manifest["workloads"].append({"name": "dummy.cell", "config": "dummy",
                                  "traffic": "dummy_mix", "chips": 1,
                                  "why": "x"})
    manifest["per_layer"].append({"name": "dummy.metric", "unit": "count",
                                  "better": "lower", "source": "host_clock",
                                  "layer": "device", "moves": "setup_s",
                                  "workloads": ["dummy.cell"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    cell = harness.Cell("dummy.cell", manifest_path=path, base=base)
    assert cell.problem_module.problem(None, None) == {"n": 1}
    assert cell.traffic["entry"] == "solve"
    assert cell.limits == {"f_gap": 0.0}
    assert cell.readers["dummy.metric"].read(None) == 42.0
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert {p: p.read_bytes() for p in before} == before
