"""On the card, at each cell's own size: the control (the port at float32
in place of the configuration's float64) comes out not correct on three
seeds, and the cell itself correct.  Both start every call from a fresh
point drawn from the seed, also in a mix that cycles through a fixed pool
of starts, so that points outside the pool are judged.  Marked ``gpu``;
skipped where there is no CUDA device.  Run on the card with

    python -m pytest -o addopts='' portbench/tests -m gpu
"""

from __future__ import annotations

import io
import json
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CONTROL_SEEDS = (2 ** 31 + 101, 3 * 10 ** 9 + 7, 4 * 10 ** 9 + 9)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_cell_holds_on_the_card(card, workload):
    from portbench import harness
    cell = harness.Cell(workload)
    cell.traffic = {k: v for k, v in cell.traffic.items()
                    if k not in ("pool", "pool_seed")}
    seconds = 3.0
    control = harness.Session(cell, "cuda", "float32")
    for seed in CONTROL_SEEDS:
        got = control.run(seed, seconds, False, time.perf_counter(),
                          log=io.StringIO())
        assert got["attempted"] > 0
        assert not got["correct"], (seed, got["checks"])
    del control
    sound = harness.Session(cell, "cuda")
    got = sound.run(CONTROL_SEEDS[0] + 1, seconds, False, time.perf_counter(),
                    log=io.StringIO())
    assert got["correct"], got["checks"]
