"""Fixtures of the benchmark's tests.

``rehearse`` drives a whole run of a cell on the CPU (the port's plain
kernels, the graph's rehearsal) at a size a test can hold, skipping only
the run's look for a card.  ``card`` skips a test where there is no CUDA
device; it decides when the test runs, not when the module is imported.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# sizes a test on the CPU can hold, one for each cell
SMALL = {"cr1000.f64": {"n": 20}, "cr5000.f64": {"n": 24},
         "hs65.f64.b4096": {"lanes": 16}}


@pytest.fixture
def rehearse():
    import io

    import torch
    from portbench import harness

    def run(workload, seed=2 ** 31 + 11, seconds=0.5, dtype=None,
            trace=False):
        torch.set_num_threads(1)
        cell = harness.Cell(workload)
        sizes = dict(SMALL[workload])
        if "lanes" in sizes:
            cell.traffic["lanes"] = sizes.pop("lanes")
        cell.traffic["traced_calls"] = 1
        return harness.run_cell(workload, seed, seconds, trace,
                                time.perf_counter(), device="cpu",
                                dtype=dtype, sizes=sizes, cell=cell,
                                log=io.StringIO())
    return run


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
