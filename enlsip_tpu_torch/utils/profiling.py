"""Tracing / profiling hooks.

Counterpart of ``enlsip_tpu/utils/profiling.py``.  The reference's
observability is wall-clock timing and evaluation counters (both kept in
``ExecutionInfo``); this module adds the device side: a
``torch.profiler`` trace, named ranges that show on the card's timeline,
and a host-side stage timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree


@contextlib.contextmanager
def trace(dir_path: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card; on exit it is written to ``dir_path/trace.json``
    (Chrome trace format: chrome://tracing or Perfetto).  Yields the
    profiler (``key_averages()`` for sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dir_path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dir_path, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region: a ``record_function`` range in a profiler trace and,
    where there is a card, an NVTX range on its timeline."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _on_card(result) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in pytree.tree_leaves(result))


class StageTimer:
    """Host-side cumulative stage timer.  A stage given a ``result`` on
    the card waits for the card (``torch.cuda.synchronize()``) before it
    stops the clock, so the time covers the work and not its enqueue."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result is not None and _on_card(result):
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{k:30s} {self.totals[k]:9.4f}s / {self.counts[k]}"
                 for k in sorted(self.totals, key=self.totals.get,
                                 reverse=True)]
        return "\n".join(lines)
