"""The device trace of a few calls: ``torch.profiler`` with CUDA activity,
read in memory (nothing is written to disk).

``Profiler.trace(fn)`` runs ``fn`` under the profiler and returns what the
metric readers need: every kernel that ran on the card (name, start and
end in microseconds on the trace's clock), every host operation (for
naming the gaps between kernels), and the traced window's wall time.
"""

from __future__ import annotations

import re
import time

import torch


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = re.sub(r"^void\s+", "", name)
    for prefix in ("(anonymous namespace)::", "at::native::"):
        name = name.replace(prefix, "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:80]


class Trace:
    def __init__(self, kernels, device_ops, host_ops, wall_s):
        self.kernels = kernels          # [(name, start_us, end_us)]
        self.device_ops = device_ops    # kernels, copies and sets alike
        self.host_ops = host_ops        # [(name, start_us, end_us)]
        self.wall_s = wall_s

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the card (the union of
        the device operations' intervals)."""
        total, end = 0.0, None
        for _, s, e in sorted(self.device_ops, key=lambda k: k[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-6

    def top_ops(self, k=10):
        by = {}
        for name, s, e in self.device_ops:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (e - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()), key=lambda r: -r[1])[:k]

    def idle_gaps(self, k=10):
        """The longest gaps between device operations, each named by the
        innermost host operation running at its middle and the device
        operation that ended it."""
        ops = sorted(self.device_ops, key=lambda o: o[1])
        gaps, end = [], None
        for name, s, e in ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s, name))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: -g[0])
        out = []
        for dur, a, b, nxt in gaps[:k]:
            mid = 0.5 * (a + b)
            inside = [h for h in self.host_ops if h[1] <= mid <= h[2]]
            host = min(inside, key=lambda h: h[2] - h[1])[0] if inside \
                else "python"
            out.append([f"host {host[:40]} before {short_name(nxt)}",
                        dur * 1e-6])
        return out


MARK = "portbench.traced_calls"


class Profiler:
    """ONE profiler session for a traced run: opened before the graph is
    captured, collection off through the measured window, on for the
    traced calls only (:meth:`trace`), then closed.

    Why one session: CUPTI records only a small part of a graph captured
    before the process's first profiler session (on an H100, a cr1000.f64
    replay: 2,328 of 14,714 kernels, 1 of B1's 14 launches), and a later
    session over the port's conditional graphs recorded 2,685 of some
    347,000 kernels, or faulted.  ``cuda`` False: host activity alone, for a
    rehearsal on the CPU, which traces no kernel."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile as torch_profile
        self.cuda = cuda
        self.activities = [ProfilerActivity.CPU]
        if cuda:
            self.activities.append(ProfilerActivity.CUDA)
        self.prof = torch_profile(activities=self.activities)
        self.prof.start()
        self.prof.toggle_collection_dynamic(False, self.activities)

    def trace(self, fn) -> Trace:
        """Run ``fn`` with collection on, close the session and return
        the trace of ``fn`` alone (the events inside its marker)."""
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.toggle_collection_dynamic(True, self.activities)
        t0 = time.perf_counter()
        with torch.profiler.record_function(MARK):
            fn()
            if self.cuda:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.prof.stop()
        events = list(self.prof.profiler.kineto_results.events())
        marks = [(e.start_ns(), e.end_ns()) for e in events if e.name() == MARK]
        lo, hi = marks[0] if marks else (float("-inf"), float("inf"))
        kernels, device_ops, host_ops = [], [], []
        for evt in events:
            if evt.name() == MARK or not lo <= evt.start_ns() <= hi:
                continue
            row = (evt.name(), evt.start_ns() * 1e-3, evt.end_ns() * 1e-3)
            if evt.device_type() == torch.autograd.DeviceType.CPU:
                host_ops.append(row)
            elif not evt.is_user_annotation():
                # on the card: kernels, and the copies and sets named
                # Memcpy / Memset
                device_ops.append(row)
                if not row[0].startswith(("Memcpy", "Memset")):
                    kernels.append(row)
        return Trace(kernels, device_ops, host_ops, wall)
