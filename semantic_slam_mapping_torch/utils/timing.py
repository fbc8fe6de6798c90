"""Per-stage host timing, and the profiler ranges the stages open.

Counterpart of ``semantic_slam_mapping_tpu/utils/timing.py`` with the same
stage names and summary. Device work is asynchronous, so a stage's time is
the host time to queue it; the timer never synchronises, so
``process_stream`` keeps its overlap. A stage whose work is a host wait on
the device is named ``sync/<site>`` and holds that call alone.

``span(name)`` opens ``torch.profiler.record_function(name)`` while a
profiler runs and does nothing otherwise (one flag check, where an open
range costs microseconds). Every stage opens a span of its own name; a leaf
span (a bounded piece of work inside a stage) adds nothing to the timer.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict

import torch

_profiling = torch._C._autograd._profiler_enabled
_OFF = nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler is active, else a
    no-op context."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


class StageTimer:
    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.max: Dict[str, float] = defaultdict(float)

    @contextmanager
    def stage(self, name: str):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.total[name] += dt
                self.max[name] = max(self.max[name], dt)
                self.count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": self.total[name], "calls": self.count[name],
                   "mean_ms": (1e3 * self.total[name]
                               / max(self.count[name], 1)),
                   "max_ms": 1e3 * self.max[name]}
            for name in self.total
        }

    def report(self) -> str:
        return "\n".join(
            f"{name:24s} {s['calls']:5d} calls  "
            f"{s['mean_ms']:8.2f} ms/call  {s['max_ms']:8.0f} max  "
            f"{s['total_s']:7.2f} s total"
            for name, s in sorted(self.summary().items()))
