"""Per-stage host timing and counters.

Counterpart of ``semantic_slam_mapping_tpu/utils/timing.py`` with the same
stage names and summary. Device work is asynchronous, so a stage's time is
the host time to queue it unless the caller asks for a synchronisation:
pass the stage's output as ``block`` (or store it in the yielded holder as
``holder["out"]``) and the timer waits for the card before it stops. It
never synchronises otherwise, so ``process_stream`` keeps its overlap.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict

import torch


def _wait_for(out: Any) -> None:
    """Wait for the devices that hold the tensors of ``out`` (a tensor or
    a nest of tuples, lists and dicts of them)."""
    stack, devices = [out], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StageTimer:
    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.max: Dict[str, float] = defaultdict(float)
        self.counters: Dict[str, float] = defaultdict(float)

    @contextmanager
    def stage(self, name: str, block: Any = None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            out = holder.get("out", block)
            if out is not None:
                _wait_for(out)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.max[name] = max(self.max[name], dt)
            self.count[name] += 1

    def add(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": self.total[name], "calls": self.count[name],
                   "mean_ms": (1e3 * self.total[name]
                               / max(self.count[name], 1)),
                   "max_ms": 1e3 * self.max[name]}
            for name in self.total
        }

    def report(self) -> str:
        lines = [f"{name:24s} {s['calls']:5d} calls  "
                 f"{s['mean_ms']:8.2f} ms/call  {s['max_ms']:8.0f} max  "
                 f"{s['total_s']:7.2f} s total"
                 for name, s in sorted(self.summary().items())]
        lines += [f"{k:24s} {v:g}" for k, v in sorted(self.counters.items())]
        return "\n".join(lines)
