"""The profiled stretch of a traced run and what is read from it.

A stretch is a few steps in the middle of the measured window under
``torch.profiler`` (CPU and CUDA activities), opened after a synchronise
and closed after another, inside a ``record_function`` span whose start and
end bound it on the profiler's clock. The device is busy where any device
activity (a kernel, a copy or a memset) runs: the union of their intervals,
so that overlapping work is counted once.
"""

from __future__ import annotations

import bisect
import subprocess
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPAN = "slambench.stretch"
_COPY_PREFIXES = ("Memcpy", "Memset")


@dataclass
class TraceData:
    """What the per-layer readers get: the stretch's length, the device's
    busy time, the kernels by name, the count of kernel launches that ran,
    and the cell's counters (frames, images, stage seconds...) as their
    change over the stretch."""

    window_s: float
    busy_s: float
    n_kernels: int
    kernel_s: Dict[str, float]
    counts: Dict[str, float] = field(default_factory=dict)
    breakdown: Dict[str, list] = field(default_factory=dict)

    def kernel_seconds(self, substring: str) -> float:
        return sum(s for name, s in self.kernel_s.items() if substring in name)


def union_length(intervals: List[Tuple[float, float]], lo: float,
                 hi: float) -> Tuple[float, List[Tuple[float, float]]]:
    """Length of the union of ``intervals`` clipped to [lo, hi], and the
    idle gaps between them inside [lo, hi]."""
    busy, gaps, cur_end = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur_end:
            gaps.append((cur_end, s))
            busy += e - s
            cur_end = e
        elif e > cur_end:
            busy += e - cur_end
            cur_end = e
    if hi > cur_end:
        gaps.append((cur_end, hi))
    return busy, gaps


def _host_labels(cpu: List[Tuple[int, int, str]], gaps, limit: int = 4000
                 ) -> Dict[str, float]:
    """Idle seconds by what the host was doing at each gap's midpoint: the
    most recently started host event (an operator, a runtime call or a
    span) that still covers it."""
    cpu.sort()
    starts = [c[0] for c in cpu]
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "host outside any traced op"
        for j in range(i, max(-1, i - limit), -1):
            s, e, name = cpu[j]
            if e >= mid:
                label = (f"python inside {name}"
                         if name.startswith("slambench") else name)
                break
        out[label] += (g1 - g0) * 1e-9
    return out


def _top(d: Dict[str, float], n: int = 10) -> list:
    return [[k[:160], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class Stretch:
    """``start()`` before the stretch's first step, ``stop()`` after its
    last; ``read()`` once the measured window has closed (parsing the trace
    takes seconds, so it stays outside the window)."""

    def __init__(self, probe: Optional[Callable[[], dict]] = None,
                 device: torch.device = torch.device("cuda")):
        self.probe = probe or dict
        self.device = torch.device(device)
        self.prof = None
        self.span = None
        self.before: dict = {}
        self.after: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.before = self.probe()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(SPAN)
        self.span.__enter__()

    def stop(self) -> None:
        self._sync()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.after = self.probe()

    def read(self) -> TraceData:
        events = self.prof.profiler.kineto_results.events()
        lo = hi = None
        dev, kernels, cpu = [], defaultdict(float), []
        n_kernels = 0
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            name = e.name()
            if e.is_user_annotation():
                # a span; on the device it mirrors the host's, and is no work
                if name == SPAN and e.device_type() != \
                        torch.autograd.DeviceType.CUDA:
                    lo, hi = s, s + d
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    cpu.append((s, s + d, name))
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((s, s + d))
                if not name.startswith(_COPY_PREFIXES):
                    n_kernels += 1
                kernels[name] += d * 1e-9
            else:
                cpu.append((s, s + d, name))
        if lo is None:
            raise RuntimeError("the profiler trace lacks the stretch's span")
        busy_ns, gaps = union_length(dev, lo, hi)
        counts = {k: self.after[k] - self.before.get(k, 0.0)
                  for k in self.after}
        self.prof = None
        return TraceData(
            window_s=(hi - lo) * 1e-9, busy_s=busy_ns * 1e-9,
            n_kernels=n_kernels, kernel_s=dict(kernels), counts=counts,
            breakdown={"device_ops": _top(kernels),
                       "idle_gaps": _top(_host_labels(cpu, gaps))})


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return res.stdout.strip() or res.stderr.strip()
