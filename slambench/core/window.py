"""The measured window, the same for every cell.

``run_window`` hands the program one step after another, back to back,
until ``seconds`` of host time have passed since the first; then it calls
``finish`` (the work that closes the last step, e.g. ``SlamSystem.finish``)
and synchronises the card. The rate is all the work handed in over all that
time. Nothing is read back inside the window unless the step itself does
so, as a cell's traffic asks.

With ``trace`` a stretch of ``stretch_steps`` steps, starting with the first
step after four tenths of the window, runs under the profiler; the window
goes on until the stretch is complete, however short ``seconds`` is.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from slambench.core.trace import Stretch, TraceData

STRETCH_START = 0.4


@dataclass
class WindowResult:
    work: float          # frames or images handed in
    seconds: float       # first step to the synchronise after finish
    steps: int
    started: float       # perf_counter at the first step
    stretch: Optional[Stretch] = None

    @property
    def rate(self) -> float:
        return self.work / self.seconds

    def trace(self) -> Optional[TraceData]:
        return self.stretch.read() if self.stretch is not None else None


def run_window(step: Callable[[int], float], seconds: float, *,
               finish: Optional[Callable[[], None]] = None,
               trace: bool = False, stretch_steps: int = 2,
               probe: Optional[Callable[[], dict]] = None,
               device: torch.device = torch.device("cuda")) -> WindowResult:
    """``step(i)`` hands in step i and returns its work (frames, images)."""
    stretch, begun, done = None, None, False
    work, i = 0.0, 0
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if begun is not None and not done and i - begun == stretch_steps:
            stretch.stop()
            done = True
        if elapsed >= seconds and (not trace or done):
            break
        if trace and begun is None and elapsed >= STRETCH_START * seconds:
            stretch = Stretch(probe, device)
            stretch.start()
            begun = i
        work += step(i)
        i += 1
    if finish is not None:
        finish()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return WindowResult(work=work, seconds=time.perf_counter() - t0,
                        steps=i, started=t0, stretch=stretch)
