"""Arithmetic that several per-layer readers share."""

from __future__ import annotations

from typing import Callable, Optional

from slambench.core.trace import TraceData

STAGE = "stage:"


def idle_share(trace: TraceData) -> Optional[float]:
    """100 x (1 - busy / window): busy is the union of the device's kernel,
    copy and memset intervals over the stretch."""
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def stage_ms_per_frame(trace: TraceData,
                       pick: Callable[[str], bool]) -> Optional[float]:
    """Host milliseconds a frame of the picked stage-timer stages over the
    stretch (each stage's total is counted as ``stage:<name>``)."""
    frames = trace.counts.get("frames", 0)
    if not frames:
        return None
    total = sum(v for k, v in trace.counts.items()
                if k.startswith(STAGE) and pick(k[len(STAGE):]))
    return 1e3 * total / frames
