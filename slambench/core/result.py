"""What a driver hands back, and the run's last lines.

A run is correct when every number compared lies within its limit (a
number that is not finite is not). The numbers go to standard error as the
run's last lines, and into the result line under ``checks``, its last key.
"""

from __future__ import annotations

import hashlib
import json
import math
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from slambench.core.trace import TraceData


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Context:
    """One run of one cell. ``overrides`` (keys of the configuration or the
    traffic file, with their values) exist for rehearsals at a small size on
    the CPU; ``run.py`` never sets them."""

    cell: "object"
    seed: int
    seconds: float
    trace: bool
    device: "object"
    t_start: float
    overrides: Dict[str, object] = field(default_factory=dict)

    def param(self, source: dict, key: str):
        return self.overrides.get(key, source[key])

    def config(self, key: str):
        return self.param(self.cell.config, key)

    def traffic(self, key: str):
        return self.param(self.cell.traffic, key)

    def sub_seed(self, tag: str) -> int:
        """A seed of its own for each use of the run's seed (the world, the
        weights, the samples compared), so that they are drawn apart."""
        digest = hashlib.sha256(f"{self.seed}/{tag}".encode()).digest()
        return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


@dataclass
class Outcome:
    rates: Dict[str, float]        # end-to-end metrics but setup_s
    setup_s: float
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Check]
    trace: Optional[TraceData] = None
    notes: Dict[str, object] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def emit(outcome: Outcome, metrics: Dict[str, dict], device: dict) -> dict:
    """Print the checks on standard error, then the result line as the last
    line of standard output; return the line's object."""
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if outcome.trace is not None:
        line["breakdown"] = outcome.trace.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line
