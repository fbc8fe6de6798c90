"""The controls' readings at the cells' own sizes, on the card:

    python3 slambench/tests/controls.py <cell> <seed> [<seed> ...]

prints one JSON line a seed with the control's reading of each number it
is compared by (the reference in a lower precision put in the program's
place). The limits in ``traffic/*.json`` lie below these readings;
``test_slambench_control.py`` holds them there."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench.core import registry  # noqa: E402
from slambench.core.result import Context  # noqa: E402


def readings(cell_name: str, seed: int, device="cuda",
             overrides=None) -> dict:
    cell = registry.resolve(cell_name, registry.load_benchmark())
    ctx = Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                  device=torch.device(device), t_start=time.perf_counter(),
                  overrides=overrides or {})
    return registry.load_driver(cell).control(ctx)


if __name__ == "__main__":
    for s in sys.argv[2:]:
        t = time.perf_counter()
        print(json.dumps({"cell": sys.argv[1], "seed": int(s),
                          "control": readings(sys.argv[1], int(s)),
                          "seconds": time.perf_counter() - t}), flush=True)
