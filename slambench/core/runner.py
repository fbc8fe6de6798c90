"""One run of one cell: ``python slambench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from slambench.core import guard, registry
from slambench.core.result import Context, emit
from slambench.core.trace import power_limit


def process_start() -> float:
    """``time.perf_counter()`` at this process's start, read from the
    kernel's record of it (10 ms ticks)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = process_start() if t_start is None else t_start
    args = parse_args(argv)
    bench = registry.load_benchmark()
    cell = registry.resolve(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"slambench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    readers = registry.load_metric_readers() if args.trace else {}
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    driver = registry.load_driver(cell)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=torch.device("cuda", 0),
                  t_start=t_start)
    out = driver.run(ctx)

    bad = guard.forbidden_loaded()
    if bad:
        print(f"slambench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    if args.trace:
        values = {}
        for m in cell.per_layer:
            v = readers[m["name"]](out.trace, cell)
            if v is not None:
                values[m["name"]] = v
    else:
        values = dict(out.rates, setup_s=out.setup_s)
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in values]
        if missing:
            print(f"slambench: {cell.name} gave no {missing}", file=sys.stderr)
            return 5
        values = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if args.trace:
        device.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
    print("notes: " + json.dumps(out.notes, default=str), file=sys.stderr)
    emit(out, {k: {"value": v, "unit": units[k]} for k, v in values.items()},
         device)
    return 0
