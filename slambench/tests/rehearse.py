"""Rehearsals of the drivers on the CPU at a small size: the same code as a
run on the card, with sizes overridden. ``run.py`` offers none of this."""

from __future__ import annotations

import time

import torch

from slambench.core import registry
from slambench.core.result import Context

HALF_CAMERA = {"fx": 359.428, "fy": 359.428, "cx": 303.5964, "cy": 92.60785,
               "baseline": 0.532331858}

SMALL = {
    "kitti_stereo.street_w32": {
        "height": 188, "width": 624, "camera": HALF_CAMERA,
        "overrides": {"segnet.online": True, "segnet.input_height": 64,
                      "segnet.input_width": 64,
                      **{f"camera.{k}": v for k, v in HALF_CAMERA.items()}},
        "segnet_height": 64, "segnet_width": 64,
        "frames": 17, "window_pairs": 2, "render_chunk": 4,
        "check_frames": 2, "check_keyframes": 2, "check_voxels": 2000,
        "rpe_frames": 4},
    "segnet_camvid.train_b12": {
        "batch": 2, "height": 32, "width": 32, "distinct_batches": 4,
        "warmup_steps": 1, "stretch_steps": 2},
    "segnet_camvid.label_b8": {
        "batch": 2, "height": 32, "width": 32, "distinct_batches": 4,
        "warmup_batches": 1, "stretch_steps": 2, "check_batches": 2},
}


def context(cell_name: str, seed: int = 1, seconds: float = 1.0,
            trace: bool = False, overrides: dict | None = None,
            bench: dict | None = None) -> Context:
    bench = bench or registry.load_benchmark()
    cell = registry.resolve(cell_name, bench)
    return Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                   device=torch.device("cpu"), t_start=time.perf_counter(),
                   overrides={**SMALL[cell_name], **(overrides or {})})


def rehearse(cell_name: str, **kw):
    """Run the cell's driver on the CPU at the small size: its Outcome."""
    ctx = context(cell_name, **kw)
    return registry.load_driver(ctx.cell).run(ctx)
