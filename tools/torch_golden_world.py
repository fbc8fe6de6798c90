"""Export the JAX package's golden loop worlds as JSON for the port.

``golden.py`` draws its world with ``synthetic.make_loop_world(
jax.random.PRNGKey(seed), n_boxes, radius, n_moving=6)``; the port cannot
replay ``jax.random``, so ``golden_torch.py`` loads the same world from
``golden_worlds/loop_s{seed}_r{radius:g}_b{boxes}_m6.json``. Each float32
value is written as the shortest decimal of its float64 widening, so it
reads back bit for bit. With no arguments the tool writes the stereo
golden world (seed 7, radius 30 m), the RGB-D one (seed 7, radius 10 m)
and the multi-seed ones (seeds 8 and 9, radius 30 m); with ``--seed
--radius --boxes`` it writes that one. Runs on the CPU (needs JAX):

    python tools/torch_golden_world.py
    python tools/torch_golden_world.py --seed 8 --radius 30 --boxes 48
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from golden_torch import N_BOXES, N_MOVING, world_path  # noqa: E402
from semantic_slam_mapping_tpu.io import synthetic  # noqa: E402

# (seed, radius): the stereo golden, the RGB-D golden, the multi-seed runs
GOLDEN_WORLDS = ((7, 30.0), (7, 10.0), (8, 30.0), (9, 30.0))


def _floats(a) -> list:
    """float32 array -> nested lists of Python floats equal to its values."""
    return np.asarray(a, np.float32).astype(np.float64).tolist()


def world_record(seed: int, radius: float, boxes: int) -> dict:
    """The world ``golden.py`` draws for these arguments, as a JSON-ready
    dict with the call's arguments and the JAX version."""
    args = dict(seed=seed, n_boxes=boxes, radius=float(radius),
                n_moving=N_MOVING)
    w = synthetic.make_loop_world(jax.random.PRNGKey(seed), n_boxes=boxes,
                                  radius=radius, n_moving=N_MOVING)
    return {
        "call": "semantic_slam_mapping_tpu.io.synthetic.make_loop_world("
                "jax.random.PRNGKey(seed), n_boxes, radius, n_moving)",
        "args": args,
        "jax_version": jax.__version__,
        "jax_platform": jax.devices()[0].platform,
        "boxes": _floats(w.boxes),
        "box_class": np.asarray(w.box_class).astype(int).tolist(),
        "ground_y": _floats(w.ground_y),
        "backdrop_z": _floats(w.backdrop_z),
        "box_velocity": (None if w.box_velocity is None
                         else _floats(w.box_velocity)),
    }


def write_world(seed: int, radius: float, boxes: int) -> Path:
    path = world_path(seed, radius, boxes)
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(world_record(seed, radius, boxes)) + "\n")
    return path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--radius", type=float, default=30.0)
    ap.add_argument("--boxes", type=int, default=N_BOXES)
    args = ap.parse_args()
    todo = (GOLDEN_WORLDS if args.seed is None
            else ((args.seed, args.radius),))
    for seed, radius in todo:
        print(write_world(seed, radius, args.boxes).relative_to(REPO))


if __name__ == "__main__":
    main()
