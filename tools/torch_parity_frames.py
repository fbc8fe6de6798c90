"""Frame-by-frame comparison of the JAX frontend and its PyTorch port on the
CPU, at a size chosen on the command line.

Renders a JAX synthetic street with a moving car, scales the default
(KITTI) camera to the frame size, and feeds the same frames to JAX
``track_frame`` and to the port's ``SlamSystem.process_frame`` (both exact:
float32 cost volume, unblocked SGM scan). Prints one JSON line per tracked
frame: moving pixels (JAX, port, ground truth), matches, inliers and the
largest pose difference.

    python tools/torch_parity_frames.py --height 188 --width 624 --frames 6
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.frontend import tracker as jtracker
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils import convert


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=188)
    ap.add_argument("--width", type=int, default=624)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--disparities", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    H, W = args.height, args.width

    base = jcfg.SlamConfig()
    s = W / 1248.0
    cam = dataclasses.replace(base.camera, fx=base.camera.fx * s,
                              fy=base.camera.fy * s, cx=base.camera.cx * s,
                              cy=base.camera.cy * s)
    cfg = base.replace(camera=cam, sgbm=dataclasses.replace(
        base.sgbm, num_disparities=args.disparities, cost_dtype="float32",
        scan_block=0))
    K = Intrinsics.from_config(cfg.camera)
    world = jsyn.make_world(jax.random.PRNGKey(args.seed), n_boxes=14,
                            with_moving_box=True)
    poses = jsyn.straight_trajectory(args.frames, speed=0.8)
    seq = jax.tree.map(np.asarray,
                       jsyn.render_sequence(K, world, poses, H, W))
    # the port uploads float frames as uint8; give JAX the same values
    q = {k: (np.clip(seq[k], 0, 1) * 255 + 0.5).astype(np.uint8) / 255.0
         for k in ("left", "right")}

    system = SlamSystem(convert.config_from_dict(dataclasses.asdict(cfg)),
                        device="cpu")
    system.process_frame(seq["left"][0], seq["right"][0])
    state = jtracker.TrackerState.initial(cfg)
    key = jax.random.PRNGKey(args.seed)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    for i in range(1, args.frames):
        key, k = jax.random.split(key)
        state, out = jtracker.track_frame(
            state, f32(q["left"][i]), f32(q["right"][i]),
            f32(q["left"][i - 1]), f32(q["right"][i - 1]), K, k, cfg)
        o = system.process_frame(seq["left"][i], seq["right"][i])
        print(json.dumps({
            "frame": i,
            "moving_px": [int(out.moving_mask.sum()),
                          int(o.moving_mask.sum()),
                          int(seq["moving"][i].sum())],
            "moving_px_differ": int((np.asarray(out.moving_mask)
                                     != o.moving_mask.numpy()).sum()),
            "matches": [int(out.n_matches), int(o.n_matches)],
            "inliers": [int(out.n_inliers), int(o.n_inliers)],
            "pose_max_abs_diff": float(np.abs(np.asarray(out.pose)
                                              - o.pose.numpy()).max()),
        }), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
