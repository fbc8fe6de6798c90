"""A golden circuit's first frames through the JAX package's and the
port's ``SlamSystem`` on the CPU, at a small size.

Renders the first ``--frames`` frames of ``golden_torch.py``'s circuit
(the JAX package's world, read from ``golden_worlds/``) with the port's
renderer at ``--height`` x ``--width`` (the camera scaled to the width),
feeds the same float32 frames to both systems (no vocabulary, no map, the
renderer's labels), and prints each one's ATE RMSE and the largest
difference between their poses, frame by frame. The JAX system runs
its CPU path (the blocked SGM scan of ``scan_block``, which the port does
not implement), so stereo runs part after a few frames; RGB-D runs have no
SGM. Both trajectories are ``finish()``'s export.

    python tools/torch_golden_prefix.py --rgbd --radius 10 --frames 12 \\
        --height 188 --width 624
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import golden_torch  # noqa: E402
from semantic_slam_mapping_tpu import config as jcfg  # noqa: E402
from semantic_slam_mapping_tpu.pipeline import SlamSystem as JaxSlam  # noqa: E402,E501
from semantic_slam_mapping_torch.pipeline import SlamSystem  # noqa: E402
from semantic_slam_mapping_torch.utils.metrics import ate_rmse  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12,
                    help="how many of the circuit's frames to run")
    ap.add_argument("--height", type=int, default=188)
    ap.add_argument("--width", type=int, default=624)
    ap.add_argument("--rgbd", action="store_true")
    ap.add_argument("--radius", type=float, default=golden_torch.RADIUS)
    ap.add_argument("--circuit", type=int, default=None,
                    help="frames of the whole circuit (default: 300 with "
                         "--rgbd, else 500)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    n = args.frames
    circuit = args.circuit or (300 if args.rgbd else 500)
    gargs = golden_torch.parse_args(
        ["--gt-semantics", "--no-mapping", "--device", "cpu", "--seed",
         str(args.seed), "--radius", str(args.radius), "--frames",
         str(circuit)] + (["--rgbd"] if args.rgbd else []))
    cfg = golden_torch.golden_config(gargs, width=args.width)
    world = golden_torch.load_world(gargs, "cpu")
    poses = golden_torch.circuit_poses(gargs, "cpu")
    frames = golden_torch.render_circuit(cfg, world, poses, args.height,
                                         args.width, args.rgbd, stop=n)
    gt = poses[:n].numpy().astype(np.float64)

    jc = jcfg.SlamConfig()
    jc = jcfg.SlamConfig(**{
        k: type(getattr(jc, k))(**v)
        for k, v in dataclasses.asdict(cfg).items() if hasattr(jc, k)})
    left = frames["left"].float().numpy()
    second = frames["second"].float().numpy()
    jsys = JaxSlam(jc, enable_mapping=False, rgbd=args.rgbd)
    tsys = SlamSystem(cfg, enable_mapping=False, rgbd=args.rgbd,
                      device="cpu")
    for system, conv in ((jsys, jnp.asarray), (tsys, torch.from_numpy)):
        stream = ((conv(left[i]), conv(second[i])) for i in range(n))
        if args.rgbd:
            system.process_stream_rgbd(stream)
        else:
            system.process_stream(stream)
    jt, tt = jsys.finish(), tsys.finish()
    print(json.dumps({
        "frames": n, "shape": [args.height, args.width],
        "mode": "rgbd" if args.rgbd else "stereo",
        "ate_rmse_m": {"jax": ate_rmse(jt, gt), "port": ate_rmse(tt, gt)},
        "max_pose_diff_m": [float(np.abs(a[:3, 3] - b[:3, 3]).max())
                            for a, b in zip(jt, tt)],
        "keyframes": {"jax": [k.frame_index for k in jsys.keyframes],
                      "port": [k.frame_index for k in tsys.keyframes]}}))


if __name__ == "__main__":
    main()
