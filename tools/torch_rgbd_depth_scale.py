"""The JAX package's ``cli rgbd`` and the port's on one TUM-layout directory
at several depth scales, on the CPU.

Renders the first frames of chip_smoke.py's RGB-D loop course (radius-10
loop world, TUM fr1 intrinsics scaled to the frame size), optionally
scaled by ``--room-scale`` (the same images, every depth and translation
that many times as large), writes one TUM-layout directory per depth scale
with chip_smoke's writer (16-bit depth times the scale, 0 past
``--max-range`` metres or outside 16 bits), and runs both packages'
``rgbd --gt`` on it. Prints one JSON line per scale: both accuracy
reports, the largest pose difference between the two trajectories, and
the share of depth pixels left without a reading.

    python tools/torch_rgbd_depth_scale.py --height 240 --width 320 \\
        --frames 30 --scales 1000 5000
    python tools/torch_rgbd_depth_scale.py --scales 5000 \\
        --room-scale 0.2 --max-range 10
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from semantic_slam_mapping_tpu import cli as jcli  # noqa: E402
from semantic_slam_mapping_torch import cli as tcli  # noqa: E402
from semantic_slam_mapping_torch.io.gt_pose import read_kitti_poses  # noqa


def _run(main, args) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(args)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--scales", type=float, nargs="+",
                    default=[1000.0, 5000.0])
    ap.add_argument("--max-range", type=float, default=None)
    ap.add_argument("--room-scale", type=float, default=1.0)
    args = ap.parse_args()

    cfg = chip_smoke.tum_config(args.height, args.width)
    frames, gt = chip_smoke.render_rgbd_loop(cfg, args.frames, args.height,
                                             args.width, "cpu")
    frames, gt = chip_smoke.room_course(frames, gt, args.room_scale)
    cam = cfg.camera
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for scale in args.scales:
            tum = tmp / f"tum{scale:g}"
            chip_smoke.write_tum_dir(tum, frames, gt, scale, args.max_range)
            common = ["rgbd", "--data", str(tum), "--gt",
                      str(tum / "groundtruth.txt"), "--fx", str(cam.fx),
                      "--fy", str(cam.fy), "--cx", str(cam.cx), "--cy",
                      str(cam.cy), "--depth-scale", str(scale)]
            jrep = _run(jcli.main, common + ["--out", str(tmp / "jax")])
            trep = _run(tcli.main, common + ["--out", str(tmp / "torch"),
                                             "--device", "cpu"])
            jt = read_kitti_poses(tmp / "jax" / "trajectory.txt")
            tt = read_kitti_poses(tmp / "torch" / "trajectory.txt")
            depth = np.stack([d for _, d, _ in frames])
            held = chip_smoke.depth_reading(depth, scale, args.max_range)
            print(json.dumps(dict(
                depth_scale=scale, max_range_m=args.max_range,
                room_scale=args.room_scale,
                frames=args.frames, shape=[args.height, args.width],
                jax=jrep, torch=trep,
                max_pose_diff=float(np.abs(jt - tt).max()),
                no_reading_share=float((held == 0).mean()),
                rendered_depth_max_m=float(depth.max()))), flush=True)


if __name__ == "__main__":
    main()
