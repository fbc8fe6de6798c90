"""The port's ``rgbd``, ``pnp`` and ``segnet`` commands (``--device cpu``)
on the directories of test_cli.py.

Test 1: ``rgbd --gt --plot`` on the TUM-layout directory (16-bit depth,
depth scale 1000) against the JAX package's ``cli rgbd`` with the same
arguments: trajectories within 1e-4, the accuracy JSON with the same keys
and frame count and its ATE within 1e-3 m of JAX's (it is rounded to
0.1 mm), both plots written, the port's with its caption chunk.

Test 2: ``pnp --gt --parameters --verbose`` on the KITTI-layout
directory against the JAX package's ``cmd_pnp`` step on its TPU path,
composed by hand on the same frames (the cost volume op by op, the Pallas
SGM kernel in interpret mode, the jitted selection, then the depth and
``track_frame_rgbd`` under ``jit`` as ``cmd_pnp`` writes them; on the CPU
the JAX package's ``sgbm.compute`` takes a blocked scan that the port does
not implement). Each frame's ``stereo_depth`` equals JAX's depth exactly;
the printed matches and inliers equal JAX's; the trajectory is within
1e-4 of JAX's on the frames where JAX's PnP succeeds (at least four of
the six); the accuracy line has the keys of JAX's ``_report_accuracy`` of
the written trajectory, six frames, and each value within one unit of its
last printed digit (the CLI reports its float32 poses, the file holds ten
digits of them), and the ATE under 1 m (the bound of the JAX package's
own ``pnp`` test). Then ``segnet`` with the shipped SegNet
checkpoint (``--checkpoint`` only when the pickle is there) on the first
two frames: label and overlay PNGs for each; the labels equal, exactly,
the port's network's labels at its 384x480 input resized as floats and
truncated, and those network labels equal the JAX package's network run
op by op on the same input on at least 99% of the pixels (the checkpoint
computes in bfloat16, whose rounding the two packages order differently;
a truncated bilinear resize of class ids spreads each differing label
over its footprint, so the comparison is made before it).
"""

import json
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from semantic_slam_mapping_tpu import cli as jcli
from semantic_slam_mapping_tpu.config import load_parameters_file as jload
from semantic_slam_mapping_tpu.frontend import rgbd_tracker as jrt
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics as JK
from semantic_slam_mapping_tpu.io.kitti import KittiReader as JKitti
from semantic_slam_mapping_tpu.models import segnet as jseg
from semantic_slam_mapping_tpu.ops import sgbm as jsgbm
from semantic_slam_mapping_tpu.ops.pallas import sgm_pallas
from semantic_slam_mapping_torch import cli
from semantic_slam_mapping_torch.config import (SegNetConfig,
                                                load_parameters_file)
from semantic_slam_mapping_torch.io.gt_pose import read_kitti_poses
from semantic_slam_mapping_torch.io.png import read_png
from semantic_slam_mapping_torch.models import segnet as tseg
from semantic_slam_mapping_torch.ops import image as tim

from tests.test_cli import CAM, kitti_dataset, tum_dataset  # noqa: F401
from tests.test_segnet import SHIPPED

torch.set_num_threads(4)


POSE_TOL = 1e-4


def _json_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _jax_pnp(root, params):
    """JAX ``cmd_pnp``'s frames on the TPU path: per frame the depth map
    and the tracker's (pose, status, matches, inliers, success)."""
    cfg = jload(str(params))
    K, c = JK.from_config(cfg.camera), cfg.sgbm
    p1, p2 = float(c.p1) / 16.0, float(c.p2) / 16.0

    def bidir(v):
        return sgm_pallas.sgm_bidir_pallas(v, p1, p2, interpret=True)

    @jax.jit
    def depth_of(agg):
        # ops/sgbm.py's selection, then cli.py cmd_pnp's depth
        disp, unique_ok = jsgbm._wta_subpixel(agg, c)
        valid = unique_ok & jsgbm._lr_check(agg, disp, c) \
            & (disp > c.min_disparity)
        valid = jsgbm._speckle_filter(disp, valid, c)
        disp = jnp.where(valid, disp, jsgbm.INVALID)
        return jnp.where(valid, cfg.camera.fx * cfg.camera.baseline
                         / jnp.maximum(disp, 1e-3), 0.0)

    track = jax.jit(lambda s, g, d: jrt.track_frame_rgbd(s, g, d, K, cfg))
    state = jrt.RgbdTrackerState.initial(cfg.orb.n_features,
                                         cfg.tracker.ref_frames)
    out = []
    for frame in JKitti(str(root)):
        left = jnp.asarray(frame.left)
        vol = jsgbm._cost_volume(left, jnp.asarray(frame.right), c)
        depth = depth_of(bidir(vol) + jnp.swapaxes(
            bidir(jnp.swapaxes(vol, 0, 1)), 0, 1))
        state, res = track(state, left, depth)
        out.append((np.asarray(depth), np.asarray(res.pose),
                    int(res.status), int(res.n_matches),
                    int(res.n_inliers), bool(res.success)))
    return out


def test_cli_rgbd_matches_jax(tum_dataset, tmp_path, capsys):  # noqa: F811
    args = ["rgbd", "--data", str(tum_dataset),
            "--gt", str(tum_dataset / "groundtruth.txt"), "--plot",
            "--fx", str(CAM.fx), "--fy", str(CAM.fy), "--cx", str(CAM.cx),
            "--cy", str(CAM.cy), "--depth-scale", "1000"]
    capsys.readouterr()
    jcli.main(args + ["--out", str(tmp_path / "jax")])
    jrep = _json_line(capsys.readouterr().out)
    cli.main(args + ["--out", str(tmp_path / "torch"), "--device", "cpu"])
    trep = _json_line(capsys.readouterr().out)
    jt = read_kitti_poses(tmp_path / "jax" / "trajectory.txt")
    tt = read_kitti_poses(tmp_path / "torch" / "trajectory.txt")
    assert tt.shape == jt.shape == (5, 4, 4)
    np.testing.assert_allclose(tt, jt, atol=1e-4)
    assert trep.keys() == jrep.keys() and trep["frames"] == 5
    assert abs(trep["ate_rmse_m"] - jrep["ate_rmse_m"]) <= 1e-3
    assert trep["ate_rmse_m"] < 0.5
    assert (tmp_path / "jax" / "trajectory.png").exists()
    with Image.open(tmp_path / "torch" / "trajectory.png") as im:
        assert im.text["Comment"].startswith("green: estimated")


def test_cli_pnp_and_segnet(kitti_dataset, tmp_path, capsys):  # noqa: F811
    root, gt_file, params = kitti_dataset
    capsys.readouterr()
    cli.main(["pnp", "--data", str(root), "--gt", str(gt_file),
              "--parameters", str(params), "--out", str(tmp_path / "pnp"),
              "--verbose", "--device", "cpu"])
    captured = capsys.readouterr()
    report = _json_line(captured.out)
    counts = [tuple(map(int, m)) for m in re.findall(
        r"^frame \d+: matches=(\d+) inliers=(\d+)$", captured.err, re.M)]
    traj = read_kitti_poses(tmp_path / "pnp" / "trajectory.txt")
    ref = _jax_pnp(root, params)
    assert traj.shape == (6, 4, 4) and len(ref) == 6
    assert counts == [(m, n) for _, _, _, m, n, _ in ref]
    assert sum(ok for *_, ok in ref) >= 4
    cfg = load_parameters_file(params)
    for i, (frame, (depth, pose, *_, ok)) in enumerate(zip(
            JKitti(str(root)), ref)):
        np.testing.assert_array_equal(cli.stereo_depth(
            torch.from_numpy(frame.left), torch.from_numpy(frame.right),
            cfg).numpy(), depth, err_msg=f"frame {i}")
        if ok:
            np.testing.assert_allclose(traj[i], pose, atol=POSE_TOL,
                                       err_msg=f"frame {i}")
    # the CLI reports its float32 poses, the file holds 10 digits of them:
    # each value within one unit of its last printed digit
    jcli._report_accuracy(traj, str(gt_file))
    jrep = _json_line(capsys.readouterr().out)
    assert report.keys() == jrep.keys() and report["frames"] == 6
    assert report["ate_rmse_m"] < 1.0
    for key, unit in (("ate_rmse_m", 1e-4), ("ate_median_m", 1e-4),
                      ("rpe_t_rmse_m", 1e-4), ("rpe_r_rmse_rad", 1e-6)):
        assert abs(report[key] - jrep[key]) <= unit * 1.001, key

    # the first two frames, as their own sequence
    two = tmp_path / "two"
    for sub in ("image_0", "image_1", "image_2"):
        (two / sub).mkdir(parents=True)
        for i in range(2):
            shutil.copy(root / sub / f"{i:06d}.png", two / sub)
    extra = ["--checkpoint", str(SHIPPED)] if SHIPPED.exists() else []
    cli.main(["segnet", "--data", str(two), "--out", str(tmp_path / "seg"),
              "--device", "cpu", *extra])
    if SHIPPED.exists():
        model, variables, _ = jseg.load_checkpoint(SHIPPED)
        tmodel, _ = tseg.load_checkpoint(SHIPPED)
    else:
        model, variables = jseg.create(jseg.SegNetConfig())
        tmodel = tseg.create(SegNetConfig(), torch.Generator().manual_seed(0))
    for frame in JKitti(str(two)):
        labels = read_png(tmp_path / "seg" / "segnet_0"
                          / f"{frame.index:06d}.png")
        overlay = read_png(tmp_path / "seg" / "result_0"
                           / f"{frame.index:06d}.png")
        assert labels.shape == frame.left.shape
        assert overlay.shape == frame.color.shape
        xt = tim.resize_bilinear(torch.from_numpy(frame.color).permute(
            2, 0, 1), (384, 480)).permute(1, 2, 0)[None]
        tl = tseg.infer(tmodel, xt)[0]
        np.testing.assert_array_equal(labels, tim.resize_bilinear(
            tl.float()[None], frame.left.shape)[0].numpy().astype(np.uint8))
        # op by op: under jit XLA keeps some bf16 intermediates in float32
        jl = np.asarray(jnp.argmax(model.apply(
            variables, jnp.asarray(xt.numpy()), train=False), -1))[0]
        assert (tl.numpy() == jl).mean() >= 0.99, (tl.numpy() == jl).mean()
