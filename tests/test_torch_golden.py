"""The golden run of the port (``golden_torch.py``) against the JAX
package's ``golden.py``: its worlds are JAX's own draws, bit for bit, and
render as JAX renders them (semantics and the moving mask exact, depth
within rtol 1e-5, intensities within 1e-2 on 99% of pixels: the texture
hashes sin() of large arguments, which the two libraries round apart, as
in ``test_torch_synthetic.py``); its circuit is JAX's within 1e-5; and
its functions run the first frames of the stereo and the RGB-D circuit
on the CPU, writing golden.py's record, the PCD and the PNG."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_torch
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_torch.io import png
from semantic_slam_mapping_torch.io import synthetic as tsyn
from torch_parity_scene import JK_, TK, H, W, to_np

torch.set_num_threads(2)

# a 12-frame prefix of each circuit, the ATE of its first 11 frames bound
# by 2% of the path driven (11 steps of 0.471 m stereo, 0.263 m RGB-D)
# plus 5 cm; finish() puts the newest frame at the last keyframe's pose,
# as the JAX package's does (golden_torch.tracked_ate). RGB-D runs at
# 188x624: at 128x416 the reference's own RGB-D tracker drifts on this
# prefix (tools/torch_golden_prefix.py: JAX and the port alike)
PREFIX = 12
PREFIX_HW = {"stereo": (128, 416), "rgbd": (188, 624)}
PREFIX_ATE_BOUND_M = {"stereo": 0.02 * 11 * 0.471 + 0.05,
                      "rgbd": 0.02 * 11 * 0.263 + 0.05}


def test_golden_worlds_are_jax_worlds():
    paths = sorted(golden_torch.WORLD_DIR.glob("loop_*.json"))
    assert len(paths) == 4
    for path in paths:
        d = json.loads(path.read_text())
        a = d["args"]
        assert path == golden_torch.world_path(a["seed"], a["radius"],
                                               a["n_boxes"])
        jw = jsyn.make_loop_world(jax.random.PRNGKey(a["seed"]),
                                  n_boxes=a["n_boxes"], radius=a["radius"],
                                  n_moving=a["n_moving"])
        tw = tsyn.load_world_json(path, device="cpu")
        for name in ("boxes", "box_class", "ground_y", "backdrop_z",
                     "box_velocity"):
            want = np.asarray(getattr(jw, name))
            got = getattr(tw, name).numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)
            if want.dtype == np.float32:
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))

    traj_j = np.asarray(jsyn.loop_trajectory(500, 30.0, 1.25, 0.006,
                                             revisit_offset=1.5))
    traj = tsyn.loop_trajectory(500, 30.0, 1.25, 0.006, revisit_offset=1.5,
                                device="cpu")
    np.testing.assert_allclose(to_np(traj), traj_j, atol=1e-5)

    path = golden_torch.world_path(7, 30.0, 48)
    jw = jsyn.make_loop_world(jax.random.PRNGKey(7), n_boxes=48,
                              radius=30.0, n_moving=6)
    tw = tsyn.load_world_json(path, device="cpu")
    poses = np.asarray(jsyn.loop_trajectory(500, 30.0, 1.25, 0.006))
    for i in (0, 420):
        seq_j = jsyn.render_sequence(JK_, jw, jnp.asarray(poses[i:i + 1]),
                                     H, W, start_index=i)
        seq = tsyn.render_sequence(TK, tw, torch.tensor(poses[i:i + 1]),
                                   H, W, start_index=i)
        np.testing.assert_array_equal(to_np(seq["semantic"]),
                                      np.asarray(seq_j["semantic"]))
        np.testing.assert_array_equal(to_np(seq["moving"]),
                                      np.asarray(seq_j["moving"]))
        np.testing.assert_allclose(to_np(seq["depth"]),
                                   np.asarray(seq_j["depth"]), rtol=1e-5,
                                   atol=1e-4)
        for side in ("left", "right"):
            diff = np.abs(to_np(seq[side]) - np.asarray(seq_j[side]))
            assert np.mean(diff < 1e-2) > 0.99, (i, side)
        if i == 0:
            # the movers are in view at the start
            assert to_np(seq["moving"]).sum() > 0


def test_golden_torch_runs_on_cpu(tmp_path):
    keys = set(json.loads((golden_torch.REPO / "GOLDEN_r05.json")
                          .read_text()))
    for mode, extra in (("stereo", []),
                        ("rgbd", ["--rgbd", "--radius", "10", "--frames",
                                  "300"])):
        args = golden_torch.parse_args(["--gt-semantics", "--device", "cpu",
                                        "--round", "1", *extra])
        height, width = PREFIX_HW[mode]
        cfg = golden_torch.golden_config(args, width=width)
        assert not cfg.segnet.online
        world = golden_torch.load_world(args, "cpu")
        poses = golden_torch.circuit_poses(args, "cpu")
        assert poses.shape == (args.frames, 4, 4)
        frames = golden_torch.render_circuit(cfg, world, poses, height,
                                             width, args.rgbd, stop=PREFIX)
        assert frames["left"].shape == (PREFIX, height, width)
        assert frames["left"].dtype == frames["second"].dtype \
            == torch.float16
        assert frames["semantic"].dtype == torch.int8
        vocab = golden_torch.sequence_vocabulary(cfg, frames["left"])
        run = golden_torch.run_golden(args, cfg, vocab, frames, "cpu",
                                      log=lambda s: None)
        gt = poses[:PREFIX].numpy().astype(np.float64)
        rec = golden_torch.make_record(args, run, frames, gt)
        assert keys <= set(rec), keys - set(rec)
        assert rec["mode"] == mode and rec["frames"] == PREFIX
        assert rec["resolution"] == [height, width]
        assert rec["semantics"] == "ground-truth"
        assert rec["world_loaded_from_json"] and rec["device"] == "cpu"
        assert rec["jax_reference"]["file"] == (
            "GOLDEN_r05_rgbd.json" if args.rgbd else "GOLDEN_r05.json")
        assert rec["recoveries"] == 0 and rec["excluded_class_voxels"] == 0
        assert rec["map_voxels"] > 0 and rec["keyframes"] >= 1
        assert np.all(np.isfinite(run["traj"]))
        assert np.isfinite(rec["ate_rmse_m"])
        ate = golden_torch.tracked_ate(run, gt)
        assert ate < PREFIX_ATE_BOUND_M[mode], ate

        written = golden_torch.write_outputs(
            rec, run, gt, tmp_path / f"GOLDEN_torch_{mode}.json",
            tmp_path / f"traj_{mode}.npz")
        back = json.loads(written["record"].read_text())
        assert set(back) == set(rec)
        assert back["ate_rmse_m"] == rec["ate_rmse_m"]
        xyz, rgb = golden_torch._map_view().read_pcd(str(written["pcd"]))
        assert len(xyz) == rec["map_voxels"]
        img = png.read_png(written["png"])
        assert img.ndim == 3 and img.shape[2] == 3 and img.any()
        traj = np.load(written["trajectory"])
        np.testing.assert_array_equal(traj["est"], run["traj"])
        md = tmp_path / "GOLDEN_TORCH.md"
        golden_torch.append_run_log(rec, args, md)
        assert md.read_text().splitlines()[-1].startswith(f"| r1  ({mode}")

    # no world file: an error that names the tool, never a drawn world
    args = golden_torch.parse_args(["--seed", "123", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="torch_golden_world.py "
                       "--seed 123 --radius 30 --boxes 48"):
        golden_torch.load_world(args, "cpu")
    with pytest.raises(FileNotFoundError, match="torch_golden_world.py"):
        tsyn.load_world_json(tmp_path / "loop_s123.json", device="cpu")
    # no card: the entry point raises before it renders anything
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            golden_torch.main(["--gt-semantics", "--frames", "2"])
