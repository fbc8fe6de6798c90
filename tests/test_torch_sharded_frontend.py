"""The port's sharded window frontend and mesh-mode ``SlamSystem`` over
gloo with 2 and 4 ranks on the CPU (the rank bodies are in
``torch_mesh_ranks.py``), on the JAX package's dry-run frontend
configuration (``__graft_entry__.py:117-131``: 64x128, 16 disparities, 64
KLT features, 16 RANSAC hypotheses) with the float32 cost volume and the
exact SGM scan, over a JAX-rendered street. VO runs 4 Gauss-Newton steps a
hypothesis and 2 of refinement, so that a pair's motion shows which
samples it was given (with the default 100 every good sample refines to
the same motion).

Test 1: ``track_frames_sharded`` on a window of B = 4 pairs, with the
samples JAX's ``track_frames_batched`` draws, passed as a function of the
gathered valid-match counts: the counts it is given equal the port's
single-device ones, and each rank ran B/n pairs. Against the port's
``track_frames_batched`` with the same samples: disparities, valid
pixels, matches, statuses, successes, inliers and moving masks equal,
poses, motions and the pitch within 1e-5 (VO's batched solve over B/n
pairs rounds apart from one over B). Against JAX's
``track_frames_batched``: poses within 1e-4 in rotation and 1e-3 m, the
final state too, pitch within 1e-4, as tests/test_torch_window.py holds
the single-device window. Drawing from a generator seeded 0, the sharded
window's poses are within 1e-5 of the port's single-device window drawn
from the same seed (every rank draws the whole window's samples and keeps
its rows).

Test 2: ``SlamSystem(mesh=...)`` with a vocabulary and the map over two
windows of 4 pairs (frames 0-4, then 4-8), then ``finish()``, against the
meshless port system on the same frames: ``frame_count`` B + 1 after the
first window, the same keyframes and statuses, the trajectory within
1e-5 and the finished one within 1e-4 (the forced global solve sums over
edge shards); the window, BoW and solve collectives ran, the map is the
sharded one and its voxel keys are within 1% of the meshless C++ map's
(each rank's slab far under its budget).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.frontend import tracker as jtracker
from semantic_slam_mapping_tpu.frontend import vo as jvo
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics as JK
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_torch.backend import looper
from semantic_slam_mapping_torch.frontend import tracker as ttracker
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils import convert

from torch_mesh_ranks import run_ranks

torch.set_num_threads(2)
H, W, B = 64, 128, 4
CFG = jcfg.SlamConfig(
    camera=jcfg.CameraConfig(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2,
                             baseline=0.54),
    sgbm=jcfg.SgbmConfig(num_disparities=16, sad_window_size=5,
                         p1=8 * 25, p2=32 * 25, speckle_window_size=20,
                         cost_dtype="float32", scan_block=0),
    quadmatch=jcfg.QuadMatchConfig(max_features=64),
    orb=jcfg.OrbConfig(n_features=128, n_levels=3,
                       max_candidates_per_level=512),
    pose_graph=jcfg.PoseGraphConfig(max_keyframes=32, pcg_iters=8,
                                    keyframe_min_translation=0.05),
    vo=jcfg.VoConfig(ransac_iters=16, gn_iters_hypothesis=4,
                     gn_iters_refine=2))
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
JKI = JK.from_config(CFG.camera)
TKI = convert.intrinsics_from_numpy(*JKI)
WINDOWS = ((0, B + 1), (B, 2 * B + 1))


@pytest.fixture(scope="module")
def street():
    world = jsyn.make_world(jax.random.PRNGKey(11), n_boxes=10)
    poses = jsyn.straight_trajectory(2 * B + 1, speed=0.5)
    return jax.tree.map(np.asarray,
                        jsyn.render_sequence(JKI, world, poses, H, W))


def jax_picks(key, n_valid):
    """The samples JAX's window draws from ``key`` for pairs with these
    valid-match counts."""
    R = CFG.vo.ransac_iters
    keys = jax.random.split(key, int(n_valid.shape[0]))
    return torch.from_numpy(np.stack([np.asarray(jax.vmap(
        jvo._distinct3, in_axes=(0, None))(
            jax.random.split(keys[i], R), jnp.int32(int(n_valid[i]))))
        for i in range(int(n_valid.shape[0]))]))


def _inputs(street, **extra):
    return dict(cfg_json=json.dumps(dataclasses.asdict(CFG)),
                K=np.array(list(JKI), np.float64), **extra)


def test_track_frames_sharded_matches_batched(street, tmp_path):
    L, R = street["left"][:B + 1], street["right"][:B + 1]
    key = jax.random.PRNGKey(0)
    jstate, jout = jtracker.track_frames_batched(
        jtracker.TrackerState.initial(CFG), jnp.asarray(L), jnp.asarray(R),
        JKI, key, CFG)
    jout = jax.tree.map(np.asarray, jout)
    st0 = ttracker.TrackerState.initial(TCFG, "cpu")
    drawn = []

    def picks(n_valid):
        drawn.append((n_valid.numpy(), jax_picks(key, n_valid)))
        return drawn[-1][1]

    tstate, tout = ttracker.track_frames_batched(
        st0, torch.from_numpy(L), torch.from_numpy(R), TKI, None, TCFG,
        picks=picks)
    _, tout_g = ttracker.track_frames_batched(
        st0, torch.from_numpy(L), torch.from_numpy(R), TKI,
        torch.Generator().manual_seed(0), TCFG)
    assert jout.vo_success.all() and tout.vo_success.all()
    np.savez(tmp_path / "inputs.npz", lefts=L, rights=R,
             picks=drawn[0][1].numpy(), **_inputs(street))

    for n in (2, 4):
        for out in run_ranks("sharded_window", n, tmp_path):
            assert out["local_pairs"] == B // n
            np.testing.assert_array_equal(out["seen_n_valid"],
                                          drawn[0][0][None])
            for f in ("disparity", "n_matches", "status", "vo_success",
                      "n_inliers", "moving_mask"):
                np.testing.assert_array_equal(
                    out[f], getattr(tout, f).numpy(), err_msg=f)
            np.testing.assert_array_equal(out["lc"], tout.matches.lc.numpy())
            for f in ("pose", "T_delta", "pitch"):
                np.testing.assert_allclose(out[f], getattr(tout, f).numpy(),
                                           atol=1e-5, err_msg=f)
            np.testing.assert_allclose(out["state_pose"],
                                       tstate.pose.numpy(), atol=1e-5)
            # against JAX's window
            np.testing.assert_array_equal(out["valid_px"],
                                          jout.disparity > 0)
            np.testing.assert_array_equal(out["status"], jout.status)
            np.testing.assert_allclose(out["pose"][:, :3, :3],
                                       jout.pose[:, :3, :3], atol=1e-4)
            np.testing.assert_allclose(out["pose"][:, :3, 3],
                                       jout.pose[:, :3, 3], atol=1e-3)
            np.testing.assert_allclose(out["state_pose"][:3, 3],
                                       np.asarray(jstate.pose)[:3, 3],
                                       atol=1e-3)
            np.testing.assert_allclose(out["state_pitch_x"],
                                       np.asarray(jstate.pitch_kf.x),
                                       atol=1e-4)
            np.testing.assert_allclose(out["pitch"], jout.pitch, atol=1e-4)
            # the generator's samples: those of the single-device window
            np.testing.assert_allclose(out["gen_pose"],
                                       tout_g.pose.numpy(), atol=1e-5)


def test_mesh_system_matches_meshless(street, tmp_path):
    rng = np.random.default_rng(0)
    desc = rng.integers(0, 2, (400, 256)).astype(np.uint8)
    L, R, S = street["left"], street["right"], street["semantic"]
    np.savez(tmp_path / "inputs.npz", lefts=L, rights=R, labels=S,
             vocab_desc=desc, windows=np.array(WINDOWS), **_inputs(street))

    ref = SlamSystem(TCFG, vocab=looper.build_vocabulary(desc, 4, 2),
                     enable_mapping=True, device="cpu")
    for lo, hi in WINDOWS:
        ref.process_window(L[lo:hi], R[lo:hi], semantics=S[lo:hi])
    traj = np.stack(ref.trajectory)
    final = ref.finish()
    ref_keys = set(map(tuple, np.floor(
        ref.map.as_arrays()[0] / TCFG.mapper.resolution).astype(
            np.int64).tolist()))
    assert len(ref.keyframes) >= 4 and len(ref_keys) > 100

    for n in (2, 4):
        for out in run_ranks("mesh_system", n, tmp_path):
            assert out["frame_counts"].tolist() == [B + 1, 2 * B + 1]
            np.testing.assert_array_equal(
                out["keyframes"], [k.frame_index for k in ref.keyframes])
            np.testing.assert_array_equal(
                out["statuses"], [f.status for f in ref.frame_log])
            np.testing.assert_allclose(out["trajectory"], traj, atol=1e-5)
            np.testing.assert_allclose(out["finish"], final, atol=1e-4)
            assert out["n_optimizations"] == ref.n_optimizations >= 1
            # all_gather (window, BoW, map export), all_reduce (solve,
            # map length), ring exchange (map fusion)
            assert (out["calls"] > 0).all(), out["calls"]
            keys = set(map(tuple, np.floor(
                out["map_xyz"] / TCFG.mapper.resolution).astype(
                    np.int64).tolist()))
            assert out["map_len"] == len(out["map_xyz"])
            assert len(keys ^ ref_keys) <= 0.01 * len(ref_keys), (
                len(keys ^ ref_keys), len(ref_keys))
