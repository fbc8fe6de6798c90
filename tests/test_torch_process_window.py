"""The port's ``SlamSystem.process_window`` against the JAX package's, on
test_pipeline.py's camera and scene size (128x384), in two windows that
overlap by one frame (frames 0-4, then 4-8), as tests/test_process_window.py
drives it.

JAX runs with the float32 cost volume and the exact SGM scan
(``scan_block=0``), and ``max_lost_frames=1``. PyTorch cannot replay
``jax.random``, so the port's window samples are JAX's, replayed through
``SlamSystem._window_picks``. Tolerances, as in test_torch_slice.py: the
trajectories within 1e-3 in rotation and 1e-2 m, before and after
``finish()``; the keyframes' count and frame indices equal.

Test 2 blanks frame 6: the pairs (5, 6) and (6, 7) fail, the second one
turns the tracker LOST in the middle of the second window, frame 7 is
relocalised against the reference keyframes, and frame 8, integrated from
the lost pose, moves by the same correction, as does the tracker state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu.config import (CameraConfig, OrbConfig,
                                              PoseGraphConfig, SgbmConfig,
                                              SlamConfig, TrackerConfig,
                                              VoConfig)
from semantic_slam_mapping_tpu.frontend import tracker as jtracker
from semantic_slam_mapping_tpu.frontend import vo as jvo
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics
from semantic_slam_mapping_tpu.io import synthetic
from semantic_slam_mapping_tpu.pipeline import SlamSystem as JaxSlam
from semantic_slam_mapping_torch.frontend import tracker as ttracker
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils import convert, metrics

torch.set_num_threads(2)
H, W = 128, 384
CAM = CameraConfig(fx=250.0, fy=250.0, cx=W / 2, cy=H / 2, baseline=0.54)
CFG = SlamConfig(
    camera=CAM,
    sgbm=SgbmConfig(num_disparities=48, sad_window_size=7,
                    p1=8 * 49, p2=32 * 49, speckle_window_size=50,
                    cost_dtype="float32", scan_block=0),
    vo=VoConfig(ransac_iters=40, gn_iters_hypothesis=8, gn_iters_refine=25),
    orb=OrbConfig(n_features=256, n_levels=4),
    pose_graph=PoseGraphConfig(keyframe_min_translation=1.2,
                               keyframe_min_rotation=0.4,
                               pcg_iters=40, max_keyframes=64),
    tracker=TrackerConfig(max_lost_frames=1))
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
WINDOWS = (slice(0, 5), slice(4, 9))


@pytest.fixture(scope="module")
def scene():
    K = Intrinsics.from_config(CAM)
    world = synthetic.make_world(jax.random.PRNGKey(80), n_boxes=14)
    poses = synthetic.straight_trajectory(9, speed=0.5)
    return jax.tree.map(np.asarray,
                        synthetic.render_sequence(K, world, poses, H, W))


def _run_both(monkeypatch, lefts, rights):
    """Both systems over the two windows; the port replays the RANSAC
    samples JAX's windows drew."""
    keys = []
    jax_batched = jtracker.track_frames_batched

    def recording(state, l, r, K, key, cfg):
        keys.append(key)
        return jax_batched(state, l, r, K, key, cfg)

    monkeypatch.setattr(jtracker, "track_frames_batched", recording)
    jsys = JaxSlam(CFG)
    for w in WINDOWS:
        jsys.process_window(lefts[w], rights[w])

    tsys = SlamSystem(TCFG, device="cpu")

    def replay(n_valid):
        pair_keys = jax.random.split(keys[len(replayed)], len(n_valid))
        replayed.append(1)
        return torch.from_numpy(np.stack([np.asarray(jax.vmap(
            jvo._distinct3, in_axes=(0, None))(
                jax.random.split(pair_keys[i], CFG.vo.ransac_iters),
                jnp.int32(int(n_valid[i])))) for i in range(len(n_valid))]))

    replayed = []
    monkeypatch.setattr(tsys, "_window_picks", replay)
    outs = [tsys.process_window(lefts[w], rights[w]) for w in WINDOWS]
    assert len(replayed) == len(keys) == len(WINDOWS)
    return jsys, tsys, outs


def _assert_close_traj(a, b):
    a, b = np.stack(a), np.stack(b)
    assert a.shape == b.shape == (9, 4, 4)
    np.testing.assert_allclose(a[:, :3, :3], b[:, :3, :3], atol=1e-3)
    np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], atol=1e-2)


def _assert_systems_agree(jsys, tsys):
    _assert_close_traj(tsys.trajectory, jsys.trajectory)
    assert ([k.frame_index for k in tsys.keyframes]
            == [k.frame_index for k in jsys.keyframes])
    assert tsys.n_recoveries == jsys.n_recoveries
    assert tsys.frame_count == jsys.frame_count == 9
    np.testing.assert_allclose(tsys._state_pose()[:3, 3],
                               np.asarray(jsys.state.pose)[:3, 3],
                               atol=1e-2)
    _assert_close_traj(list(tsys.finish()), list(jsys.finish()))


def test_process_window_matches_jax(scene, monkeypatch):
    jsys, tsys, outs = _run_both(monkeypatch, scene["left"], scene["right"])
    assert all(bool(o.vo_success.all()) for o in outs)
    assert outs[0].disparity.shape == (4, H, W)
    assert len(tsys.keyframes) >= 2
    assert [f.vo_success for f in tsys.frame_log] == [True] * 8
    assert int(tsys.state.frame_index) == 8
    _assert_systems_agree(jsys, tsys)
    ate = metrics.ate_rmse(np.stack(tsys.trajectory), scene["poses"])
    assert ate < 0.6, ate


def test_mid_window_lost_relocalises_as_jax(scene, monkeypatch):
    lefts, rights = scene["left"].copy(), scene["right"].copy()
    lefts[6] = 0.0
    rights[6] = 0.0
    jsys, tsys, outs = _run_both(monkeypatch, lefts, rights)
    status = outs[1].status.numpy()
    assert list(outs[1].vo_success.numpy()) == [True, False, False, True]
    assert status[2] == ttracker.LOST
    assert tsys.n_recoveries == 1
    # the tracker is OK again after the relocalised frame
    assert int(tsys.state.status) == ttracker.OK
    # frame 8, integrated from frame 7's lost pose, moved by the recovery's
    # correction (taken before finish() rewrites the trajectory)
    raw = outs[1].pose.double().numpy()
    C = tsys.trajectory[7] @ np.linalg.inv(raw[2])
    np.testing.assert_allclose(tsys.trajectory[8], C @ raw[3], atol=1e-6)
    assert not np.allclose(C, np.eye(4), atol=1e-3)
    _assert_systems_agree(jsys, tsys)
