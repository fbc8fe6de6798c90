"""The port's RGB-D tracker against the JAX package's, on the scene of
test_rgbd_tracker.py (160x320, 6 frames of gray and metric depth, 0.25 m a
frame), rendered by the JAX package and fed to both as the same numpy
arrays.

Test 1: ``track_frame_rgbd`` over the sequence: status, verdict, matches
and PnP inliers equal on every frame; poses within 1e-4 on the frames
where PnP succeeds (all but the first, which holds the identity); the ring
after the run: validity, pointer and descriptors equal, world points
within 1e-4 m.

Test 2: ``adjust`` on the state after three frames (a pose moved by 0.3 m
and 0.05 rad): pose and world points within 1e-5 of JAX's, and the next
frame tracked from the adjusted state within 1e-4; then the lost case of
test_rgbd_tracker.py (``max_lost_frames=1``, three frames of seeded
uniform noise): the same statuses and verdicts, LOST at the end.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu.frontend import rgbd_tracker as jrt
from semantic_slam_mapping_tpu.geometry import se3 as jse3
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics
from semantic_slam_mapping_tpu.io import synthetic
from semantic_slam_mapping_torch.frontend import rgbd_tracker as trt
from semantic_slam_mapping_torch.utils import convert

from tests.test_rgbd_tracker import CAM, CFG, H, N_FRAMES, W

torch.set_num_threads(2)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
K = Intrinsics.from_config(CAM)
TK = convert.intrinsics_from_numpy(*K)
POSE_TOL = 1e-4


@pytest.fixture(scope="module")
def scene():
    world = synthetic.make_world(jax.random.PRNGKey(60), n_boxes=12)
    poses = synthetic.straight_trajectory(N_FRAMES, speed=0.25,
                                          yaw_rate=0.01)
    grays, depths = [], []
    for i in range(N_FRAMES):
        g, d, _, _ = synthetic.render(K, poses[i], world, H, W)
        grays.append(np.asarray(g))
        depths.append(np.asarray(d))
    return np.stack(grays), np.stack(depths)


def _step(js, ts, gray, depth, jc=CFG, tc=TCFG):
    js, jo = jrt.track_frame_rgbd(js, jnp.asarray(gray), jnp.asarray(depth),
                                  K, jc)
    ts, to = trt.track_frame_rgbd(ts, torch.from_numpy(gray.copy()),
                                  torch.from_numpy(depth.copy()), TK, tc)
    for f in ("status", "success", "n_matches", "n_inliers"):
        assert int(getattr(jo, f)) == int(getattr(to, f)), f
    if bool(jo.success):
        np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                                   atol=POSE_TOL)
    return js, jo, ts, to


def test_track_frame_rgbd_matches_jax(scene):
    grays, depths = scene
    js = jrt.RgbdTrackerState.initial(CFG.orb.n_features)
    ts = trt.RgbdTrackerState.initial(TCFG.orb.n_features, device="cpu")
    for i in range(N_FRAMES):
        js, jo, ts, to = _step(js, ts, grays[i], depths[i])
        assert bool(to.success) == (i > 0) and int(to.n_inliers) >= (
            10 if i else 0)
    np.testing.assert_array_equal(ts.ref_valid.numpy(),
                                  np.asarray(js.ref_valid))
    np.testing.assert_array_equal(ts.ref_desc.numpy(),
                                  np.asarray(js.ref_desc))
    assert int(ts.ref_ptr) == int(js.ref_ptr) == N_FRAMES
    np.testing.assert_allclose(ts.ref_xyz_w.numpy(), np.asarray(js.ref_xyz_w),
                               atol=1e-4)


def test_adjust_and_lost_match_jax(scene):
    grays, depths = scene
    js = jrt.RgbdTrackerState.initial(CFG.orb.n_features)
    ts = trt.RgbdTrackerState.initial(TCFG.orb.n_features, device="cpu")
    for i in range(3):
        js, _, ts, _ = _step(js, ts, grays[i], depths[i])
    new_pose = np.asarray(jse3.compose(
        js.pose, jse3.exp(jnp.array([0.3, 0.0, -0.2, 0.0, 0.05, 0.0]))),
        np.float32)
    js = jrt.adjust(js, jnp.asarray(new_pose))
    ts = trt.adjust(ts, torch.from_numpy(new_pose.copy()))
    np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose),
                               atol=1e-5)
    np.testing.assert_allclose(ts.ref_xyz_w.numpy(), np.asarray(js.ref_xyz_w),
                               atol=1e-5)
    assert int(ts.status) == int(js.status) == trt.OK
    js, jo, ts, to = _step(js, ts, grays[3], depths[3])
    assert bool(to.success)

    jc = CFG.replace(tracker=CFG.tracker.__class__(max_lost_frames=1))
    tc = TCFG.replace(tracker=TCFG.tracker.__class__(max_lost_frames=1))
    js = jrt.RgbdTrackerState.initial(CFG.orb.n_features)
    ts = trt.RgbdTrackerState.initial(TCFG.orb.n_features, device="cpu")
    js, _, ts, _ = _step(js, ts, grays[0], depths[0], jc, tc)
    rng = np.random.default_rng(0)
    for _ in range(3):
        noise = rng.uniform(0, 1, (H, W)).astype(np.float32)
        js, jo, ts, to = _step(js, ts, noise, depths[0], jc, tc)
        assert not bool(to.success)
    assert int(ts.status) == int(js.status) == trt.LOST
