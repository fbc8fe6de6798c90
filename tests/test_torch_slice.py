"""The port's slice as a whole against the JAX package: four frames of a
JAX-rendered synthetic sequence through JAX ``track_frame`` and through the
port's ``SlamSystem.process_frame`` on the CPU, with the world, intrinsics
and config carried across by ``utils/convert.py``.

The two draw their RANSAC samples from different generators, so the poses
are held to 1e-3 (rotation) and 1e-2 m (translation) per frame rather than
to rounding, and the inlier counts may differ by 2. Moving masks may
differ in 1% of the pixels that JAX marks. (At this size VO finds no
outlier on the moving car, so both masks come out empty; the detector
itself is held with seeds on the car in test_torch_frontend.py.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.frontend import tracker as jtracker
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics as JK
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_torch.frontend import tracker as ttracker
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils import convert, metrics

torch.set_num_threads(2)
H, W = 96, 192
N_FRAMES = 5   # 4 tracked frames after the priming frame
CFG = jcfg.SlamConfig(
    camera=jcfg.CameraConfig(fx=150.0, fy=150.0, cx=W / 2, cy=H / 2,
                             baseline=0.54),
    sgbm=jcfg.SgbmConfig(num_disparities=16, sad_window_size=5,
                         p1=8 * 25, p2=32 * 25, speckle_window_size=20,
                         cost_dtype="float32"),
    quadmatch=jcfg.QuadMatchConfig(max_features=64),
    vo=jcfg.VoConfig(ransac_iters=16),
    uvdisparity=jcfg.UVDisparityConfig(min_area=5, min_intensity=6))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX sequence and its tracked results, computed once."""
    K = JK.from_config(CFG.camera)
    world = jsyn.make_world(jax.random.PRNGKey(3), n_boxes=14,
                            with_moving_box=True)
    poses = jsyn.straight_trajectory(N_FRAMES, speed=0.3, yaw_rate=0.01)
    seq = jax.tree.map(np.asarray,
                       jsyn.render_sequence(K, world, poses, H, W))
    # SlamSystem uploads float frames as uint8; feed JAX the same values
    q = {k: (np.clip(seq[k], 0, 1) * 255 + 0.5).astype(np.uint8) / 255.0
         for k in ("left", "right")}
    state = jtracker.TrackerState.initial(CFG)
    key = jax.random.PRNGKey(0)
    outs = []
    for i in range(1, N_FRAMES):
        key, k = jax.random.split(key)
        f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        state, out = jtracker.track_frame(
            state, f(q["left"][i]), f(q["right"][i]),
            f(q["left"][i - 1]), f(q["right"][i - 1]), K, k, CFG)
        outs.append(jax.tree.map(np.asarray, out))
    return seq, outs, jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def port_run(jax_run):
    seq, _, _ = jax_run
    system = SlamSystem(convert.config_from_dict(dataclasses.asdict(CFG)),
                        device="cpu")
    outs = [system.process_frame(seq["left"][i], seq["right"][i])
            for i in range(N_FRAMES)]
    return system, outs


def test_slice_matches_jax(jax_run, port_run):
    seq, jouts, jstate = jax_run
    system, touts = port_run
    assert touts[0] is None
    for j, t in zip(jouts, touts[1:]):
        assert bool(t.vo_success) and bool(j.vo_success)
        np.testing.assert_allclose(_np(t.pose)[:3, :3], j.pose[:3, :3],
                                   atol=1e-3)
        np.testing.assert_allclose(_np(t.pose)[:3, 3], j.pose[:3, 3],
                                   atol=1e-2)
        assert abs(int(t.n_inliers) - int(j.n_inliers)) <= 2
        mj, mt = j.moving_mask, _np(t.moving_mask)
        assert (mj != mt).sum() <= 0.01 * max(int(mj.sum()), 100)
        both = (j.disparity > 0) & (_np(t.disparity) > 0)
        assert both.mean() > 0.5
        assert ((j.disparity > 0) == (_np(t.disparity) > 0)).mean() > 0.999
        np.testing.assert_allclose(_np(t.disparity)[both],
                                   j.disparity[both], atol=1e-3)
        np.testing.assert_allclose(float(t.pitch), float(j.pitch),
                                   atol=1e-4)
    est = np.stack(system.trajectory)
    assert est.shape == (N_FRAMES, 4, 4)
    # VO at 150 px focal length is coarse; the port's error equals JAX's
    jest = np.stack([np.eye(4)] + [j.pose for j in jouts])
    assert abs(metrics.ate_rmse(est, seq["poses"])
               - metrics.ate_rmse(jest, seq["poses"])) < 1e-2

    st = system.state
    assert int(st.status) == int(jstate.status) == ttracker.OK
    assert int(st.frame_index) == int(jstate.frame_index) == N_FRAMES - 1
    np.testing.assert_allclose(_np(st.pitch_kf.x), jstate.pitch_kf.x,
                               atol=1e-4)
    assert [f.vo_success for f in system.frame_log] == [True] * 4


def test_process_stream_equals_process_frame(jax_run, port_run):
    seq, _, _ = jax_run
    ref, _ = port_run
    system = SlamSystem(ref.cfg, device="cpu")
    system.process_stream(zip(seq["left"], seq["right"]), depth=2)
    assert system.frame_count == N_FRAMES
    np.testing.assert_allclose(np.stack(system.trajectory),
                               np.stack(ref.trajectory), atol=1e-6)
    assert system.frame_log == ref.frame_log
