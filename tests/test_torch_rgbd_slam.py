"""RGB-D mode of the port's whole ``SlamSystem`` against the JAX package's,
on the scene of test_rgbd_slam.py (128x192, 16 frames, 0.12 m a frame),
rendered by the JAX package; both vocabularies are built from the same JAX
ORB descriptors (``build_vocabulary`` is bit-identical).

Test 1: ``process_stream_rgbd`` with gray, depth, uint8 color and labels,
the map on, then ``finish()``: the same keyframes (frame indices), the same
edge list (ends and loop flags, so equal odometry, nearby and loop edge
counts), the same optimisation counts, the trajectory within 1e-4 and the
map's voxel count within 0.1% of JAX's; keyframes hold no right image.

Test 2: ``process_frame_rgbd`` equals ``process_stream_rgbd`` (mid-stream
optimisations off, as in test_rgbd_slam.py: the same keyframes and edges,
trajectories within 1e-5), and ``_kf_cloud(..., depth_input=True)`` of a
keyframe's float16 depth, gray image, uint8 color and labels, at cloud
strides 1 and 2, equals JAX's jitted ``_kf_cloud_jit(...,
depth_input=True)`` exactly (quantized arrays and counts).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu.backend import looper as jlp
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics
from semantic_slam_mapping_tpu.io import synthetic
from semantic_slam_mapping_tpu.ops import orb as jorb
from semantic_slam_mapping_tpu.pipeline import SlamSystem as JaxSlam
from semantic_slam_mapping_tpu.pipeline import _kf_cloud_jit
from semantic_slam_mapping_torch.backend import looper as tlp
from semantic_slam_mapping_torch.pipeline import SlamSystem, _kf_cloud
from semantic_slam_mapping_torch.utils import convert

from tests.test_rgbd_slam import CAM, CFG, H, N_FRAMES, W

torch.set_num_threads(4)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
K = Intrinsics.from_config(CAM)
TK = convert.intrinsics_from_numpy(*K)


@pytest.fixture(scope="module")
def scene():
    world = synthetic.make_world(jax.random.PRNGKey(11), n_boxes=20)
    poses = synthetic.straight_trajectory(N_FRAMES, speed=0.12,
                                          yaw_rate=0.004)
    seq = jax.tree.map(np.asarray, synthetic.render_sequence(K, world, poses,
                                                             H, W))
    f = jorb.extract(jnp.asarray(seq["left"][0]), CFG.orb)
    descs = np.asarray(f.desc)[np.asarray(f.valid)]
    color = np.stack([(np.clip(seq["left"], 0, 1) * 255).astype(np.uint8)]
                     * 3, -1)
    return (seq, color, jlp.build_vocabulary(descs, branching=6, depth=3),
            tlp.build_vocabulary(descs, branching=6, depth=3))


def _edges(s):
    n = s.n_edges
    return list(zip(s.graph.edge_i[:n].tolist(), s.graph.edge_j[:n].tolist(),
                    s.graph.edge_is_loop[:n].tolist()))


def test_rgbd_system_matches_jax(scene):
    seq, color, jvocab, tvocab = scene
    frames = [(seq["left"][i], seq["depth"][i], color[i], seq["semantic"][i])
              for i in range(N_FRAMES)]
    js = JaxSlam(CFG, vocab=jvocab, enable_mapping=True, rgbd=True)
    js.process_stream_rgbd(iter(frames))
    jt = js.finish()
    ts = SlamSystem(TCFG, vocab=tvocab, enable_mapping=True, rgbd=True,
                    device="cpu")
    ts.process_stream_rgbd(iter(frames))
    tt = ts.finish()

    assert ([k.frame_index for k in ts.keyframes]
            == [k.frame_index for k in js.keyframes])
    assert len(ts.keyframes) >= 3
    assert _edges(ts) == _edges(js)
    assert ts.n_loop_edges == js.n_loop_edges >= 1
    assert (ts.n_local_optimizations, ts.n_global_optimizations) == (
        js.n_local_optimizations, js.n_global_optimizations)
    np.testing.assert_allclose(tt, jt, atol=1e-4)
    assert abs(len(ts.map) - len(js.map)) <= 1e-3 * len(js.map)
    assert all(k.right is None for k in ts.keyframes)
    assert ts.keyframes[0].disparity is not None


def test_rgbd_serial_stream_and_depth_cloud(scene):
    seq, color, _, _ = scene
    gray, depth = seq["left"], seq["depth"]
    cfg = TCFG.replace(pose_graph=dataclasses.replace(
        TCFG.pose_graph, local_accumulate_error=1e9,
        loop_accumulate_error=1e9))
    a = SlamSystem(cfg, rgbd=True, device="cpu")
    for i in range(N_FRAMES):
        a.process_frame_rgbd(gray[i], depth[i])
    b = SlamSystem(cfg, rgbd=True, device="cpu")
    b.process_stream_rgbd((gray[i], depth[i]) for i in range(N_FRAMES))
    ta, tb = a.finish(), b.finish()
    assert len(a.keyframes) == len(b.keyframes) >= 3
    assert _edges(a) == _edges(b)
    np.testing.assert_allclose(ta, tb, atol=1e-5)

    kf = a.keyframes[1]
    disp, left = kf.disparity, kf.left          # float16 depth and gray
    labels = seq["semantic"][kf.frame_index].astype(np.int32)
    rgb = color[kf.frame_index]
    for stride in (1, 2):
        jm = dataclasses.replace(CFG.mapper, cloud_stride=stride)
        tm = dataclasses.replace(TCFG.mapper, cloud_stride=stride)
        j = _kf_cloud_jit(jnp.asarray(disp), jnp.asarray(left),
                          jnp.asarray(rgb), jnp.asarray(labels), None, K,
                          CFG.camera, jm, jm.max_points_per_frame,
                          depth_input=True)
        t = _kf_cloud(torch.from_numpy(disp), torch.from_numpy(left),
                      torch.from_numpy(rgb), torch.from_numpy(labels).long(),
                      None, TK, tm, depth_input=True)
        n = int(j[3])
        assert n > 500 and int(t[3]) == n, (stride, n, int(t[3]))
        for x, y in zip(j[:3], t[:3]):
            np.testing.assert_array_equal(np.asarray(x)[:n], y.numpy()[:n])
