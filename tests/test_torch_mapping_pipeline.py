"""The mapping slice of the port's SlamSystem against the JAX package's.

Test 1: the JAX ``SlamSystem(enable_mapping=True)`` runs 10 frames of the
128x384 scene of test_pipeline.py with color and ground-truth labels, its
map rebuilt in full at every 3rd update. The port's map machinery is fed
the JAX run's keyframes (poses, float16 disparity and gray image, color,
labels) and the moving masks JAX's clouds were made with (the U-V masks
with a planted block), and replays
JAX's map updates with the keyframe poses each update saw:
``_kf_cloud_camera`` (the deferred two-stage readback), ``_update_map``
(its rebuild and incremental branches), ``_insert_kf_into_map`` and the C++
map. Tolerance: the same voxels (sorted by key) with equal labels,
positions and colors within 1e-5.

Test 2: the port's own run with online SegNet (the shipped slim
``segnet.pkl``) on the pedestrian scene of test_segnet.py (a static
pedestrian-shaped box that only the learned labels can remove): the port
finds the pedestrian on its keyframes, keeps no pedestrian voxel and maps
under a fifth of the box's voxels that a run without labels maps; its
keyframe labels agree with the JAX package's ``_run_segnet`` on the same
keyframe images, run op by op, on at least 99% of the pixels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_tpu.pipeline import SlamSystem as JaxSlam
from semantic_slam_mapping_torch.mapping import semantics
from semantic_slam_mapping_torch.pipeline import Keyframe, SlamSystem
from semantic_slam_mapping_torch.utils import convert

from tests.test_segnet import SHIPPED
from tests.test_pipeline import CFG as PIPELINE_CFG

torch.set_num_threads(4)

CFG = dataclasses.replace(
    PIPELINE_CFG, mapper=jcfg.MapperConfig(full_rebuild_every=3))
H, W = 128, 384
N_FRAMES = 10


def _sorted_map(m, res=0.1):
    xyz, rgb, lbl = m.as_arrays()
    key = np.floor(xyz / res).astype(np.int64)
    order = np.lexsort(key.T[::-1])
    return key[order], xyz[order], rgb[order], lbl[order]


def test_port_map_of_jax_keyframes_matches_jax(monkeypatch):
    K = Intrinsics.from_config(CFG.camera)
    world = jsyn.make_world(jax.random.PRNGKey(30), n_boxes=16,
                            with_moving_box=True)
    poses = jsyn.straight_trajectory(N_FRAMES, speed=0.45, yaw_rate=0.01)
    seq = jax.tree.map(np.asarray, jsyn.render_sequence(K, world, poses, H,
                                                        W))
    grey = seq["left"]
    color = np.clip(np.stack([grey, grey * 0.8, grey * 0.6], -1) * 255,
                    0, 255).astype(np.uint8)

    masks, updates = {}, []
    dispatch, update = JaxSlam._dispatch_kf_cloud, JaxSlam._update_map
    # the U-V detector marks nothing on this scene: a block is added to
    # each keyframe's moving mask, so the clouds exercise the mask
    planted = np.zeros((H, W), bool)
    planted[40:80, 150:230] = True

    def recording_dispatch(self, kf, moving_mask=None):
        if moving_mask is not None:
            moving_mask = jnp.asarray(np.asarray(moving_mask) | planted)
            masks[kf.kf_id] = np.array(moving_mask)
        return dispatch(self, kf, moving_mask)

    def recording_update(self, kf):
        updates.append((kf.kf_id, [k.pose.copy() for k in self.keyframes]))
        return update(self, kf)

    monkeypatch.setattr(JaxSlam, "_dispatch_kf_cloud", recording_dispatch)
    monkeypatch.setattr(JaxSlam, "_update_map", recording_update)
    jsys = JaxSlam(CFG, enable_mapping=True)
    for i in range(N_FRAMES):
        jsys.process_frame(seq["left"][i], seq["right"][i], color=color[i],
                           semantic=seq["semantic"][i])
    jsys.finish()
    kfs = jsys.keyframes
    assert len(kfs) >= 3 and len(updates) == len(kfs) == len(masks)

    tsys = SlamSystem(convert.config_from_dict(dataclasses.asdict(CFG)),
                      enable_mapping=True, device="cpu")
    for k in kfs:
        tsys.keyframes.append(Keyframe(
            kf_id=k.kf_id, frame_index=k.frame_index, pose=k.pose.copy(),
            disparity_dev=torch.from_numpy(np.array(k.disparity)),
            left_dev=torch.from_numpy(np.array(k.left)), color=k.color,
            semantic_host=k.semantic))
    for k in tsys.keyframes:
        tsys._kf_cloud_camera(k, torch.from_numpy(masks[k.kf_id]))
    for kf_id, kf_poses in updates:
        for k, p in zip(tsys.keyframes, kf_poses):
            k.pose = p
        tsys._update_map(tsys.keyframes[kf_id])
    assert tsys._map_updates == len(updates) >= 3

    ka, xa, ra, la = _sorted_map(jsys.map)
    kb, xb, rb, lb = _sorted_map(tsys.map)
    assert len(ka) > 1000 and np.array_equal(ka, kb)
    assert np.array_equal(la, lb)
    np.testing.assert_allclose(xb, xa, atol=1e-5)
    np.testing.assert_allclose(rb, ra, atol=1e-5)
    assert not np.isin(lb, semantics.MAP_EXCLUDED_CLASSES).any()


def _pedestrian_scene():
    """The scene and configuration of test_segnet.py's pedestrian test."""
    h, w = 96, 256
    cam = jcfg.CameraConfig(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2,
                            baseline=0.54)
    base = jcfg.default_config()
    cfg = dataclasses.replace(
        base, camera=cam,
        mapper=dataclasses.replace(base.mapper, dilate_iters=4),
        segnet=dataclasses.replace(base.segnet, online=True,
                                   weights=str(SHIPPED), input_height=h,
                                   input_width=w))
    w0 = jsyn.make_world(jax.random.PRNGKey(5), n_boxes=8)
    ground = float(w0.ground_y)
    pmin = jnp.array([[0.7, ground - 1.8, 7.7]])
    pmax = jnp.array([[1.3, ground + 0.01, 8.3]])
    world = jsyn.World(
        boxes=jnp.concatenate([w0.boxes, jnp.stack([pmin, pmax], 1)], 0),
        box_class=jnp.concatenate(
            [w0.box_class, jnp.array([jsyn.CLASS_PEDESTRIAN], jnp.int32)]),
        ground_y=w0.ground_y, backdrop_z=w0.backdrop_z, box_velocity=None)
    poses = jsyn.straight_trajectory(6, speed=0.3)
    seq = jax.tree.map(np.asarray, jsyn.render_sequence(
        Intrinsics.from_config(cam), world, poses, h, w))
    return cfg, seq, ground


@pytest.mark.skipif(not SHIPPED.exists(), reason="no shipped checkpoint")
def test_online_segnet_run_filters_pedestrian():
    cfg, seq, ground = _pedestrian_scene()
    g = (np.clip(seq["left"], 0, 1) * 255).astype(np.uint8)
    frames = [(seq["left"][i], seq["right"][i], np.stack([g[i]] * 3, -1))
              for i in range(len(g))]

    def run(online):
        c = dataclasses.replace(cfg, segnet=dataclasses.replace(
            cfg.segnet, online=online))
        s = SlamSystem(convert.config_from_dict(dataclasses.asdict(c)),
                       enable_mapping=True, device="cpu")
        s.process_stream(frames)
        s.finish()
        return s

    port, ctrl = run(True), run(False)

    def ped_voxels(m):
        xyz, _, _ = m.as_arrays()
        return int(((xyz[:, 0] > 0.55) & (xyz[:, 0] < 1.45)
                    & (xyz[:, 2] > 7.55) & (xyz[:, 2] < 8.45)
                    & (xyz[:, 1] < ground - 0.15)).sum())

    assert len(port.map) > 100 and len(ctrl.map) > 100
    kf_sem = [k.semantic for k in port.keyframes]
    assert all(s is not None and s.dtype == np.int8 for s in kf_sem)
    assert any((s == semantics.PEDESTRIAN).sum() > 50 for s in kf_sem)
    assert not (port.map.as_arrays()[2] == semantics.PEDESTRIAN).any()
    n_ctrl, n_port = ped_voxels(ctrl.map), ped_voxels(port.map)
    assert n_ctrl > 30 and n_port < 0.2 * n_ctrl, (n_port, n_ctrl)

    # the JAX package's online labels of the same keyframe images
    jsys = JaxSlam(cfg)
    agree = []
    for k in port.keyframes:
        color = frames[k.frame_index][2]
        with jax.disable_jit():
            lab = np.asarray(jsys._run_segnet(None, color))
        agree.append(float((lab == k.semantic).mean()))
    assert min(agree) >= 0.99, agree
