"""Shared inputs of the port's parity tests: a small stereo camera, its
JAX and port intrinsics and configs, and two frames of a synthetic street
with a moving car, rendered once per process on the CPU."""

import dataclasses
import functools

import numpy as np
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics as JK
from semantic_slam_mapping_torch.io import synthetic as tsyn
from semantic_slam_mapping_torch.utils import convert

H, W = 96, 192
JCAM = jcfg.CameraConfig(fx=150.0, fy=150.0, cx=W / 2, cy=H / 2,
                         baseline=0.54)
QCFG = jcfg.QuadMatchConfig(max_features=64)
TCFG = convert.config_from_dict(dataclasses.asdict(
    jcfg.SlamConfig(camera=JCAM, quadmatch=QCFG)))
JK_ = JK.from_config(JCAM)
TK = convert.intrinsics_from_numpy(*JK_)


def to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.cache
def street_frames():
    """Two stereo frames 0.4 m apart (dict of numpy arrays)."""
    gen = torch.Generator().manual_seed(5)
    world = tsyn.make_world(gen, n_boxes=14, with_moving_box=True,
                            device="cpu")
    poses = tsyn.straight_trajectory(2, speed=0.4, yaw_rate=0.01,
                                     device="cpu")
    seq = tsyn.render_sequence(TK, world, poses, H, W)
    return {k: v.numpy() for k, v in seq.items()}


def gt_disparity(depth):
    """(disparity, valid) of a rendered depth image."""
    valid = depth > 0.3
    disp = np.where(valid, TK.bf / np.maximum(depth, 0.3), 0.0)
    return disp.astype(np.float32), valid
