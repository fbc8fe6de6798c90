"""Dense semantic point-cloud mapping.

Counterpart of ``semantic_slam_mapping_tpu/mapping/mapper.py``. One
keyframe becomes a filtered, voxelized world-frame cloud on the device
(:func:`generate_point_cloud`): depth, moving-mask and class filters, a
back-projection, then one point per 10 cm voxel by a stable sort of the
voxel keys and a compaction into a fixed budget. The global map is a
host-side accumulator (:class:`GlobalMap` here in numpy, the plain twin of
the C++ map that ``mapping/native.py`` binds), written out as PCD.

The cloud follows the JAX function as XLA compiles it, to the bit: the
intrinsics divide as float32 tensors (true divisions), and the voxel key
multiplies by float32(1 / resolution), the constant XLA folds the division
by the static resolution into. One ulp in the key moves a point into
another voxel.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from semantic_slam_mapping_torch.config import MapperConfig
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.mapping import semantics
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.ops.components import connected_components
from semantic_slam_mapping_torch.utils.device import to_device

_NO_KEY = 2147483647   # sort key of a dropped pixel (int32 max)


class FrameCloud(NamedTuple):
    """Fixed-budget voxelized cloud of one keyframe (world frame)."""

    xyz: torch.Tensor     # (P, 3) float32
    rgb: torch.Tensor     # (P, 3) float32 in [0, 1]
    label: torch.Tensor   # (P,) int32
    valid: torch.Tensor   # (P,) bool, a prefix


def semantic_motion_mask(labels: torch.Tensor,
                         cfg: MapperConfig) -> torch.Tensor:
    """Pedestrian and bicyclist pixels, dilated 3x3 ``dilate_iters``
    times."""
    m = torch.zeros_like(labels, dtype=torch.bool)
    for c in semantics.MOTION_CLASSES:
        m = m | (labels == c)
    return im.dilate(m, 3, cfg.dilate_iters)


def motion_overlay_fuse(sem_moving: torch.Tensor, uv_moving: torch.Tensor,
                        cfg: MapperConfig) -> torch.Tensor:
    """A semantic-motion component larger than ``motion_area_threshold``
    survives only where the U-V motion mask covers more than
    ``motion_overlay_portion_threshold`` of it; when no component passes,
    the semantic mask is kept as it is. The neighbour masks are rolls, so
    they wrap at the image edges as the JAX package's do; area and overlay
    are scatter-adds of ones (exact counts)."""
    H, W = sem_moving.shape

    def conn(dim, shift):
        return torch.roll(sem_moving, shift, dim)

    lbl = connected_components(
        sem_moving, (conn(0, 1), conn(0, -1), conn(1, 1), conn(1, -1)),
        sweeps=6)
    flat = lbl.reshape(-1)
    zeros = torch.zeros(H * W, dtype=torch.float32, device=flat.device)
    area = zeros.index_add(0, flat, sem_moving.reshape(-1).float())
    overlay = zeros.index_add(
        0, flat, (sem_moving & uv_moving).reshape(-1).float())
    portion = overlay / torch.clamp(area, min=1.0)
    passed = ((area > cfg.motion_area_threshold)
              & (portion > cfg.motion_overlay_portion_threshold))
    fused = sem_moving & passed[lbl]
    return torch.where(fused.any(), fused, sem_moving)


def generate_point_cloud(depth: torch.Tensor, color: torch.Tensor,
                         labels: torch.Tensor, moving_mask: torch.Tensor,
                         pose: torch.Tensor, K: Intrinsics,
                         cfg: MapperConfig = MapperConfig(),
                         budget: int = 1 << 17) -> FrameCloud:
    """One keyframe -> filtered, voxelized world-frame cloud.

    A pixel is kept where its depth is in (1e-3, max_distance), it is
    outside the moving mask fused with the semantic motion mask, and its
    class is not excluded (sky, pole, bicyclist). Each voxel keeps the
    first of its pixels in the stable order of the voxel keys; voxels past
    ``budget`` go to the dropped row ``budget``."""
    H, W = depth.shape
    dev = depth.device
    fused_moving = moving_mask | motion_overlay_fuse(
        semantic_motion_mask(labels, cfg), moving_mask, cfg)

    keep = (depth > 1e-3) & (depth < cfg.max_distance) & ~fused_moving
    for c in semantics.MAP_EXCLUDED_CLASSES:
        keep = keep & (labels != c)

    # back-projection with float32 intrinsics as device tensors: a Python
    # float divisor would become a reciprocal multiply on the card
    fx, fy, cx, cy = to_device([K.fx, K.fy, K.cx, K.cy], dev, torch.float32)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    pts_c = torch.stack([x, y, depth], dim=-1).reshape(-1, 3)
    pose = pose.to(dev, torch.float32)
    R, t = pose[:3, :3], pose[:3, 3]
    # the rotation as three products summed in order: exact for the
    # identity, and no TF32 matmul whatever the caller's settings
    pts_w = (pts_c[:, 0:1] * R[:, 0] + pts_c[:, 1:2] * R[:, 1]
             + pts_c[:, 2:3] * R[:, 2]) + t

    flat_keep = keep.reshape(-1)
    flat_rgb = color.reshape(-1, 3)
    flat_lbl = labels.reshape(-1)

    # voxelization: quantize, sort by voxel key, keep the first of each run
    span = int(2.0 * cfg.max_distance / cfg.resolution) + 2
    inv_res = float(np.float32(1.0) / np.float32(cfg.resolution))
    origin = t - cfg.max_distance
    q = torch.floor((pts_w - origin) * inv_res).to(torch.int64)
    q = torch.clamp(q, 0, span - 1)
    key = (q[:, 0] * span + q[:, 1]) * span + q[:, 2]
    key = torch.where(flat_keep, key, torch.full_like(key, _NO_KEY))

    key_s, order = torch.sort(key, stable=True)
    first = torch.ones_like(flat_keep)
    first[1:] = key_s[1:] != key_s[:-1]
    uniq = first & (key_s != _NO_KEY)

    # compact the unique voxels to the fixed budget
    rank = torch.cumsum(uniq, 0) - 1
    slot = torch.where(uniq & (rank < budget), rank,
                       torch.full_like(rank, budget))
    xyz_out = torch.zeros((budget + 1, 3), dtype=torch.float32, device=dev)
    rgb_out = torch.zeros((budget + 1, 3), dtype=torch.float32, device=dev)
    lbl_out = torch.zeros(budget + 1, dtype=torch.int32, device=dev)
    xyz_out[slot] = pts_w[order]
    rgb_out[slot] = flat_rgb[order].float()
    lbl_out[slot] = flat_lbl[order].to(torch.int32)
    n = torch.clamp(uniq.sum(), max=budget)
    valid = torch.arange(budget, device=dev) < n
    return FrameCloud(xyz=xyz_out[:budget], rgb=rgb_out[:budget],
                      label=lbl_out[:budget], valid=valid)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class GlobalMap:
    """Host-side voxel map: per voxel, running sums of position and color
    and per-class label counts, so the fused map does not depend on the
    insertion order. A copy of the JAX package's numpy class, and the plain
    twin of ``mapping/native.NativeVoxelMap`` (which sums in float32)."""

    N_CLASSES = semantics.NUM_CLASSES

    def __init__(self, cfg: MapperConfig):
        self.cfg = cfg
        # voxel key -> row of the accumulator arrays
        self.voxels: Dict[Tuple[int, int, int], int] = {}
        self._xyz_sum = np.zeros((0, 3), np.float64)
        self._rgb_sum = np.zeros((0, 3), np.float64)
        self._count = np.zeros(0, np.int64)
        self._cls = np.zeros((0, self.N_CLASSES), np.int32)
        self.updates = 0

    def insert(self, xyz: np.ndarray, rgb: np.ndarray,
               label: Optional[np.ndarray] = None,
               valid: Optional[np.ndarray] = None):
        """Accumulate points (the arguments of NativeVoxelMap.insert)."""
        xyz = np.asarray(xyz)
        rgb = np.asarray(rgb)
        if valid is not None:
            keep = np.asarray(valid).astype(bool)
            xyz, rgb = xyz[keep], rgb[keep]
            label = label[keep] if label is not None else None
        if label is None:
            label = np.zeros(len(xyz), np.int32)
        label = np.clip(np.asarray(label, np.int64), 0, self.N_CLASSES - 1)
        q = np.floor(xyz / self.cfg.resolution).astype(np.int64)
        keys, inv = np.unique(q, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        rows = np.empty(len(keys), np.int64)
        for i, k in enumerate(map(tuple, keys.tolist())):
            r = self.voxels.get(k)
            if r is None:
                r = len(self.voxels)
                self.voxels[k] = r
            rows[i] = r
        if len(self.voxels) > len(self._count):
            grow = len(self.voxels) - len(self._count)
            self._xyz_sum = np.concatenate(
                [self._xyz_sum, np.zeros((grow, 3))])
            self._rgb_sum = np.concatenate(
                [self._rgb_sum, np.zeros((grow, 3))])
            self._count = np.concatenate([self._count,
                                          np.zeros(grow, np.int64)])
            self._cls = np.concatenate(
                [self._cls, np.zeros((grow, self.N_CLASSES), np.int32)])
        r_of_pt = rows[inv]
        np.add.at(self._xyz_sum, r_of_pt, xyz.astype(np.float64))
        np.add.at(self._rgb_sum, r_of_pt, rgb.astype(np.float64))
        np.add.at(self._count, r_of_pt, 1)
        np.add.at(self._cls, (r_of_pt, label), 1)
        self.updates += 1

    def insert_cloud(self, cloud: FrameCloud):
        self.insert(_np(cloud.xyz), _np(cloud.rgb), _np(cloud.label),
                    _np(cloud.valid))

    def clear(self):
        self.voxels.clear()
        self._xyz_sum = np.zeros((0, 3), np.float64)
        self._rgb_sum = np.zeros((0, 3), np.float64)
        self._count = np.zeros(0, np.int64)
        self._cls = np.zeros((0, self.N_CLASSES), np.int32)

    def rebuild(self, clouds):
        """Full rebuild from a list of FrameClouds."""
        self.clear()
        for c in clouds:
            self.insert_cloud(c)

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(xyz mean, rgb mean, majority label) per voxel."""
        n = len(self.voxels)
        if not n:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.float32), np.zeros(0, np.int32))
        cnt = np.maximum(self._count[:n], 1)[:, None]
        xyz = (self._xyz_sum[:n] / cnt).astype(np.float32)
        rgb = (self._rgb_sum[:n] / cnt).astype(np.float32)
        lbl = np.argmax(self._cls[:n], axis=1).astype(np.int32)
        return xyz, rgb, lbl

    def __len__(self) -> int:
        return len(self.voxels)

    def save_pcd(self, path: str, binary: bool = True):
        xyz, rgb, _ = self.as_arrays()
        write_pcd(path, xyz, rgb, binary=binary)


def write_pcd(path: str, xyz: np.ndarray, rgb: np.ndarray,
              binary: bool = True):
    """PCD v0.7 file of x, y, z and a packed float rgb (PCL's XYZRGBA
    layout)."""
    n = len(xyz)
    r = (np.clip(rgb[:, 0], 0, 1) * 255).astype(np.uint32)
    g = (np.clip(rgb[:, 1], 0, 1) * 255).astype(np.uint32)
    b = (np.clip(rgb[:, 2], 0, 1) * 255).astype(np.uint32)
    rgb_f = ((r << 16) | (g << 8) | b).view(np.float32)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n"
        f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {'binary' if binary else 'ascii'}\n")
    data = np.empty((n, 4), np.float32)
    data[:, :3] = xyz
    data[:, 3] = rgb_f
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(data.tobytes())
        else:
            for row in data:
                f.write((" ".join(f"{x:.6f}" for x in row) + "\n").encode())
