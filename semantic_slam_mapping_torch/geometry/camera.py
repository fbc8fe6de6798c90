"""Pinhole and stereo camera model on batched torch tensors.

Counterpart of ``semantic_slam_mapping_tpu/geometry/camera.py``. Points are
(…, N, k) tensors. The intrinsics are plain Python floats: they enter every
kernel as scalars and need no device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from semantic_slam_mapping_torch.config import CameraConfig


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    scale: float

    @classmethod
    def from_config(cls, cam: CameraConfig) -> "Intrinsics":
        return cls(float(cam.fx), float(cam.fy), float(cam.cx),
                   float(cam.cy), float(cam.baseline), float(cam.scale))

    @property
    def bf(self) -> float:
        return self.fx * self.baseline


def _inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(K: Intrinsics, pts: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points (…, 3) -> pixel coords (…, 2) [u, v]."""
    inv_z = _inv_z(pts[..., 2])
    u = K.fx * pts[..., 0] * inv_z + K.cx
    v = K.fy * pts[..., 1] * inv_z + K.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(K: Intrinsics, pts: torch.Tensor) -> torch.Tensor:
    """3D points (…, 3) -> (…, 4) stereo observation [u_l, v_l, u_r, v_r]."""
    inv_z = _inv_z(pts[..., 2])
    u_l = K.fx * pts[..., 0] * inv_z + K.cx
    v = K.fy * pts[..., 1] * inv_z + K.cy
    u_r = K.fx * (pts[..., 0] - K.baseline) * inv_z + K.cx
    return torch.stack([u_l, v, u_r, v], dim=-1)


def backproject(K: Intrinsics, uv: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """Pixels (…, 2) + metric depth (…,) -> camera-frame 3D (…, 3)."""
    x = (uv[..., 0] - K.cx) * depth / K.fx
    y = (uv[..., 1] - K.cy) * depth / K.fy
    return torch.stack([x, y, depth], dim=-1)


def disparity_to_depth(K: Intrinsics, disparity: torch.Tensor,
                       min_disparity: float = 0.5) -> torch.Tensor:
    """Stereo disparity (px) -> metric depth bf / d; 0 where d <= min.
    ``bf`` is fx * baseline rounded to float32 and the quotient a true
    float32 division, as the JAX package computes it with float32
    intrinsics (torch would turn a Python-float numerator into a
    reciprocal times a scalar)."""
    valid = disparity > min_disparity
    bf = torch.full((), float(np.float32(K.fx) * np.float32(K.baseline)),
                    dtype=torch.float32, device=disparity.device)
    depth = torch.div(bf, torch.where(valid, disparity,
                                      torch.ones_like(disparity)))
    return torch.where(valid, depth, torch.zeros_like(depth))


def triangulate_stereo(K: Intrinsics, uv_left: torch.Tensor,
                       disparity: torch.Tensor) -> torch.Tensor:
    """Left pixel (…, 2) + disparity (…,) -> camera-frame 3D (…, 3)."""
    z = K.bf / torch.clamp(disparity, min=1e-6)
    x = (uv_left[..., 0] - K.cx) * z / K.fx
    y = (uv_left[..., 1] - K.cy) * z / K.fy
    return torch.stack([x, y, z], dim=-1)


def pixel_grid(height: int, width: int, dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """(H, W, 2) [u, v] pixel-coordinate image."""
    v = torch.arange(height, dtype=dtype, device=device)[:, None]
    u = torch.arange(width, dtype=dtype, device=device)[None, :]
    return torch.stack([u.expand(height, width), v.expand(height, width)],
                       dim=-1)
