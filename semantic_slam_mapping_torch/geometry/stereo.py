"""Dense stereo triangulation and pitch rectification.

Counterpart of ``semantic_slam_mapping_tpu/geometry/stereo.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from semantic_slam_mapping_torch.config import CameraConfig
from semantic_slam_mapping_torch.geometry.camera import Intrinsics, pixel_grid


class PointImage(NamedTuple):
    xyz: torch.Tensor        # (H, W, 3) camera-frame points
    disparity: torch.Tensor  # (H, W)
    valid: torch.Tensor      # (H, W) disparity valid
    roi: torch.Tensor        # (H, W) inside the 3D region of interest


def _roi(valid, x, y, z, cam: CameraConfig) -> torch.Tensor:
    return (valid & (torch.abs(x) < cam.roix) & (torch.abs(y) < cam.roiy)
            & (z > 0) & (z < cam.roiz))


def triangulate_image(K: Intrinsics, disparity: torch.Tensor,
                      cam: CameraConfig,
                      min_disparity: float = 0.5) -> PointImage:
    """Dense disparity -> camera-frame points with ROI classification."""
    H, W = disparity.shape
    valid = disparity > min_disparity
    z = K.bf / torch.where(valid, disparity, torch.ones_like(disparity))
    uv = pixel_grid(H, W, dtype=disparity.dtype, device=disparity.device)
    x = (uv[..., 0] - K.cx) * z / K.fx
    y = (uv[..., 1] - K.cy) * z / K.fy
    xyz = torch.where(valid[..., None], torch.stack([x, y, z], dim=-1), 0.0)
    return PointImage(xyz=xyz, disparity=disparity, valid=valid,
                      roi=_roi(valid, x, y, z, cam))


def correct_pitch(points: PointImage, pitch: torch.Tensor,
                  cam: CameraConfig) -> PointImage:
    """Rotate Y/Z about the camera x-axis by the ground pitch, then
    re-classify the ROI."""
    c, s = torch.cos(pitch), torch.sin(pitch)
    x, y, z = points.xyz.unbind(-1)
    y2 = c * y - s * z
    z2 = s * y + c * z
    return PointImage(xyz=torch.stack([x, y2, z2], dim=-1),
                      disparity=points.disparity, valid=points.valid,
                      roi=_roi(points.valid, x, y2, z2, cam))
