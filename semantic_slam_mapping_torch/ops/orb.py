"""ORB features: multi-scale FAST, intensity-centroid orientation and
steered rBRIEF descriptors.

Counterpart of ``semantic_slam_mapping_tpu/ops/orb.py``. Each pyramid level
is a dense FAST response map, grid NMS and a top-K by score (ties by flat
index, as ``lax.top_k``), then one batched gather of the oriented BRIEF
sample pairs for all keypoints. The pair table is the JAX package's, drawn
from numpy's ``default_rng(7)``, so it is bit-identical. Descriptors stay
unpacked, (N, 256) uint8 in {0, 1}, so Hamming distances are a matmul
(``ops/matching.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from semantic_slam_mapping_torch.config import OrbConfig
from semantic_slam_mapping_torch.ops import corners
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.utils.device import to_device
from semantic_slam_mapping_torch.utils.timing import span

DESC_BITS = 256


class OrbFeatures(NamedTuple):
    """Fixed-budget ORB feature set (N = ``n_features``): xy in level-0
    pixels, desc (N, 256) uint8 of {0, 1}; invalid slots are zeroed."""

    xy: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor      # radians
    level: torch.Tensor      # int32 pyramid level
    desc: torch.Tensor
    valid: torch.Tensor


def _brief_pattern(patch_size: int = 31, n_bits: int = DESC_BITS,
                   seed: int = 7) -> np.ndarray:
    """(n_bits, 2, 2) sampling pair offsets: iid Gaussian with sigma =
    patch/5, clipped to the patch. Deterministic."""
    rng = np.random.default_rng(seed)
    sigma = patch_size / 5.0
    lim = patch_size // 2 - 1
    pts = np.clip(rng.normal(0.0, sigma, (n_bits, 2, 2)), -lim, lim)
    return pts.astype(np.float32)


_PATTERN = _brief_pattern()


def _disc_offsets(radius: int) -> np.ndarray:
    """Integer (x, y) offsets of a filled disc."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    inside = (xs ** 2 + ys ** 2) <= radius ** 2
    return np.stack([xs[inside], ys[inside]], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(table: str, radius: int, device: torch.device) -> torch.Tensor:
    """The disc offsets of ``radius`` or the pair table, on ``device``."""
    return to_device(_disc_offsets(radius) if table == "disc" else _PATTERN,
                     device)


def orientation(img: torch.Tensor, xy: torch.Tensor,
                radius: int = 15) -> torch.Tensor:
    """Intensity-centroid orientation (rad) of keypoints xy (N, 2):
    atan2(m01, m10) over a disc patch."""
    offs = _on_device("disc", radius, img.device)                  # (P, 2)
    patch = im.bilinear_sample(img, xy[:, None, :] + offs)         # (N, P)
    m10 = torch.sum(offs[:, 0] * patch, dim=-1)
    m01 = torch.sum(offs[:, 1] * patch, dim=-1)
    return torch.atan2(m01, m10)


def descriptors(img: torch.Tensor, xy: torch.Tensor,
                angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF: the pair pattern rotated by each keypoint's angle,
    both points bilinear-sampled, bit = I(a) < I(b). (N, 256) uint8. The
    image should be pre-smoothed (sigma 2)."""
    pat = _on_device("pattern", 0, img.device)                     # (B, 2, 2)
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    px, py = pat[None, :, :, 0], pat[None, :, :, 1]
    rp = torch.stack([c * px - s * py, s * px + c * py], dim=-1)   # (N,B,2,2)
    a = im.bilinear_sample(img, xy[:, None, :] + rp[:, :, 0, :])
    b = im.bilinear_sample(img, xy[:, None, :] + rp[:, :, 1, :])
    return (a < b).to(torch.uint8)


def _level_budgets(n_features: int, n_levels: int,
                   scale: float) -> list[int]:
    """The feature budget split over levels in proportion to level area
    (a geometric series of ratio 1/scale^2); the remainder goes to level 0."""
    inv = 1.0 / (scale * scale)
    weights = np.array([inv ** i for i in range(n_levels)])
    raw = n_features * weights / weights.sum()
    out = np.floor(raw).astype(int)
    out[0] += n_features - out.sum()
    return out.tolist()


def _level_features(img_l: torch.Tensor, lvl: int, budget: int,
                    cfg: OrbConfig) -> OrbFeatures:
    """The ORB features of one pyramid level, in level-0 pixels."""
    scale = cfg.scale_factor ** lvl
    resp = corners.fast_response(img_l, cfg.ini_th_fast / 255.0)
    # the low threshold where the high one finds nothing
    resp_lo = corners.fast_response(img_l, cfg.min_th_fast / 255.0)
    resp = torch.where(torch.max(resp) > 0, resp, resp_lo)
    kp = corners.select_keypoints(
        resp, budget, quality_level=0.0, cell_size=16,
        border=min(cfg.edge_threshold, min(img_l.shape) // 4))
    blurred = im.gaussian_blur(img_l, 2.0)
    ang = orientation(img_l, kp.xy, cfg.half_patch_size)
    desc = descriptors(blurred, kp.xy, ang)
    return OrbFeatures(
        xy=kp.xy * scale, response=kp.score, angle=ang,
        level=torch.full(kp.xy.shape[:1], lvl, dtype=torch.int32,
                         device=img_l.device),
        desc=torch.where(kp.valid[:, None], desc, 0).to(torch.uint8),
        valid=kp.valid)


def extract(img: torch.Tensor, cfg: OrbConfig = OrbConfig()) -> OrbFeatures:
    """ORB extraction on one (H, W) image -> fixed N-slot feature set."""
    with span("orb/extract"):
        pyr = im.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
        budgets = _level_budgets(cfg.n_features, cfg.n_levels,
                                 cfg.scale_factor)

        parts = []
        for lvl, (img_l, budget) in enumerate(zip(pyr, budgets)):
            if budget == 0:
                continue
            with span("orb/level"):
                parts.append(_level_features(img_l, lvl, budget, cfg))

        merged = OrbFeatures(*[torch.cat([p[i] for p in parts])
                               for i in range(6)])
        pad = cfg.n_features - merged.xy.shape[0]
        if pad > 0:
            merged = OrbFeatures(*[
                torch.cat([x, torch.zeros((pad,) + x.shape[1:],
                                          dtype=x.dtype, device=x.device)])
                for x in merged])
        return merged
