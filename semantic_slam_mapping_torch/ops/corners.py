"""Corner responses (Shi-Tomasi, Harris, FAST-9) with local and grid NMS
and a fixed-budget top-K selection.

Counterpart of ``semantic_slam_mapping_tpu/ops/corners.py``.
Ties are broken by flat index, lowest first, as ``lax.top_k`` and
``argmax`` do in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from semantic_slam_mapping_torch.ops import image as im


class Keypoints(NamedTuple):
    """(..., K, 2) [x, y] coords, (..., K) scores, (..., K) validity;
    invalid slots hold (0, 0)."""

    xy: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor


def shi_tomasi_response(img: torch.Tensor,
                        block_size: int = 3) -> torch.Tensor:
    """Min-eigenvalue corner response."""
    ix, iy = im.gradients(img)
    ixx = im.box_blur(ix * ix, block_size)
    iyy = im.box_blur(iy * iy, block_size)
    ixy = im.box_blur(ix * iy, block_size)
    det_term = torch.sqrt(torch.square(ixx - iyy) + 4.0 * torch.square(ixy))
    return 0.5 * ((ixx + iyy) - det_term)


def harris_response(img: torch.Tensor, block_size: int = 3,
                    k: float = 0.04) -> torch.Tensor:
    ix, iy = im.gradients(img)
    ixx = im.box_blur(ix * ix, block_size)
    iyy = im.box_blur(iy * iy, block_size)
    ixy = im.box_blur(ix * iy, block_size)
    tr = ixx + iyy
    return (ixx * iyy - ixy * ixy) - k * tr * tr


# FAST-16 circle offsets (dx, dy), radius 3, clockwise from 12 o'clock
_FAST_OFFSETS = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift so out[y, x] = img[y + dy, x + dx] (zero padded)."""
    H, W = img.shape[-2:]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    padded = F.pad(img, (px1, px0, py1, py0))
    return padded[..., py1 + dy:py1 + dy + H, px1 + dx:px1 + dx + W]


def fast_response(img: torch.Tensor, threshold: float,
                  arc_length: int = 9) -> torch.Tensor:
    """FAST-N corner response map (0 where not a corner): a pixel is a
    corner iff ``arc_length`` contiguous circle pixels are all brighter
    than c + t or all darker than c - t, found by log-doubling ANDs over
    the circle; the score is the summed excess over the threshold."""
    neigh = torch.stack([_shift(img, int(dy), int(dx))
                         for dx, dy in _FAST_OFFSETS])       # (16, H, W)
    d = neigh - img[None]
    bright = d > threshold
    dark = d < -threshold

    def has_arc(m: torch.Tensor) -> torch.Tensor:
        acc, run = m, 1
        while run * 2 <= arc_length:
            acc = acc & torch.roll(acc, -run, dims=0)
            run *= 2
        rem = arc_length - run
        if rem > 0:
            # overlapping windows: AND is idempotent
            acc = acc & torch.roll(acc, -rem, dims=0)
        return torch.any(acc, dim=0)

    is_corner = has_arc(bright) | has_arc(dark)
    score = torch.sum(torch.clamp(torch.abs(d) - threshold, min=0.0), dim=0)
    H, W = img.shape[-2:]
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    interior = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return torch.where(is_corner & interior, score, 0.0)


def local_max_mask(response: torch.Tensor, size: int = 3) -> torch.Tensor:
    """True where the response (..., H, W) is positive and the maximum of
    its size x size window."""
    H, W = response.shape[-2:]
    pooled = F.max_pool2d(response.reshape(-1, 1, H, W), size, stride=1,
                          padding=size // 2).reshape(response.shape)
    return (response >= pooled) & (response > 0)


def select_keypoints(response: torch.Tensor, max_corners: int,
                     quality_level: float = 0.01, cell_size: int = 16,
                     border: int = 16) -> Keypoints:
    """Response map (..., H, W) -> fixed-budget keypoints per frame: 3x3
    NMS, border cut, one winner per grid cell, quality gate against the
    frame's maximum, then the frame's top ``max_corners`` by score."""
    H, W = response.shape[-2:]
    batch = response.shape[:-2]
    dev = response.device
    r = torch.where(local_max_mask(response), response, 0.0)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inside = ((ys >= border) & (ys < H - border)
              & (xs >= border) & (xs < W - border))
    r = torch.where(inside, r, 0.0)

    ch, cw = -(-H // cell_size), -(-W // cell_size)
    padded = F.pad(r, (0, cw * cell_size - W, 0, ch * cell_size - H))
    cells = padded.reshape(batch + (ch, cell_size, cw, cell_size)
                           ).transpose(-3, -2)
    flat_cells = cells.reshape(batch + (ch, cw, cell_size * cell_size))
    # one-hot of the first maximum (F.one_hot would read its input back
    # to the host to validate it)
    lanes = torch.arange(cell_size * cell_size, device=dev)
    winner = (lanes == torch.argmax(flat_cells, dim=-1)[..., None]).to(
        r.dtype)
    kept = (flat_cells * winner).reshape(
        batch + (ch, cw, cell_size, cell_size))
    r = kept.transpose(-3, -2).reshape(
        batch + (ch * cell_size, cw * cell_size))[..., :H, :W]

    r = torch.where(r >= quality_level * r.amax(dim=(-2, -1), keepdim=True),
                    r, 0.0)

    # stable descending sort of each frame: equal scores keep index order
    # (lax.top_k)
    score, idx = torch.sort(r.reshape(batch + (H * W,)), descending=True,
                            stable=True)
    score, idx = score[..., :max_corners], idx[..., :max_corners]
    valid = score > 0
    xy = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    xy = torch.where(valid[..., None], xy, 0.0)
    return Keypoints(xy=xy, score=torch.where(valid, score, 0.0),
                     valid=valid)


def gftt(img: torch.Tensor, max_corners: int = 500,
         quality_level: float = 0.04, min_distance: int = 8,
         block_size: int = 3) -> Keypoints:
    """Good-features-to-track (quality 0.04, minimum distance 8)."""
    resp = shi_tomasi_response(img, block_size)
    return select_keypoints(resp, max_corners, quality_level,
                            cell_size=max(min_distance, 4), border=8)
