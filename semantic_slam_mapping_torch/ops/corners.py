"""Shi-Tomasi (GFTT) corners with local and grid NMS and a fixed-budget
top-K selection.

Counterpart of the GFTT path of ``semantic_slam_mapping_tpu/ops/corners.py``.
Ties are broken by flat index, lowest first, as ``lax.top_k`` and
``argmax`` do in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from semantic_slam_mapping_torch.ops import image as im


class Keypoints(NamedTuple):
    """(K, 2) [x, y] coords, (K,) scores, (K,) validity; invalid slots hold
    (0, 0)."""

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


def local_max_mask(response: torch.Tensor, size: int = 3) -> torch.Tensor:
    """True where the response is positive and the maximum of its
    size x size window."""
    pooled = F.max_pool2d(response[None, None], size, stride=1,
                          padding=size // 2)[0, 0]
    return (response >= pooled) & (response > 0)


def select_keypoints(response: torch.Tensor, max_corners: int,
                     quality_level: float = 0.01, cell_size: int = 16,
                     border: int = 16) -> Keypoints:
    """Response map -> fixed-budget keypoints: 3x3 NMS, border cut, one
    winner per grid cell, quality gate against the global maximum, then the
    top ``max_corners`` by score."""
    H, W = response.shape
    dev = response.device
    r = torch.where(local_max_mask(response), response, 0.0)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inside = ((ys >= border) & (ys < H - border)
              & (xs >= border) & (xs < W - border))
    r = torch.where(inside, r, 0.0)

    ch, cw = -(-H // cell_size), -(-W // cell_size)
    padded = F.pad(r, (0, cw * cell_size - W, 0, ch * cell_size - H))
    cells = padded.reshape(ch, cell_size, cw, cell_size).permute(0, 2, 1, 3)
    flat_cells = cells.reshape(ch, cw, cell_size * cell_size)
    # one-hot of the first maximum (F.one_hot would read its input back
    # to the host to validate it)
    lanes = torch.arange(cell_size * cell_size, device=dev)
    winner = (lanes == torch.argmax(flat_cells, dim=-1)[..., None]).to(
        r.dtype)
    kept = (flat_cells * winner).reshape(ch, cw, cell_size, cell_size)
    r = kept.permute(0, 2, 1, 3).reshape(
        ch * cell_size, cw * cell_size)[:H, :W]

    r = torch.where(r >= quality_level * torch.max(r), r, 0.0)

    # stable descending sort: equal scores keep index order (lax.top_k)
    score, idx = torch.sort(r.reshape(-1), descending=True, stable=True)
    score, idx = score[:max_corners], idx[:max_corners]
    valid = score > 0
    xy = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    xy = torch.where(valid[:, None], xy, 0.0)
    return Keypoints(xy=xy, score=torch.where(valid, score, 0.0),
                     valid=valid)


def gftt(img: torch.Tensor, max_corners: int = 500,
         quality_level: float = 0.04, min_distance: int = 8,
         block_size: int = 3) -> Keypoints:
    """Good-features-to-track (quality 0.04, minimum distance 8)."""
    resp = shi_tomasi_response(img, block_size)
    return select_keypoints(resp, max_corners, quality_level,
                            cell_size=max(min_distance, 4), border=8)
