"""Batched pyramidal Lucas-Kanade optical flow.

Counterpart of ``semantic_slam_mapping_tpu/ops/klt.py``: every feature runs
``max_iterations`` fixed iterations with a convergence mask, over a 2x
pyramid, with OpenCV's min-eigenvalue gate in its 8-bit units. Patches are
read with direct bilinear taps (zero outside the image) at the integer
window corners and fractional offsets the JAX package uses; its 64-lane
block gather and interpolation matmuls are TPU layout and are not copied.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from semantic_slam_mapping_torch.config import KltConfig
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.utils.timing import span


class TrackResult(NamedTuple):
    xy: torch.Tensor      # (..., N, 2) tracked positions in the target
    status: torch.Tensor  # (..., N) bool
    error: torch.Tensor   # (..., N) mean |residual| over the window


_MARGIN = 10  # flow range each level's target window allows (px)


def _sample_patch(img: torch.Tensor, corner: torch.Tensor,
                  offset: torch.Tensor, win: int) -> torch.Tensor:
    """(..., N, win, win) bilinear patches of (..., H, W) images:
    patch[k, l] interpolates the image at corner + offset + (l, k) (x, y),
    zero outside the image. corner: (..., N, 2) integer window corners;
    offset: (..., N, 2) float."""
    H, W = img.shape[-2:]
    i0 = torch.floor(offset)
    a = offset - i0
    ks = torch.arange(win, device=img.device)
    base = corner + i0.long()                           # (..., N, 2)
    xs = base[..., 0, None] + ks                        # (..., N, win)
    ys = base[..., 1, None] + ks

    def tap(yy, xx):
        ok = (((yy >= 0) & (yy < H))[..., :, None]
              & ((xx >= 0) & (xx < W))[..., None, :])
        v = im.take(img, yy[..., :, None], xx[..., None, :])
        return torch.where(ok, v, 0.0)

    ax = a[..., 0, None, None]
    ay = a[..., 1, None, None]
    return ((1 - ay) * ((1 - ax) * tap(ys, xs) + ax * tap(ys, xs + 1))
            + ay * ((1 - ax) * tap(ys + 1, xs) + ax * tap(ys + 1, xs + 1)))


def _track_level(template: torch.Tensor, target: torch.Tensor,
                 pt0: torch.Tensor, guess: torch.Tensor,
                 cfg: KltConfig) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """One pyramid level of LK for N features of each frame. pt0:
    (..., N, 2) positions in the template; guess: (..., N, 2) initial
    displacement. Returns (flow (..., N, 2), ok (..., N), mean |residual|
    (..., N))."""
    win = cfg.window_size
    r = win // 2
    n = win * win
    tx, ty = im.gradients(template)
    # template patch top-left pt0 - r sits at fractional offset
    # frac(pt0) + 1 inside the window at floor(pt0) - r - 1
    fl = torch.floor(pt0)
    t_corner = fl.long() - r - 1
    t_o = pt0 - fl + 1.0
    t_patch = _sample_patch(template, t_corner, t_o, win)
    gx = _sample_patch(tx, t_corner, t_o, win)
    gy = _sample_patch(ty, t_corner, t_o, win)

    gxx = torch.sum(gx * gx, dim=(-2, -1))
    gxy = torch.sum(gx * gy, dim=(-2, -1))
    gyy = torch.sum(gy * gy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det,
                                                 min=0.0))) / n
    # min_eig_threshold is in OpenCV's units (gradients of 8-bit images);
    # these images are in [0, 1]
    ok_g = min_eig > cfg.min_eig_threshold / (255.0 * 255.0)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12,
                                torch.full_like(det, 1e-12), det)

    tgt_corner = torch.floor(pt0 + guess).long() - r - _MARGIN
    tgt_corner_f = tgt_corner.float()
    lo, hi = guess - _MARGIN + 1, guess + _MARGIN - 1
    frozen = ~ok_g[..., None]
    g = guess
    converged = torch.zeros_like(ok_g)
    for _ in range(cfg.max_iterations):
        with span("klt/step"):
            o = pt0 + g - tgt_corner_f - r
            rr = _sample_patch(target, tgt_corner, o, win) - t_patch
            bx = torch.sum(rr * gx, dim=(-2, -1))
            by = torch.sum(rr * gy, dim=(-2, -1))
            step = torch.stack([-(gyy * bx - gxy * by) * inv_det,
                                -(-gxy * bx + gxx * by) * inv_det], dim=-1)
            new_g = torch.minimum(torch.maximum(g + step, lo), hi)
            g = torch.where(converged[..., None] | frozen, g, new_g)
            converged = converged | (torch.sum(step * step, dim=-1)
                                     < cfg.epsilon ** 2)

    with span("klt/residual"):
        o = pt0 + g - tgt_corner_f - r
        final = _sample_patch(target, tgt_corner, o, win)
        err = torch.mean(torch.abs(final - t_patch), dim=(-2, -1))
    return g, ok_g, err


def track_pyramid(template_pyr: Sequence[torch.Tensor],
                  target_pyr: Sequence[torch.Tensor], pts: torch.Tensor,
                  cfg: KltConfig = KltConfig(),
                  init: torch.Tensor | None = None) -> TrackResult:
    """Track (..., N, 2) points from template to target through 2x
    pyramids of (..., H, W) levels (finest first), each frame in its own
    images. ``init``: optional (..., N, 2) initial displacement."""
    n_levels = len(template_pyr)
    H, W = template_pyr[0].shape[-2:]
    flow = init if init is not None else torch.zeros_like(pts)
    flow = flow / (2.0 ** (n_levels - 1))
    ok = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    err = torch.zeros(pts.shape[:-1], device=pts.device)
    for lvl in range(n_levels - 1, -1, -1):
        with span("klt/level"):
            f, ok_l, err = _track_level(template_pyr[lvl], target_pyr[lvl],
                                        pts / (2.0 ** lvl), flow, cfg)
        ok = ok & ok_l
        flow = f * 2.0 if lvl > 0 else f
    out = pts + flow
    inb = ((out[..., 0] >= 1) & (out[..., 0] <= W - 2)
           & (out[..., 1] >= 1) & (out[..., 1] <= H - 2))
    return TrackResult(xy=out, status=ok & inb, error=err)


def track(template: torch.Tensor, target: torch.Tensor, pts: torch.Tensor,
          cfg: KltConfig = KltConfig(),
          init: torch.Tensor | None = None) -> TrackResult:
    """Builds the 2x pyramids, then tracks."""
    tp = im.build_pyramid(template, cfg.pyramid_levels, 2.0)
    gp = im.build_pyramid(target, cfg.pyramid_levels, 2.0)
    return track_pyramid(tp, gp, pts, cfg, init)
