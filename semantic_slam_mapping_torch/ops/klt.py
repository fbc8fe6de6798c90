"""Batched pyramidal Lucas-Kanade optical flow: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``semantic_slam_mapping_tpu/ops/klt.py``: every feature runs
``max_iterations`` fixed iterations with a convergence mask, over a 2x
pyramid, with OpenCV's min-eigenvalue gate in its 8-bit units. Patches are
read with direct bilinear taps (zero outside the image) at the integer
window corners and fractional offsets the JAX package uses; its 64-lane
block gather and interpolation matmuls are TPU layout and are not copied.

:func:`track_pyramid` checks its inputs, then for CPU tensors runs
:func:`track_pyramid_plain`, the algorithm as PyTorch ops (about 110
launches an iteration on a card), and for CUDA tensors launches the kernel
of ``csrc/klt_track.cu`` once, every frame, feature, level and iteration
of the call in it, and counts the launch in ``track_pyramid.launches``; it
never falls back to the plain version for a CUDA tensor. The kernel's
source note gives its contract, design and bound. It is compiled on first
use by ``ops/cuda/nvcc.build`` and loaded with ``ctypes``; nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Sequence, Tuple

import torch

from semantic_slam_mapping_torch.config import KltConfig
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.ops.cuda import nvcc
from semantic_slam_mapping_torch.utils.timing import span

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "klt_track.cu"
# what the kernel takes: pyramid levels, and windows of at most 8 pixels a
# lane (16x16)
MAX_LEVELS = 8
MAX_WINDOW = 16


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


def track_pyramid_plain(template_pyr: Sequence[torch.Tensor],
                        target_pyr: Sequence[torch.Tensor],
                        pts: torch.Tensor, cfg: KltConfig = KltConfig(),
                        init: torch.Tensor | None = None) -> TrackResult:
    """The plain PyTorch version of :func:`track_pyramid`, on any device."""
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


def _check(template_pyr: Sequence[torch.Tensor],
           target_pyr: Sequence[torch.Tensor], pts: torch.Tensor,
           init: torch.Tensor | None) -> None:
    """Raises ValueError unless the pyramids are float32 (..., H, W) levels
    of one depth with the points' batch dims, the points are float32
    (..., N, 2), ``init`` is None or like them, and all share a device."""
    if len(template_pyr) != len(target_pyr) or not template_pyr:
        raise ValueError("track_pyramid takes two pyramids of one depth, got "
                         f"{len(template_pyr)} and {len(target_pyr)} levels")
    if pts.dim() < 2 or pts.shape[-1] != 2:
        raise ValueError("track_pyramid takes (..., N, 2) points, got "
                         f"{tuple(pts.shape)}")
    if init is not None and init.shape != pts.shape:
        raise ValueError(f"track_pyramid: init {tuple(init.shape)} is not "
                         f"shaped like the points {tuple(pts.shape)}")
    batch = pts.shape[:-2]
    tensors = [pts, *([] if init is None else [init]), *template_pyr,
               *target_pyr]
    for t in [*template_pyr, *target_pyr]:
        if t.dim() < 2 or t.shape[:-2] != batch:
            raise ValueError(f"track_pyramid: a level {tuple(t.shape)} has "
                             f"not the points' batch dims {tuple(batch)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("track_pyramid takes float32 images and points, "
                         f"got {sorted({str(t.dtype) for t in tensors})}")
    if len({t.device for t in tensors}) > 1:
        raise ValueError("track_pyramid: inputs on mixed devices "
                         f"{sorted({str(t.device) for t in tensors})}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(nvcc.build(SOURCE)))
    fn = lib.klt_track
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def track_pyramid(template_pyr: Sequence[torch.Tensor],
                  target_pyr: Sequence[torch.Tensor], pts: torch.Tensor,
                  cfg: KltConfig = KltConfig(),
                  init: torch.Tensor | None = None) -> TrackResult:
    """Track (..., N, 2) points from template to target through 2x
    pyramids of (..., H, W) levels (finest first), each frame in its own
    images. ``init``: optional (..., N, 2) initial displacement. Levels may
    be strided views; the points and ``init`` must be contiguous on a
    card."""
    _check(template_pyr, target_pyr, pts, init)
    if pts.device.type == "cpu":
        return track_pyramid_plain(template_pyr, target_pyr, pts, cfg, init)
    if pts.device.type != "cuda":
        raise ValueError(f"track_pyramid: unsupported device {pts.device}")
    if not (pts.is_contiguous() and (init is None or init.is_contiguous())):
        raise ValueError("track_pyramid takes contiguous points and init "
                         "on a card")
    n_levels, win = len(template_pyr), cfg.window_size
    if n_levels > MAX_LEVELS or not 1 <= win <= MAX_WINDOW:
        raise ValueError(f"track_pyramid's kernel takes 1..{MAX_LEVELS} "
                         f"levels and windows of 1..{MAX_WINDOW}, got "
                         f"{n_levels} and {win}")
    N = pts.shape[-2]
    xy = torch.empty_like(pts)
    status = torch.empty(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    error = torch.empty(pts.shape[:-1], device=pts.device)
    if xy.numel() == 0:
        return TrackResult(xy=xy, status=status, error=error)
    with span("klt/leg"):
        images = []
        for tmpl, tgt in zip(template_pyr, target_pyr):
            images += [tmpl, tgt, *im.gradients(tmpl)]
        # (frames, H, W) views: a copy only where the batch dims cannot be
        # viewed as one
        images = [t.reshape((-1,) + tuple(t.shape[-2:])) for t in images]
        if any((t.shape[1] - 1) * t.stride(1) + (t.shape[2] - 1) * t.stride(2)
               >= 2 ** 31 for t in images):
            raise ValueError("track_pyramid: a level's frame spans 2^31 "
                             "elements or more")
        n = len(images)
        ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in images))
        batch_strides = (ctypes.c_longlong * n)(*(t.stride(0)
                                                  for t in images))
        dims = (ctypes.c_int * (4 * n))(*(d for t in images for d in (
            t.shape[1], t.shape[2], t.stride(1), t.stride(2))))
        with torch.cuda.device(pts.device):
            err = _library().klt_track(
                ptrs, batch_strides, dims, n_levels, xy.numel() // (2 * N),
                N, pts.data_ptr(), None if init is None else init.data_ptr(),
                xy.data_ptr(), status.data_ptr(), error.data_ptr(), win,
                cfg.max_iterations, float(cfg.epsilon ** 2),
                float(cfg.min_eig_threshold / (255.0 * 255.0)),
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"klt_track launch failed: cudaError {err}")
    track_pyramid.launches += 1
    return TrackResult(xy=xy, status=status, error=error)


track_pyramid.launches = 0


def track(template: torch.Tensor, target: torch.Tensor, pts: torch.Tensor,
          cfg: KltConfig = KltConfig(),
          init: torch.Tensor | None = None) -> TrackResult:
    """Builds the 2x pyramids, then tracks."""
    tp = im.build_pyramid(template, cfg.pyramid_levels, 2.0)
    gp = im.build_pyramid(target, cfg.pyramid_levels, 2.0)
    return track_pyramid(tp, gp, pts, cfg, init)
