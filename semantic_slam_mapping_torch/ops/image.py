"""Dense image primitives: separable filters, pyramids, gradients, bilinear
sampling, binary morphology and Otsu's threshold.

Counterpart of ``semantic_slam_mapping_tpu/ops/image.py`` on (..., H, W)
torch tensors. The separable filter keeps the reference's tap order and
float32 accumulation, so a float32 image filters to the same rounding.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _sep_filter(img: torch.Tensor, kx: np.ndarray,
                ky: np.ndarray) -> torch.Tensor:
    """Separable 2D filter on (..., H, W) with reflect padding, summing the
    taps in order in float32 whatever the input dtype."""
    batch_shape = img.shape[:-2]
    H, W = img.shape[-2:]
    x = img.reshape((-1, 1, H, W)).float()
    ry, rx = len(ky) // 2, len(kx) // 2
    xp = F.pad(x, (0, 0, ry, ry), mode="reflect")
    acc = float(ky[0]) * xp[:, :, 0:H, :]
    for k in range(1, len(ky)):
        acc = acc + float(ky[k]) * xp[:, :, k:k + H, :]
    xp = F.pad(acc, (rx, rx, 0, 0), mode="reflect")
    out = float(kx[0]) * xp[:, :, :, 0:W]
    for k in range(1, len(kx)):
        out = out + float(kx[k]) * xp[:, :, :, k:k + W]
    return out.reshape(batch_shape + (H, W)).to(img.dtype)


def gaussian_blur(img: torch.Tensor, sigma: float = 1.0,
                  radius: int | None = None) -> torch.Tensor:
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    k = gaussian_kernel_1d(sigma, radius)
    return _sep_filter(img, k, k)


def box_blur(img: torch.Tensor, size: int) -> torch.Tensor:
    k = np.full((size,), 1.0 / size, np.float32)
    return _sep_filter(img, k, k)


_SCHARR_D = np.array([-1.0, 0.0, 1.0], np.float32) * 0.5
_SOBEL_S = np.array([1.0, 2.0, 1.0], np.float32) / 4.0


def gradients(img: torch.Tensor,
              smooth: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Ix, Iy) central-difference gradients (Sobel-smoothed by default)."""
    s = _SOBEL_S if smooth else np.array([0.0, 1.0, 0.0], np.float32)
    return _sep_filter(img, _SCHARR_D, s), _sep_filter(img, s, _SCHARR_D)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x downsample (5-tap binomial blur, then stride 2)."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
    return _sep_filter(img, k, k)[..., ::2, ::2]


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of an antialiased linear resize along
    one axis, as ``jax.image.scale_and_translate`` builds them: a triangle
    kernel widened by the downscale factor (not when upscaling), weights
    normalised per output sample, samples outside the input zeroed."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.0) * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
         / kernel_scale)
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_bilinear(img: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Linear resize of (..., H, W) to (..., H', W'), antialiased when it
    downsamples: the weights of ``jax.image.resize(..., "bilinear")``
    applied as two contractions (``F.interpolate`` does not promise the
    same weights)."""
    H, W = img.shape[-2:]
    h, w = out_hw
    x = img.float()
    if h != H:
        wy = torch.from_numpy(_resize_weights(H, h)).to(img.device)
        x = torch.einsum("...yx,yo->...ox", x, wy)
    if w != W:
        wx = torch.from_numpy(_resize_weights(W, w)).to(img.device)
        x = torch.einsum("...yx,xo->...yo", x, wx)
    return x


def resize_nearest(img: torch.Tensor,
                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of (..., H, W), for label images: source
    index floor((i + 0.5) * n_in / n_out), as ``jax.image.resize``."""
    for axis, n_out in ((-2, out_hw[0]), (-1, out_hw[1])):
        n_in = img.shape[axis]
        if n_in == n_out:
            continue
        offs = np.floor(((np.arange(n_out, dtype=np.float32) + 0.5)
                         * np.float32(n_in / n_out)).astype(np.float32))
        img = torch.index_select(img, axis, torch.from_numpy(
            offs.astype(np.int64)).to(img.device))
    return img


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale_factor: float = 2.0) -> List[torch.Tensor]:
    """Image pyramid, finest first: 2x levels by the 5-tap blur and stride
    (the KLT pyramid); any other factor (ORB's 1.2) by a sigma-0.8 blur of
    the previous level and an antialiased resize to round(H / s^l)."""
    levels = [img]
    H, W = img.shape[-2:]
    for lvl in range(1, n_levels):
        s = scale_factor ** lvl
        h, w = max(8, int(round(H / s))), max(8, int(round(W / s)))
        if scale_factor == 2.0:
            levels.append(downsample2(levels[-1]))
        else:
            levels.append(resize_bilinear(
                gaussian_blur(levels[-1], sigma=0.8), (h, w)))
    return levels


def take(img: torch.Tensor, yi: torch.Tensor,
         xi: torch.Tensor) -> torch.Tensor:
    """``img[..., yi, xi]`` with the indices clamped into the image, for
    (..., H, W) images and integer index tensors whose leading dims start
    with the images' batch dims: each frame reads its own image."""
    H, W = img.shape[-2:]
    nb = img.dim() - 2
    i = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    flat = img.reshape(img.shape[:-2] + (H * W,))
    return torch.gather(flat, -1, i.reshape(i.shape[:nb] + (-1,))).reshape(
        i.shape)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor,
                    pad_value: float = 0.0) -> torch.Tensor:
    """Sample (..., H, W) images at float coords xy (..., 2) [x, y] with
    clamped bilinear taps (xy's leading dims start with the images' batch
    dims); points outside the image get ``pad_value``."""
    H, W = img.shape[-2:]
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    ax, ay = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()

    def at(yi, xi):
        return take(img, yi, xi)

    v = ((1 - ay) * ((1 - ax) * at(y0i, x0i) + ax * at(y0i, x0i + 1))
         + ay * ((1 - ax) * at(y0i + 1, x0i) + ax * at(y0i + 1, x0i + 1)))
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return torch.where(inb, v, torch.full_like(v, pad_value))


def _morph(img: torch.Tensor, size: int, is_dilate: bool,
           iterations: int = 1) -> torch.Tensor:
    """Grey/binary morphology with a size x size window ("SAME" borders)."""
    H, W = img.shape[-2:]
    x = img.float().reshape((-1, 1, H, W))
    sign = 1.0 if is_dilate else -1.0
    for _ in range(iterations):
        x = sign * F.max_pool2d(sign * x, size, stride=1, padding=size // 2)
    x = x.reshape(img.shape)
    return x > 0.5 if img.dtype == torch.bool else x.to(img.dtype)


def dilate(img: torch.Tensor, size: int = 3,
           iterations: int = 1) -> torch.Tensor:
    return _morph(img, size, True, iterations)


def erode(img: torch.Tensor, size: int = 3,
          iterations: int = 1) -> torch.Tensor:
    return _morph(img, size, False, iterations)


def _histogram(x: torch.Tensor, n_bins: int, lo, hi) -> torch.Tensor:
    """Counts of ``x`` (..., H, W) in ``n_bins`` equal bins over [lo, hi],
    the last bin closed (numpy's ``histogram``), per frame: (..., n_bins).
    ``lo``/``hi`` may be tensors of the batch shape."""
    batch = x.shape[:-2]
    x = x.reshape(batch + (-1,)).float()
    lo = torch.as_tensor(lo, dtype=torch.float32, device=x.device)[..., None]
    hi = torch.as_tensor(hi, dtype=torch.float32, device=x.device)[..., None]
    step = torch.arange(n_bins, dtype=torch.float32,
                        device=x.device) / float(n_bins)
    edges = torch.cat([lo * (1 - step) + hi * step, hi], dim=-1)
    edges = edges.expand(batch + edges.shape[-1:]).contiguous()
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[..., -1:], n_bins, idx)
    inside = (idx >= 1) & (idx <= n_bins)
    counts = torch.zeros(batch + (n_bins + 2,), dtype=torch.float32,
                         device=x.device)
    counts.scatter_add_(-1, idx, inside.float())
    return counts[..., 1:n_bins + 1]


def otsu_threshold(img: torch.Tensor, n_bins: int = 256,
                   value_range=(0.0, 1.0)) -> torch.Tensor:
    """Otsu's threshold of each (H, W) frame of ``img`` (..., H, W); a
    plateau of maxima yields its midpoint. The range's ends may be tensors
    of the batch shape."""
    lo, hi = value_range
    lo = torch.as_tensor(lo, dtype=torch.float32, device=img.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=img.device)
    hist = _histogram(img, n_bins, lo, hi)
    centers = lo[..., None] + (torch.arange(
        n_bins, dtype=torch.float32, device=hist.device) + 0.5) * (
            hi - lo)[..., None] / n_bins
    total = torch.sum(hist, -1, keepdim=True)
    w0 = torch.cumsum(hist, -1)
    w1 = total - w0
    cm = torch.cumsum(hist * centers, -1)
    m0 = cm / torch.clamp(w0, min=1e-9)
    m1 = (torch.sum(hist * centers, -1, keepdim=True) - cm) / torch.clamp(
        w1, min=1e-9)
    between = torch.where((w0 > 0) & (w1 > 0), w0 * w1 * (m0 - m1) ** 2,
                          torch.full_like(w0, -1.0))
    at_max = between >= between.amax(-1, keepdim=True) * (1.0 - 1e-6)
    idx_vals = torch.arange(n_bins, dtype=torch.float32, device=hist.device)
    mid = torch.sum(torch.where(at_max, idx_vals, 0.0), -1) / torch.clamp(
        torch.sum(at_max, -1), min=1)
    return lo + (mid + 0.5) * (hi - lo) / n_bins
