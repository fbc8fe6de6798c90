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


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale_factor: float = 2.0) -> List[torch.Tensor]:
    """2x image pyramid, finest first (the KLT pyramid). The ORB pyramid
    at scale 1.2 is not ported yet."""
    if scale_factor != 2.0:
        raise NotImplementedError("only the 2x (KLT) pyramid is ported")
    levels = [img]
    for _ in range(1, n_levels):
        levels.append(downsample2(levels[-1]))
    return levels


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor,
                    pad_value: float = 0.0) -> torch.Tensor:
    """Sample an (H, W) image at float coords xy (..., 2) [x, y] with
    clamped bilinear taps; points outside the image get ``pad_value``."""
    H, W = img.shape[-2:]
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    ax, ay = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()

    def at(yi, xi):
        return img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]

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
    """Counts of ``x`` in ``n_bins`` equal bins over [lo, hi], the last bin
    closed (numpy's ``histogram``). ``lo``/``hi`` may be 0-d tensors."""
    x = x.reshape(-1).float()
    lo = torch.as_tensor(lo, dtype=torch.float32, device=x.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=x.device)
    step = torch.arange(n_bins, dtype=torch.float32,
                        device=x.device) / float(n_bins)
    edges = torch.cat([lo * (1 - step) + hi * step, hi[None]])
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], n_bins, idx)
    inside = (idx >= 1) & (idx <= n_bins)
    counts = torch.zeros(n_bins + 2, dtype=torch.float32, device=x.device)
    counts.index_add_(0, idx, inside.float())
    return counts[1:n_bins + 1]


def otsu_threshold(img: torch.Tensor, n_bins: int = 256,
                   value_range=(0.0, 1.0)) -> torch.Tensor:
    """Otsu's threshold; a plateau of maxima yields its midpoint."""
    lo, hi = value_range
    hist = _histogram(img, n_bins, lo, hi)
    centers = lo + (torch.arange(n_bins, dtype=torch.float32,
                                 device=hist.device) + 0.5) * (hi - lo) / n_bins
    total = torch.sum(hist)
    w0 = torch.cumsum(hist, 0)
    w1 = total - w0
    cm = torch.cumsum(hist * centers, 0)
    m0 = cm / torch.clamp(w0, min=1e-9)
    m1 = (torch.sum(hist * centers) - cm) / torch.clamp(w1, min=1e-9)
    between = torch.where((w0 > 0) & (w1 > 0), w0 * w1 * (m0 - m1) ** 2,
                          torch.full_like(w0, -1.0))
    at_max = between >= torch.max(between) * (1.0 - 1e-6)
    idx_vals = torch.arange(n_bins, dtype=torch.float32, device=hist.device)
    mid = torch.sum(torch.where(at_max, idx_vals, 0.0)) / torch.clamp(
        torch.sum(at_max), min=1)
    return lo + (mid + 0.5) * (hi - lo) / n_bins
