"""Top-down (x, z) plot of an estimated trajectory over the ground truth,
rasterised in numpy and written by the port's PNG codec (counterpart of
``semantic_slam_mapping_tpu/utils/plot.py``: the same canvas, margin,
scale, colours, line width, dot radius and dot decimation).

Pillow's bitmap-font caption has no counterpart without an imaging
library: the caption's text goes into the PNG as a ``tEXt`` chunk with the
keyword ``Comment``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from semantic_slam_mapping_torch.io.png import write_png

_EST_RGB = (40, 200, 60)
_GT_RGB = (220, 50, 50)
_LINE_WIDTH = 2
_DOT_RADIUS = 2


def _stamp(img: np.ndarray, u: np.ndarray, v: np.ndarray,
           offsets: np.ndarray, color) -> None:
    """Paint ``color`` at each (u, v) plus each integer offset."""
    H, W = img.shape[:2]
    x = (u[:, None] + offsets[None, :, 0]).ravel()
    y = (v[:, None] + offsets[None, :, 1]).ravel()
    ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    img[y[ok], x[ok]] = color


def _polyline(img: np.ndarray, px: np.ndarray, color) -> None:
    """Segments between consecutive points, ``_LINE_WIDTH`` px wide."""
    a, b = px[:-1], px[1:]
    # samples every half pixel along each segment
    n = np.maximum(np.ceil(2.0 * np.linalg.norm(b - a, axis=1)),
                   1).astype(np.int64)
    seg = np.repeat(np.arange(len(a)), n)
    frac = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / n[seg]
    pts = np.concatenate([a[seg] + (b - a)[seg] * frac[:, None], b[-1:]])
    off = np.stack(np.meshgrid(np.arange(_LINE_WIDTH),
                               np.arange(_LINE_WIDTH)), -1).reshape(-1, 2)
    base = np.floor(pts - (_LINE_WIDTH - 1) / 2.0).astype(np.int64)
    _stamp(img, base[:, 0], base[:, 1], off, color)


def plot_trajectories(path: str | Path, est: np.ndarray,
                      gt: Optional[np.ndarray] = None,
                      size: int = 1500, margin: int = 60) -> None:
    """Write a top-down (x, z) trajectory PNG; ``est``/``gt`` are (N, 4, 4)
    camera-to-world poses, the estimate green over the ground truth red."""
    tracks = [(np.asarray(est), _EST_RGB)]
    if gt is not None and len(gt):
        tracks.append((np.asarray(gt), _GT_RGB))
    pts = np.concatenate([t[:, [0, 2], 3] for t, _ in tracks])
    lo, hi = pts.min(0), pts.max(0)
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
    s = (size - 2 * margin) / span

    img = np.full((size, size, 3), 255, np.uint8)
    r = _DOT_RADIUS
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    disc = np.stack([dx, dy], -1)[dx ** 2 + dy ** 2 <= r * r]
    for poses, color in reversed(tracks):  # the ground truth underneath
        xz = poses[:, [0, 2], 3]
        px = np.stack([margin + (xz[:, 0] - lo[0]) * s,
                       size - margin - (xz[:, 1] - lo[1]) * s], -1)
        if len(px) > 1:
            _polyline(img, px, color)
        dots = np.round(px[:: max(1, len(px) // 300)]).astype(np.int64)
        _stamp(img, dots[:, 0], dots[:, 1], disc, color)
    caption = "green: estimated" + ("   red: ground truth" if gt is not None
                                    else "")
    write_png(path, img, text={"Comment": caption})
