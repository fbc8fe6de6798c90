"""KITTI odometry sequence reader (counterpart of
``semantic_slam_mapping_tpu/io/kitti.py``), on the port's own PNG codec.

Layout:
  <root>/image_0/%06d.png   left grey
  <root>/image_1/%06d.png   right grey
  <root>/image_2/%06d.png   left color (optional, for the map)
  <root>/<semantic_dir>/%06d.png   precomputed labels (optional)

Images become float32 in [0, 1] as the JAX package makes them: the uint8
samples in float32 divided by 255.0 (a true division), so the values are
exactly the k/255 that ``SlamSystem._upload_gray`` quantises back to uint8
without loss. Labels load as int32.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from semantic_slam_mapping_torch.io.frame import StereoFrame
from semantic_slam_mapping_torch.io.png import read_png


def _load_gray(path: Path) -> np.ndarray:
    return read_png(path, "L").astype(np.float32) / 255.0


def _load_color(path: Path) -> np.ndarray:
    return read_png(path, "RGB").astype(np.float32) / 255.0


def _load_label(path: Path) -> np.ndarray:
    return read_png(path, "L").astype(np.int32)


class KittiReader:
    """Indexable frame source over a KITTI odometry sequence directory."""

    def __init__(self, root: str, start_index: int = 0,
                 end_index: Optional[int] = None,
                 left_dir: str = "image_0", right_dir: str = "image_1",
                 color_dir: str = "image_2",
                 semantic_dir: Optional[str] = None):
        self.root = Path(root)
        self.left_dir = self.root / left_dir
        self.right_dir = self.root / right_dir
        self.color_dir = self.root / color_dir
        self.semantic_dir = self.root / semantic_dir if semantic_dir else None
        if not self.left_dir.is_dir():
            raise FileNotFoundError(f"no left image dir: {self.left_dir}")
        n = len([f for f in os.listdir(self.left_dir) if f.endswith(".png")])
        self.start = start_index
        self.end = min(end_index, n) if end_index is not None else n
        if self.start >= self.end:
            raise ValueError(f"empty frame range [{self.start}, {self.end})")

    def __len__(self) -> int:
        return self.end - self.start

    def get(self, index: int) -> StereoFrame:
        """The frame of absolute dataset index ``index`` (``%06d.png``)."""
        name = f"{index:06d}.png"
        left = _load_gray(self.left_dir / name)
        right = _load_gray(self.right_dir / name)
        color = (_load_color(self.color_dir / name)
                 if self.color_dir.is_dir() else None)
        semantic = (_load_label(self.semantic_dir / name)
                    if self.semantic_dir and self.semantic_dir.is_dir()
                    else None)
        return StereoFrame(left=left, right=right, index=index,
                           color=color, semantic=semantic)

    def __iter__(self) -> Iterator[StereoFrame]:
        for i in range(self.start, self.end):
            yield self.get(i)
