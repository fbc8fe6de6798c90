"""Frame containers of the dataset readers: raw sensor data only, as numpy
arrays (counterpart of ``semantic_slam_mapping_tpu/io/frame.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class StereoFrame(NamedTuple):
    """One frame: gray images float32 in [0, 1], (H, W); ``index`` is the
    dataset's frame id."""

    left: np.ndarray
    right: np.ndarray
    index: int = 0
    # color for the map, (H, W, 3) float32 in [0, 1]
    color: Optional[np.ndarray] = None
    # precomputed labels, (H, W) int32
    semantic: Optional[np.ndarray] = None
    # metric depth (the TUM RGB-D path; KITTI's comes from SGBM)
    depth: Optional[np.ndarray] = None


class FramePair(NamedTuple):
    """The current and the previous stereo frame."""

    current: StereoFrame
    previous: StereoFrame
