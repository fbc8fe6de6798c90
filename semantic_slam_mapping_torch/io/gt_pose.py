"""Ground-truth trajectories: KITTI pose files (rows of a 3x4 camera-to-
world matrix) read and written, and TUM trajectories (``t tx ty tz qx qy
qz qw``) read. A numpy copy of ``semantic_slam_mapping_tpu/io/gt_pose.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_kitti_poses(path: str | Path) -> np.ndarray:
    """Rows of 12 floats (row-major 3x4) -> (N, 4, 4) float64."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        vals = np.array([float(x) for x in line.split()])
        if vals.size != 12:
            raise ValueError(f"expected 12 values per row, got {vals.size}")
        T = np.eye(4)
        T[:3, :4] = vals.reshape(3, 4)
        rows.append(T)
    return np.stack(rows)


def read_tum_trajectory(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """``t tx ty tz qx qy qz qw`` rows (others skipped) -> (timestamps
    (N,), poses (N, 4, 4))."""
    ts, poses = [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        v = [float(x) for x in line.split()]
        if len(v) != 8:
            continue
        t, tx, ty, tz, qx, qy, qz, qw = v
        ts.append(t)
        T = np.eye(4)
        T[:3, :3] = _quat_to_rot(qw, qx, qy, qz)
        T[:3, 3] = (tx, ty, tz)
        poses.append(T)
    return np.array(ts), np.stack(poses)


def _quat_to_rot(w: float, x: float, y: float, z: float) -> np.ndarray:
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def write_kitti_poses(path: str | Path, poses: np.ndarray) -> None:
    """Inverse of :func:`read_kitti_poses`, 10 significant digits."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{x:.9e}" for x in np.asarray(T)[:3, :4].ravel())
                    + "\n")
