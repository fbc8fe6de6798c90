"""Plain checks of a trajectory and a map against the rendered world.

``ate`` is a frozen copy of the port's ``utils/metrics`` arithmetic: the
translation error after a rigid Umeyama alignment; ``rpe_pct`` a
percentile of the error of the motion over a few frames. ``relocate``
moves a map's points into the true world through their nearest
keyframes, and ``surface_distance`` gives a point's distance to the
nearest surface of a street world: the ground plane and the boxes, each
mover's box at every position it takes in the frames that the map was
built from.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Rotation and translation that best map points src (N, 3) onto dst."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate(est: np.ndarray, gt: np.ndarray):
    """(RMSE of the aligned positions' error in metres, R, t) for (N, 4, 4)
    camera-to-world poses."""
    R, t = umeyama(est[:, :3, 3], gt[:, :3, 3])
    p = est[:, :3, 3] @ R.T + t
    err = np.linalg.norm(p - gt[:, :3, 3], axis=1)
    return float(np.sqrt(np.mean(err ** 2))), R, t


def rpe_pct(est: np.ndarray, gt: np.ndarray, delta: int,
            q: float = 90.0) -> float:
    """The ``q``-th percentile over the trajectory of the translational
    error of the motion over ``delta`` frames, as a share (%) of the true
    motion's length: drift-free, so that a faulty stretch shows however
    long the drive, and blind to a few frames gone astray."""
    d_est = np.linalg.inv(est[:-delta]) @ est[delta:]
    d_gt = np.linalg.inv(gt[:-delta]) @ gt[delta:]
    err = np.linalg.inv(d_gt) @ d_est
    rel = (np.linalg.norm(err[:, :3, 3], axis=1)
           / np.linalg.norm(d_gt[:, :3, 3], axis=1))
    return float(100.0 * np.percentile(rel, q))


def relocate(points: np.ndarray, est: np.ndarray,
             true: np.ndarray) -> np.ndarray:
    """Points (N, 3) of an estimated map moved into the true world through
    their nearest keyframe: expressed in its camera by its estimated pose
    (K, 4, 4), then placed by its true pose, so that the drift accumulated
    before that keyframe drops out and what was built around it stays."""
    pos = est[:, :3, 3]
    near = np.argmin(((points[:, None, :] - pos[None]) ** 2).sum(-1), axis=1)
    move = true @ np.linalg.inv(est)                      # (K, 4, 4)
    R, t = move[near, :3, :3], move[near, :3, 3]
    return np.einsum("nij,nj->ni", R, points) + t


def _box_distance(p: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Distance of points (N, 3) to the surfaces of boxes (M, 3): (N, M)."""
    p = p[:, None, :]
    outside = np.linalg.norm(np.maximum(np.maximum(lo - p, p - hi), 0.0),
                             axis=-1)
    inside = np.minimum(p - lo, hi - p).min(axis=-1)
    return np.where(outside > 0, outside, np.maximum(inside, 0.0))


def surface_distance(points: np.ndarray, world: dict,
                     frames: np.ndarray) -> np.ndarray:
    """Distance of world points (N, 3) to the street's nearest surface; the
    movers are taken at each frame index of ``frames``."""
    d = np.abs(points[:, 1] - world["ground_y"])
    boxes = np.asarray(world["boxes"], np.float64)
    if len(boxes):
        d = np.minimum(d, _box_distance(points, boxes[:, 0],
                                        boxes[:, 1]).min(axis=1))
    movers = np.asarray(world["movers"], np.float64)
    if len(movers):
        vel = np.asarray(world["mover_velocity"], np.float64)
        for f in np.unique(frames):
            off = vel * float(f)
            d = np.minimum(d, _box_distance(points, movers[:, 0] + off,
                                            movers[:, 1] + off).min(axis=1))
    return d
