"""Numpy SE(3) helpers for the host-side bookkeeping of the SLAM engine.

A copy of ``semantic_slam_mapping_tpu/geometry/se3_np.py`` (the port
imports nothing of the JAX package): the keyframe epoch's 4x4 pose algebra
(edge chi2 statistics, the loop-verification agreement gates) runs on the
host in float64, exactly as the JAX package runs it. Device code uses
``geometry/se3.py``.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-9


def inverse(T: np.ndarray) -> np.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    out = np.zeros_like(T)
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(…, 3, 3) -> unit quaternion (…, 4) [w, x, y, z], w >= 0 (same
    branchless Shepperd construction as geometry/se3.py)."""
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    trace = r00 + r11 + r22
    tw = 1.0 + trace
    tx = 1.0 + r00 - r11 - r22
    ty = 1.0 - r00 + r11 - r22
    tz = 1.0 - r00 - r11 + r22
    cand = np.stack([tw, tx, ty, tz], axis=-1)
    best = np.argmax(cand, axis=-1)
    s = np.sqrt(np.clip(np.take_along_axis(
        cand, best[..., None], axis=-1)[..., 0], _EPS, None)) * 0.5
    inv4s = 1.0 / (4.0 * s)
    a01, a10 = R[..., 0, 1], R[..., 1, 0]
    a02, a20 = R[..., 0, 2], R[..., 2, 0]
    a12, a21 = R[..., 1, 2], R[..., 2, 1]
    q_w = np.stack([s, (a21 - a12) * inv4s, (a02 - a20) * inv4s,
                    (a10 - a01) * inv4s], axis=-1)
    q_x = np.stack([(a21 - a12) * inv4s, s, (a01 + a10) * inv4s,
                    (a02 + a20) * inv4s], axis=-1)
    q_y = np.stack([(a02 - a20) * inv4s, (a01 + a10) * inv4s, s,
                    (a12 + a21) * inv4s], axis=-1)
    q_z = np.stack([(a10 - a01) * inv4s, (a02 + a20) * inv4s,
                    (a12 + a21) * inv4s, s], axis=-1)
    b = best[..., None]
    q = np.where(b == 0, q_w, np.where(b == 1, q_x,
                                       np.where(b == 2, q_y, q_z)))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (…, 4) [w, x, y, z] -> rotation matrix (…, 3, 3)
    (inverse of :func:`rotation_to_quaternion`; g2o import path)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def so3_log(R: np.ndarray) -> np.ndarray:
    q = rotation_to_quaternion(R)
    qw, qv = q[..., 0], q[..., 1:]
    n = np.linalg.norm(qv, axis=-1)
    theta = 2.0 * np.arctan2(n, qw)
    scale = np.where(n < 1e-7, 2.0 / np.maximum(qw, _EPS),
                     theta / np.maximum(n, _EPS))
    return qv * scale[..., None]


def _hat(w: np.ndarray) -> np.ndarray:
    z = np.zeros_like(w[..., 0])
    return np.stack([
        np.stack([z, -w[..., 2], w[..., 1]], -1),
        np.stack([w[..., 2], z, -w[..., 0]], -1),
        np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _left_jacobian_inv(w: np.ndarray) -> np.ndarray:
    theta2 = np.sum(w * w, axis=-1)
    theta = np.sqrt(theta2 + _EPS)
    W = _hat(w)
    W2 = W @ W
    half = 0.5 * theta
    cot = half * np.cos(half) / np.maximum(np.sin(half), _EPS)
    k = (1.0 - cot) / (theta2 + _EPS)
    k = np.where(theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0, k)
    eye = np.broadcast_to(np.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + k[..., None, None] * W2


def log(T: np.ndarray) -> np.ndarray:
    """SE(3) log map: (…, 4, 4) -> (…, 6) tangent [v, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    v = np.einsum("...ij,...j->...i", _left_jacobian_inv(w), t)
    return np.concatenate([v, w], axis=-1)
