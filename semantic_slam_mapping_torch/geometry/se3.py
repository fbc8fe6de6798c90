"""SE(3)/SO(3) Lie-group operations on batched torch tensors.

Counterpart of ``semantic_slam_mapping_tpu/geometry/se3.py``. Poses are
(…, 4, 4) homogeneous matrices (float32); tangents are ``[v, w]`` with the
translation first, ``exp([v, w]) = [[R, V v], [0, 1]]``. Matrix products run
in full float32 (no TF32: ``torch.matmul`` on float32 stays float32 unless
the caller enables ``allow_tf32``).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye3_like(w: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(
        w.shape[:-1] + (3, 3))


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (…, 3) -> (…, 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (…, 3, 3) -> (…, 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, with Taylor terms at theta -> 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / (theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, a)
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    return _eye3_like(w) + a[..., None, None] * W + b[..., None, None] * W2


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) -> unit quaternion (…, 4) [w, x, y, z] with w >= 0
    (branchless Shepperd's method: the largest pivot of four)."""
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    trace = r00 + r11 + r22
    cand = torch.stack([1.0 + trace, 1.0 + r00 - r11 - r22,
                        1.0 - r00 + r11 - r22, 1.0 - r00 - r11 + r22], dim=-1)
    best = torch.argmax(cand, dim=-1)
    s = torch.sqrt(torch.clamp(torch.gather(
        cand, -1, best[..., None])[..., 0], min=_EPS)) * 0.5
    inv4s = 1.0 / (4.0 * s)
    a01, a10 = R[..., 0, 1], R[..., 1, 0]
    a02, a20 = R[..., 0, 2], R[..., 2, 0]
    a12, a21 = R[..., 1, 2], R[..., 2, 1]
    q_w = torch.stack([s, (a21 - a12) * inv4s, (a02 - a20) * inv4s,
                       (a10 - a01) * inv4s], dim=-1)
    q_x = torch.stack([(a21 - a12) * inv4s, s, (a01 + a10) * inv4s,
                       (a02 + a20) * inv4s], dim=-1)
    q_y = torch.stack([(a02 - a20) * inv4s, (a01 + a10) * inv4s, s,
                       (a12 + a21) * inv4s], dim=-1)
    q_z = torch.stack([(a10 - a01) * inv4s, (a02 + a20) * inv4s,
                       (a12 + a21) * inv4s, s], dim=-1)
    b = best[..., None]
    q = torch.where(b == 0, q_w, torch.where(b == 1, q_x,
                                             torch.where(b == 2, q_y, q_z)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3): (…, 3, 3) -> (…, 3), through the quaternion."""
    q = rotation_to_quaternion(R)
    qw, qv = q[..., 0], q[..., 1:]
    n = torch.linalg.norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(n, qw)
    scale = torch.where(n < 1e-7, 2.0 / torch.clamp(qw, min=_EPS),
                        theta / torch.clamp(n, min=_EPS))
    return qv * scale[..., None]


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    b = (1.0 - torch.cos(theta)) / (theta2 + _EPS)
    c = (theta - torch.sin(theta)) / (theta2 * theta + _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    return _eye3_like(w) + b[..., None, None] * W + c[..., None, None] * W2


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    half = 0.5 * theta
    cot = half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)
    k = (1.0 - cot) / (theta2 + _EPS)
    k = torch.where(theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0, k)
    return _eye3_like(w) - 0.5 * W + k[..., None, None] * W2


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (…, 4, 4) from (…, 3, 3) rotations and (…, 3) translations."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exp map: (…, 6) tangent [v, w] -> (…, 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    t = (_left_jacobian(w) @ v[..., None])[..., 0]
    return make(so3_exp(w), t)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map: (…, 4, 4) -> (…, 6) tangent [v, w]."""
    w = so3_log(T[..., :3, :3])
    v = (_left_jacobian_inv(w) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], dim=-1)


def identity(dtype: torch.dtype = torch.float32,
             device: str | torch.device = "cuda") -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """SE(3) product A @ B."""
    return A @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (…, 4, 4) to points (…, N, 3) -> (…, N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (two Newton steps of the
    polar decomposition, R <- R (3I - R^T R) / 2)."""
    R = T[..., :3, :3]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    for _ in range(2):
        RtR = R.transpose(-1, -2) @ R
        R = R @ (1.5 * eye - 0.5 * RtR)
    return make(R, T[..., :3, 3])


def translation_norm(T: torch.Tensor) -> torch.Tensor:
    """Length of the translation of a relative pose."""
    return torch.linalg.norm(T[..., :3, 3], dim=-1)


def rotation_angle(T: torch.Tensor) -> torch.Tensor:
    """Rotation angle (rad) of a relative pose."""
    return torch.linalg.norm(so3_log(T[..., :3, :3]), dim=-1)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3) acting on [v, w] tangents: (…, 6, 6)."""
    R = T[..., :3, :3]
    tR = hat(T[..., :3, 3]) @ R
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)
