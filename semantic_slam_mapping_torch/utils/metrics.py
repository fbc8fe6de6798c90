"""Trajectory accuracy: absolute trajectory error after a rigid Umeyama
alignment (numpy; the JAX package's ``utils/metrics.py`` formula)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Least-squares rotation and translation aligning src (N, 3) to dst."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of the aligned translation error; est, gt: (N, 4, 4) T_w_c."""
    p_est, p_gt = est[:, :3, 3], gt[:, :3, 3]
    R, t = umeyama_alignment(p_est, p_gt)
    err = np.linalg.norm(p_est @ R.T + t - p_gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))
