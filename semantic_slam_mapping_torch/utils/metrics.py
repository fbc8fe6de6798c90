"""Trajectory accuracy in numpy: the absolute trajectory error after a
rigid Umeyama alignment, and the relative pose error over a frame delta
(the JAX package's ``utils/metrics.py`` formulas)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TrajectoryError(NamedTuple):
    rmse: float
    mean: float
    median: float
    maximum: float

    def __repr__(self) -> str:
        return (f"TrajErr(rmse={self.rmse:.4f}, mean={self.mean:.4f}, "
                f"median={self.median:.4f}, max={self.maximum:.4f})")


def _stats(errors: np.ndarray) -> TrajectoryError:
    return TrajectoryError(
        rmse=float(np.sqrt(np.mean(errors ** 2))),
        mean=float(np.mean(errors)),
        median=float(np.median(errors)),
        maximum=float(np.max(errors)),
    )


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares rotation, translation and (optionally) scale aligning
    src (N, 3) to dst: (R, t, s)."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = (float(np.trace(np.diag(D) @ S) / ((xs ** 2).sum() / len(src)))
         if with_scale else 1.0)
    return R, mu_d - s * R @ mu_s, s


def absolute_trajectory_error(est: np.ndarray, gt: np.ndarray,
                              align: bool = True,
                              with_scale: bool = False) -> TrajectoryError:
    """ATE over translation; est, gt: (N, 4, 4) camera-to-world poses."""
    p_est, p_gt = est[:, :3, 3], gt[:, :3, 3]
    if align:
        R, t, s = umeyama_alignment(p_est, p_gt, with_scale)
        p_est = (s * (R @ p_est.T)).T + t
    return _stats(np.linalg.norm(p_est - p_gt, axis=1))


def relative_pose_error(est: np.ndarray, gt: np.ndarray, delta: int = 1
                        ) -> tuple[TrajectoryError, TrajectoryError]:
    """RPE at frame delta ``delta``: (translational (m), rotational (rad))
    error statistics."""
    n = len(est) - delta
    t_err, r_err = np.empty(n), np.empty(n)
    for i in range(n):
        d_est = np.linalg.inv(est[i]) @ est[i + delta]
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        t_err[i] = np.linalg.norm(e[:3, 3])
        r_err[i] = np.arccos(np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0,
                                     -1.0, 1.0))
    return _stats(t_err), _stats(r_err)


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of the aligned translation error; est, gt: (N, 4, 4) T_w_c."""
    return absolute_trajectory_error(est, gt).rmse
