"""U-V-disparity ground-plane estimation and moving-object detection.

Counterpart of ``semantic_slam_mapping_tpu/frontend/uvdisparity.py``:
V-disparity ground-line fit and pitch (with a 2-state Kalman filter),
U-disparity over obstacle pixels, one connected-component pass over the
thresholded U-disparity, and a component is moving iff it holds at least
one VO-outlier seed, fewer than ``inlier_tolerance`` inlier seeds and at
least ``min_area`` cells. Histograms are ``index_add_`` scatter-adds.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from semantic_slam_mapping_torch.config import UVDisparityConfig
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.ops.components import connected_components


class PitchKalmanState(NamedTuple):
    """(angle, angular rate) Kalman state of one pitch."""

    x: torch.Tensor   # (2,)
    P: torch.Tensor   # (2, 2)

    @classmethod
    def init(cls, error_cov_post: float = 1.0,
             device: str | torch.device = "cuda") -> "PitchKalmanState":
        return cls(x=torch.zeros(2, device=device),
                   P=error_cov_post * torch.eye(2, device=device))


def pitch_kalman_update(state: PitchKalmanState, measurement: torch.Tensor,
                        cfg: UVDisparityConfig) -> PitchKalmanState:
    dev = state.x.device
    F = torch.tensor([[1.0, 1.0], [0.0, 1.0]], device=dev)
    Hm = torch.tensor([[1.0, 0.0]], device=dev)
    eye = torch.eye(2, device=dev)
    x = F @ state.x
    P = F @ state.P @ F.T + cfg.kf_process_noise * eye
    y = measurement - Hm @ x
    S = Hm @ P @ Hm.T + cfg.kf_measurement_noise
    Kg = P @ Hm.T / S[0, 0]
    x = x + (Kg * y).reshape(2)
    P = (eye - Kg @ Hm) @ P
    return PitchKalmanState(x=x, P=P)


class UVResult(NamedTuple):
    moving_mask: torch.Tensor    # (H, W) bool
    pitch: torch.Tensor          # measured ground pitch (rad)
    horizon_row: torch.Tensor    # v at disparity 0 of the ground line
    ground_mask: torch.Tensor    # (H, W) bool
    u_disparity: torch.Tensor    # (D, W) sigmoid-adjusted U-disparity
    inlier_roi: torch.Tensor     # (N,)
    outlier_roi: torch.Tensor    # (N,)


def _bins(disparity: torch.Tensor, num_disparities: int) -> torch.Tensor:
    # float -> int truncates toward zero, as astype(int32) does
    return torch.clamp(disparity.long(), 0, num_disparities - 1)


def v_disparity(disparity: torch.Tensor, valid: torch.Tensor,
                num_disparities: int) -> torch.Tensor:
    """(H, W) disparity -> (H, D) row histogram of the valid pixels."""
    H, W = disparity.shape
    rows = torch.arange(H, device=disparity.device)[:, None]
    flat = (rows * num_disparities + _bins(disparity, num_disparities))
    hist = torch.zeros(H * num_disparities, device=disparity.device)
    hist.index_add_(0, flat.reshape(-1), valid.reshape(-1).float())
    return hist.reshape(H, num_disparities)


def u_disparity(disparity: torch.Tensor, mask: torch.Tensor,
                num_disparities: int) -> torch.Tensor:
    """(H, W) disparity -> (D, W) column histogram of the ``mask`` pixels."""
    H, W = disparity.shape
    cols = torch.arange(W, device=disparity.device)[None, :]
    flat = _bins(disparity, num_disparities) * W + cols
    hist = torch.zeros(num_disparities * W, device=disparity.device)
    hist.index_add_(0, flat.reshape(-1), mask.reshape(-1).float())
    return hist.reshape(num_disparities, W)


def fit_ground_line(vdisp: torch.Tensor,
                    cfg: UVDisparityConfig = UVDisparityConfig()
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the ground line v = a d + b to the V-disparity: blur, Otsu
    threshold, per-column weighted centroid of the lower strong band, then
    weighted least squares (column d = 0 ignored)."""
    H, D = vdisp.shape
    dev = vdisp.device
    sm = im.gaussian_blur(vdisp, sigma=max(0.5, cfg.v_blur_ksize / 3.0),
                          radius=max(1, cfg.v_blur_ksize // 2))
    th = im.otsu_threshold(sm, n_bins=cfg.otsu_bins,
                           value_range=(0.0, torch.max(sm) + 1e-6))
    strong = sm > torch.clamp(th, min=1.0)
    rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    col_max = torch.where(strong, rows, -1.0).amax(dim=0)
    lower_half = rows >= (col_max[None, :] - 4.0)
    wgt = torch.where(strong & lower_half, sm, 0.0)
    col_w = torch.sum(wgt, dim=0)
    v_bot = torch.sum(wgt * rows, dim=0) / torch.clamp(col_w, min=1e-6)
    w = (col_w > 0).float()
    w[0] = 0.0
    ds = torch.arange(D, dtype=torch.float32, device=dev)
    sw = torch.sum(w) + 1e-6
    mx = torch.sum(w * ds) / sw
    my = torch.sum(w * v_bot) / sw
    cov = torch.sum(w * (ds - mx) * (v_bot - my)) / sw
    var = torch.sum(w * (ds - mx) ** 2) / sw
    a = cov / torch.clamp(var, min=1e-6)
    return a, my - a * mx


def ground_pitch(K: Intrinsics, horizon_row: torch.Tensor) -> torch.Tensor:
    """theta = atan((v0 - cy) / fy)."""
    return torch.atan2(horizon_row - K.cy, torch.full_like(horizon_row, K.fy))


def sigmoid_adjust(u_disp: torch.Tensor,
                   cfg: UVDisparityConfig) -> torch.Tensor:
    return 255.0 / (1.0 + torch.exp(-cfg.sigmoid_alpha
                                    * (u_disp * 255.0 / 8.0
                                       - cfg.sigmoid_beta)))


def measure_pitch(disparity: torch.Tensor, valid: torch.Tensor,
                  roi: torch.Tensor, K: Intrinsics, num_disparities: int,
                  cfg: UVDisparityConfig = UVDisparityConfig()
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """V-disparity ground-line fit -> (pitch measurement, line a, line b)."""
    vd = v_disparity(disparity, valid & roi, num_disparities)
    a, b = fit_ground_line(vd, cfg)
    return ground_pitch(K, b), a, b


def detect_moving_objects(
        disparity: torch.Tensor, valid: torch.Tensor, roi: torch.Tensor,
        inlier_uv: torch.Tensor, inlier_valid: torch.Tensor,
        outlier_uv: torch.Tensor, outlier_valid: torch.Tensor,
        K: Intrinsics, num_disparities: int = 80,
        cfg: UVDisparityConfig = UVDisparityConfig(),
        line_ab: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        ) -> UVResult:
    """Full U-V-disparity pass for one frame. inlier_uv / outlier_uv: (N, 2)
    current-left pixels of the VO inliers and outliers. ``line_ab`` is the
    ground line from :func:`measure_pitch` (fit here when None)."""
    H, W = disparity.shape
    D = num_disparities
    dev = disparity.device
    if line_ab is None:
        a, b = fit_ground_line(v_disparity(disparity, valid & roi, D), cfg)
    else:
        a, b = line_ab
    pitch = ground_pitch(K, b)

    rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    ground = valid & (torch.abs(rows - (a * disparity + b))
                      < 3.0 + 0.05 * disparity)

    def pixel(uv):
        x = torch.clamp(uv[:, 0].long(), 0, W - 1)
        y = torch.clamp(uv[:, 1].long(), 0, H - 1)
        return x, y

    inl_x, inl_y = pixel(inlier_uv)
    out_x, out_y = pixel(outlier_uv)
    inl_ok = inlier_valid & roi[inl_y, inl_x]
    out_ok = outlier_valid & roi[out_y, out_x]

    ud = u_disparity(disparity, valid & roi & ~ground, D)
    strong = ud >= cfg.min_intensity
    same = (torch.roll(strong, 1, 0), torch.roll(strong, -1, 0),
            torch.roll(strong, 1, 1), torch.roll(strong, -1, 1))
    lbl = connected_components(strong, same,
                               sweeps=cfg.flood_fill_sweeps).reshape(-1)

    def seed_cells(x, y, ok):
        """Feature pixels -> their (d_bin, u) U-disparity cells."""
        dv = disparity[y, x]
        d = _bins(dv, D)
        return d * W + x, ok & (dv > cfg.min_disparity_raw) & strong[d, x]

    out_cell, out_cell_ok = seed_cells(out_x, out_y, out_ok)
    inl_cell, inl_cell_ok = seed_cells(inl_x, inl_y, inl_ok)
    n_cells = D * W
    comp_area = torch.zeros(n_cells, device=dev).index_add_(
        0, lbl, strong.reshape(-1).float())
    out_counts = torch.zeros(n_cells, dtype=torch.int32, device=dev)
    out_counts.index_add_(0, lbl[out_cell], out_cell_ok.int())
    inl_counts = torch.zeros(n_cells, dtype=torch.int32, device=dev)
    inl_counts.index_add_(0, lbl[inl_cell], inl_cell_ok.int())
    moving_comp = ((out_counts >= 1) & (inl_counts < cfg.inlier_tolerance)
                   & (comp_area >= cfg.min_area))

    cell = _bins(disparity, D) * W + torch.arange(W, device=dev)[None, :]
    moving = (valid & roi & ~ground & strong.reshape(-1)[cell]
              & moving_comp[lbl[cell]]
              & (disparity > cfg.min_disparity_raw))
    return UVResult(moving_mask=moving, pitch=pitch, horizon_row=b,
                    ground_mask=ground, u_disparity=sigmoid_adjust(ud, cfg),
                    inlier_roi=inl_ok, outlier_roi=out_ok)
