"""U-V-disparity ground-plane estimation and moving-object detection.

Counterpart of ``semantic_slam_mapping_tpu/frontend/uvdisparity.py``:
V-disparity ground-line fit and pitch (with a 2-state Kalman filter),
U-disparity over obstacle pixels, one connected-component pass over the
thresholded U-disparity, and a component is moving iff it holds at least
one VO-outlier seed, fewer than ``inlier_tolerance`` inlier seeds and at
least ``min_area`` cells. Histograms are per-frame ``scatter_add_``s, so
a batch (B, H, W) of frames gives what each frame gives alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from semantic_slam_mapping_torch.config import UVDisparityConfig
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.ops.components import connected_components
from semantic_slam_mapping_torch.utils.device import to_device


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
    F = to_device([[1.0, 1.0], [0.0, 1.0]], dev, torch.float32)
    Hm = to_device([[1.0, 0.0]], dev, torch.float32)
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
    moving_mask: torch.Tensor    # (..., H, W) bool
    pitch: torch.Tensor          # measured ground pitch (rad)
    horizon_row: torch.Tensor    # v at disparity 0 of the ground line
    ground_mask: torch.Tensor    # (..., H, W) bool
    u_disparity: torch.Tensor    # (..., D, W) sigmoid-adjusted U-disparity
    inlier_roi: torch.Tensor     # (..., N)
    outlier_roi: torch.Tensor    # (..., N)


def _bins(disparity: torch.Tensor, num_disparities: int) -> torch.Tensor:
    # float -> int truncates toward zero, as astype(int32) does
    return torch.clamp(disparity.long(), 0, num_disparities - 1)


def _count(n: int, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-frame histogram: (..., n) sums of ``w`` at the flat indices
    ``idx`` (both (..., M)) of each frame, in ``w``'s dtype."""
    out = torch.zeros(idx.shape[:-1] + (n,), dtype=w.dtype,
                      device=idx.device)
    return out.scatter_add_(-1, idx, w)


def _flat(x: torch.Tensor, nd: int = 2) -> torch.Tensor:
    """The last ``nd`` dims of ``x`` as one."""
    return x.reshape(x.shape[:x.dim() - nd] + (-1,))


def v_disparity(disparity: torch.Tensor, valid: torch.Tensor,
                num_disparities: int) -> torch.Tensor:
    """(..., H, W) disparity -> (..., H, D) row histogram of the valid
    pixels."""
    H, W = disparity.shape[-2:]
    rows = torch.arange(H, device=disparity.device)[:, None]
    flat = (rows * num_disparities + _bins(disparity, num_disparities))
    hist = _count(H * num_disparities, _flat(flat), _flat(valid).float())
    return hist.reshape(disparity.shape[:-2] + (H, num_disparities))


def u_disparity(disparity: torch.Tensor, mask: torch.Tensor,
                num_disparities: int) -> torch.Tensor:
    """(..., H, W) disparity -> (..., D, W) column histogram of the
    ``mask`` pixels."""
    H, W = disparity.shape[-2:]
    cols = torch.arange(W, device=disparity.device)[None, :]
    flat = _bins(disparity, num_disparities) * W + cols
    hist = _count(num_disparities * W, _flat(flat), _flat(mask).float())
    return hist.reshape(disparity.shape[:-2] + (num_disparities, W))


def fit_ground_line(vdisp: torch.Tensor,
                    cfg: UVDisparityConfig = UVDisparityConfig()
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the ground line v = a d + b to each V-disparity (..., H, D):
    blur, Otsu threshold, per-column weighted centroid of the lower strong
    band, then weighted least squares (column d = 0 ignored)."""
    H, D = vdisp.shape[-2:]
    dev = vdisp.device
    sm = im.gaussian_blur(vdisp, sigma=max(0.5, cfg.v_blur_ksize / 3.0),
                          radius=max(1, cfg.v_blur_ksize // 2))
    th = im.otsu_threshold(
        sm, n_bins=cfg.otsu_bins,
        value_range=(0.0, sm.amax(dim=(-2, -1)) + 1e-6))
    strong = sm > torch.clamp(th, min=1.0)[..., None, None]
    rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    col_max = torch.where(strong, rows, -1.0).amax(dim=-2)
    lower_half = rows >= (col_max[..., None, :] - 4.0)
    wgt = torch.where(strong & lower_half, sm, 0.0)
    col_w = torch.sum(wgt, dim=-2)
    v_bot = torch.sum(wgt * rows, dim=-2) / torch.clamp(col_w, min=1e-6)
    w = (col_w > 0).float()
    w[..., 0] = 0.0
    ds = torch.arange(D, dtype=torch.float32, device=dev)
    sw = torch.sum(w, dim=-1) + 1e-6
    mx = torch.sum(w * ds, dim=-1) / sw
    my = torch.sum(w * v_bot, dim=-1) / sw
    cov = torch.sum(w * (ds - mx[..., None]) * (v_bot - my[..., None]),
                    dim=-1) / sw
    var = torch.sum(w * (ds - mx[..., None]) ** 2, dim=-1) / sw
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
    """V-disparity ground-line fit -> (pitch measurement, line a, line b),
    one of each per (H, W) frame."""
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
    """Full U-V-disparity pass for one (H, W) frame or a batch (B, H, W)
    of frames, each on its own. inlier_uv / outlier_uv: (..., N, 2)
    current-left pixels of the VO inliers and outliers. ``line_ab`` is the
    ground line from :func:`measure_pitch` (fit here when None)."""
    H, W = disparity.shape[-2:]
    D = num_disparities
    dev = disparity.device
    if line_ab is None:
        a, b = fit_ground_line(v_disparity(disparity, valid & roi, D), cfg)
    else:
        a, b = line_ab
    pitch = ground_pitch(K, b)

    rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    ground = valid & (torch.abs(rows - (a[..., None, None] * disparity
                                        + b[..., None, None]))
                      < 3.0 + 0.05 * disparity)

    def pixel(uv):
        x = torch.clamp(uv[..., 0].long(), 0, W - 1)
        y = torch.clamp(uv[..., 1].long(), 0, H - 1)
        return x, y

    inl_x, inl_y = pixel(inlier_uv)
    out_x, out_y = pixel(outlier_uv)
    inl_ok = inlier_valid & im.take(roi, inl_y, inl_x)
    out_ok = outlier_valid & im.take(roi, out_y, out_x)

    ud = u_disparity(disparity, valid & roi & ~ground, D)
    strong = ud >= cfg.min_intensity
    same = (torch.roll(strong, 1, -2), torch.roll(strong, -1, -2),
            torch.roll(strong, 1, -1), torch.roll(strong, -1, -1))
    lbl = _flat(connected_components(strong, same,
                                     sweeps=cfg.flood_fill_sweeps))

    def seed_cells(x, y, ok):
        """Feature pixels -> their (d_bin, u) U-disparity cells."""
        dv = im.take(disparity, y, x)
        d = _bins(dv, D)
        return (d * W + x,
                ok & (dv > cfg.min_disparity_raw) & im.take(strong, d, x))

    def comp_of(cells):
        return torch.gather(lbl, -1, cells)

    out_cell, out_cell_ok = seed_cells(out_x, out_y, out_ok)
    inl_cell, inl_cell_ok = seed_cells(inl_x, inl_y, inl_ok)
    n_cells = D * W
    comp_area = _count(n_cells, lbl, _flat(strong).float())
    out_counts = _count(n_cells, comp_of(out_cell), out_cell_ok.int())
    inl_counts = _count(n_cells, comp_of(inl_cell), inl_cell_ok.int())
    moving_comp = ((out_counts >= 1) & (inl_counts < cfg.inlier_tolerance)
                   & (comp_area >= cfg.min_area))

    cell = _flat(_bins(disparity, D) * W
                 + torch.arange(W, device=dev)[None, :])
    moving = (valid & roi & ~ground
              & torch.gather(_flat(strong), -1, cell).reshape(valid.shape)
              & torch.gather(moving_comp, -1, comp_of(cell)).reshape(
                  valid.shape)
              & (disparity > cfg.min_disparity_raw))
    return UVResult(moving_mask=moving, pitch=pitch, horizon_row=b,
                    ground_mask=ground, u_disparity=sigmoid_adjust(ud, cfg),
                    inlier_roi=inl_ok, outlier_roi=out_ok)
