"""Tracking frontend: one step of the stereo VO state machine per frame.

Counterpart of ``track_frame``, ``adjust`` and ``lost_recover`` of
``semantic_slam_mapping_tpu/frontend/tracker.py``. A step is SGBM
disparity, quad matching seeded by the disparity and a constant-velocity
flow prior, RANSAC + GN motion, dense triangulation with the Kalman-smoothed
ground pitch, the U-disparity moving mask, and pose integration. The state
is a tuple of tensors that stays on the device; nothing in a step reads a
value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from semantic_slam_mapping_torch.config import SlamConfig
from semantic_slam_mapping_torch.frontend import quadmatch, vo
from semantic_slam_mapping_torch.frontend import uvdisparity as uvd
from semantic_slam_mapping_torch.geometry import se3
from semantic_slam_mapping_torch.geometry import stereo as gstereo
from semantic_slam_mapping_torch.geometry.camera import Intrinsics, project
from semantic_slam_mapping_torch.ops import sgbm

NOT_READY = 0
OK = 1
LOST = 2


def _velocity_flow_prior(velocity: torch.Tensor, K: Intrinsics,
                         cfg: SlamConfig) -> torch.Tensor:
    """Image flow of a mid-depth point on the principal ray under the
    inverse of the last inter-frame motion (seeds the temporal KLT legs)."""
    Xc = torch.tensor([[0.0, 0.0, 0.5 * cfg.camera.roiz]],
                      device=velocity.device)
    Xp = se3.transform_points(se3.inverse(velocity), Xc)
    return project(K, Xp)[0] - torch.tensor([K.cx, K.cy],
                                            device=velocity.device)


class TrackerState(NamedTuple):
    status: torch.Tensor       # int32 scalar
    pose: torch.Tensor         # (4, 4) T_w_c camera-to-world
    velocity: torch.Tensor     # (4, 4) last inter-frame motion (prev->cur)
    lost_count: torch.Tensor   # int32 scalar
    pitch_kf: uvd.PitchKalmanState
    frame_index: torch.Tensor  # int32 scalar

    @classmethod
    def initial(cls, cfg: Optional[SlamConfig] = None,
                device: str | torch.device = "cuda") -> "TrackerState":
        p0 = cfg.uvdisparity.kf_error_cov_post if cfg is not None else 1.0
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
        return cls(status=i32(NOT_READY), pose=se3.identity(device=device),
                   velocity=se3.identity(device=device), lost_count=i32(0),
                   pitch_kf=uvd.PitchKalmanState.init(p0, device),
                   frame_index=i32(0))


class FrameResult(NamedTuple):
    pose: torch.Tensor         # (4, 4) world pose after this frame
    T_delta: torch.Tensor      # (4, 4) estimated inter-frame motion
    status: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    moving_mask: torch.Tensor  # (H, W) bool
    disparity: torch.Tensor    # (H, W)
    matches: vo.QuadMatches
    vo_success: torch.Tensor
    pitch: torch.Tensor


def track_frame(state: TrackerState,
                cur_left: torch.Tensor, cur_right: torch.Tensor,
                prev_left: torch.Tensor, prev_right: torch.Tensor,
                K: Intrinsics, generator: Optional[torch.Generator],
                cfg: SlamConfig) -> Tuple[TrackerState, FrameResult]:
    """One frontend step on (H, W) images in [0, 1]; RANSAC samples come
    from ``generator``."""
    sg = sgbm.compute(cur_left, cur_right, cfg.sgbm)
    disparity = torch.where(sg.valid, sg.disparity, 0.0)

    m = quadmatch.quad_match(
        cur_left=cur_left, cur_right=cur_right,
        prev_left=prev_left, prev_right=prev_right,
        qcfg=cfg.quadmatch, gcfg=cfg.gftt, kcfg=cfg.klt,
        cur_disparity=disparity,
        flow_prior=_velocity_flow_prior(state.velocity, K, cfg))

    res = vo.estimate_motion(m, K, generator, cfg.vo)

    # measure the pitch, smooth it, rotate the points by the smoothed
    # pitch, re-filter the ROI, then segment the U-disparity
    pts = gstereo.triangulate_image(K, disparity, cfg.camera)
    pitch_meas, line_a, line_b = uvd.measure_pitch(
        disparity, sg.valid, pts.roi, K, cfg.sgbm.num_disparities,
        cfg.uvdisparity)
    kf = uvd.pitch_kalman_update(state.pitch_kf, pitch_meas[None],
                                 cfg.uvdisparity)
    pts_c = gstereo.correct_pitch(pts, kf.x[0], cfg.camera)
    uv_res = uvd.detect_moving_objects(
        disparity, sg.valid, pts_c.roi,
        m.lc, m.valid & res.inliers, m.lc, m.valid & ~res.inliers, K,
        num_disparities=cfg.sgbm.num_disparities, cfg=cfg.uvdisparity,
        line_ab=(line_a, line_b))

    # success: pose <- pose inv(T_delta); failure: constant velocity
    first = state.status == NOT_READY
    ok = res.success
    pose_ok = se3.compose(state.pose, se3.inverse(res.T_delta))
    pose_pred = se3.compose(state.pose, se3.inverse(state.velocity))
    new_pose = se3.orthonormalize(torch.where(ok, pose_ok, pose_pred))
    new_velocity = torch.where(ok, res.T_delta, state.velocity)
    new_lost = torch.where(ok | first, 0, state.lost_count + 1).int()
    new_status = torch.where(new_lost > cfg.tracker.max_lost_frames,
                             LOST, OK).int()

    new_state = TrackerState(
        status=new_status, pose=new_pose, velocity=new_velocity,
        lost_count=new_lost, pitch_kf=kf,
        frame_index=state.frame_index + 1)
    out = FrameResult(
        pose=new_pose, T_delta=res.T_delta, status=new_status,
        n_matches=m.valid.sum(), n_inliers=res.n_inliers,
        moving_mask=uv_res.moving_mask, disparity=disparity, matches=m,
        vo_success=res.success, pitch=uv_res.pitch)
    return new_state, out


def adjust(state: TrackerState, new_pose: torch.Tensor) -> TrackerState:
    """Rewrite the frontend pose (after a pose-graph optimisation)."""
    dev = state.pose.device
    return state._replace(
        pose=se3.orthonormalize(new_pose.to(dev, torch.float32)),
        lost_count=torch.tensor(0, dtype=torch.int32, device=dev),
        status=torch.tensor(OK, dtype=torch.int32, device=dev))


def lost_recover(state: TrackerState,
                 last_good_pose: torch.Tensor) -> TrackerState:
    """Re-seed at the last reference pose."""
    return adjust(state, last_good_pose)
