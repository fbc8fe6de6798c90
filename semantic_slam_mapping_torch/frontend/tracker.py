"""Tracking frontend: one step of the stereo VO state machine per frame.

Counterpart of ``track_frame``, ``adjust`` and ``lost_recover`` of
``semantic_slam_mapping_tpu/frontend/tracker.py``. A step is SGBM
disparity, quad matching seeded by the disparity and a constant-velocity
flow prior, RANSAC + GN motion, dense triangulation with the Kalman-smoothed
ground pitch, the U-disparity moving mask, and pose integration. The state
is a tuple of tensors that stays on the device; nothing in a step reads a
value back to the host.

``track_frames_batched`` (over ``window_core``) is the throughput mode: a
window of B frame pairs runs every per-frame stage once on a leading batch
dimension, and only the pitch Kalman filter and the pose state machine
walk the B results in order. Given a process group, ``window_core`` runs
one rank's block of the window's pairs (``parallel/sharded_frontend.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from semantic_slam_mapping_torch.config import SlamConfig
from semantic_slam_mapping_torch.frontend import quadmatch, vo
from semantic_slam_mapping_torch.frontend import uvdisparity as uvd
from semantic_slam_mapping_torch.geometry import se3
from semantic_slam_mapping_torch.geometry import stereo as gstereo
from semantic_slam_mapping_torch.geometry.camera import Intrinsics, project
from semantic_slam_mapping_torch.ops import sgbm
from semantic_slam_mapping_torch.parallel.mesh import all_gather

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

    new_pose, new_velocity, new_lost, new_status = _integrate(
        state, res.T_delta, res.success, cfg)

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


def _integrate(state: TrackerState, T_delta: torch.Tensor,
               success: torch.Tensor, cfg: SlamConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The pose state machine of one frame: success integrates
    pose inv(T_delta), failure predicts at constant velocity. Returns
    (pose, velocity, lost count, status)."""
    first = state.status == NOT_READY
    pose_ok = se3.compose(state.pose, se3.inverse(T_delta))
    pose_pred = se3.compose(state.pose, se3.inverse(state.velocity))
    new_pose = se3.orthonormalize(torch.where(success, pose_ok, pose_pred))
    new_velocity = torch.where(success, T_delta, state.velocity)
    new_lost = torch.where(success | first, 0, state.lost_count + 1).int()
    new_status = torch.where(new_lost > cfg.tracker.max_lost_frames,
                             LOST, OK).int()
    return new_pose, new_velocity, new_lost, new_status


def window_core(state: TrackerState,
                cur_l: torch.Tensor, cur_r: torch.Tensor,
                prev_l: torch.Tensor, prev_r: torch.Tensor,
                K: Intrinsics, generator: Optional[torch.Generator],
                cfg: SlamConfig, picks: Union[torch.Tensor, Callable,
                                              None] = None,
                group=None) -> Tuple[TrackerState, FrameResult]:
    """The frontend over B frame pairs, already split into current and
    previous (B, H, W) images. SGBM, quad matching, RANSAC VO, the pitch
    measurement and the U-disparity pass each run once over the batch;
    the temporal KLT legs of every pair are seeded from the window-entry
    velocity; the pitch Kalman filter, then the pose state machine, walk
    the B results in order. ``picks``: optional (B, R, 3) RANSAC samples,
    or a function of the pairs' (B,) valid-match counts that returns them
    or None; None draws them from ``generator``, (B, R, 3) uniforms at
    once. Returns the final state and a FrameResult whose fields have a
    leading B.

    With a process ``group`` of n ranks (the JAX body's ``axis_name``),
    the images are this rank's block of a window of n*B pairs, the rank's
    index times B on: the per-pair stages run on the block, the pitch
    measurements, motions and successes are all-gathered, and both
    recurrences walk the whole window on every rank. ``picks`` (or the
    function's argument, the gathered counts) then covers the whole
    window, and the generator draws the whole window's uniforms, of which
    the rank keeps its rows: every rank's generator stays in step, and the
    samples are those of one device's window. The state, ``pose`` and
    ``status`` cover the whole window; the other fields the block."""
    B_local = cur_l.shape[0]
    if group is None:
        gather = lambda x: x                          # noqa: E731
        lo, B = 0, B_local
    else:
        gather = lambda x: all_gather(x, group)      # noqa: E731
        lo = dist.get_rank(group) * B_local
        B = dist.get_world_size(group) * B_local
    sg = sgbm.compute(cur_l, cur_r, cfg.sgbm)
    disparity = torch.where(sg.valid, sg.disparity, 0.0)

    fp = _velocity_flow_prior(state.velocity, K, cfg)
    m = quadmatch.quad_match(
        cur_left=cur_l, cur_right=cur_r, prev_left=prev_l,
        prev_right=prev_r, qcfg=cfg.quadmatch, gcfg=cfg.gftt,
        kcfg=cfg.klt, cur_disparity=disparity, flow_prior=fp)

    n_valid = m.valid.sum(dim=-1)
    if callable(picks):
        picks = picks(gather(n_valid))
    if picks is None:
        u = torch.rand((B, cfg.vo.ransac_iters, 3), generator=generator,
                       device=cur_l.device)
        picks = vo.distinct3_from_uniform(u[lo:lo + B_local], n_valid)
    elif group is not None:
        picks = picks[lo:lo + B_local]
    res = vo.estimate_motion(m, K, generator, cfg.vo, picks=picks)

    # the pitch is measured per frame; the Kalman filter is sequential
    pts = gstereo.triangulate_image(K, disparity, cfg.camera)
    pitch_meas, line_a, line_b = uvd.measure_pitch(
        disparity, sg.valid, pts.roi, K, cfg.sgbm.num_disparities,
        cfg.uvdisparity)
    meas = gather(pitch_meas)
    kf = state.pitch_kf
    smooth = []
    for i in range(B):
        kf = uvd.pitch_kalman_update(kf, meas[i:i + 1], cfg.uvdisparity)
        smooth.append(kf.x[0])
    pts_c = gstereo.correct_pitch(
        pts, torch.stack(smooth)[lo:lo + B_local], cfg.camera)
    uv_res = uvd.detect_moving_objects(
        disparity, sg.valid, pts_c.roi,
        m.lc, m.valid & res.inliers, m.lc, m.valid & ~res.inliers, K,
        num_disparities=cfg.sgbm.num_disparities, cfg=cfg.uvdisparity,
        line_ab=(line_a, line_b))

    T_delta, success = gather(res.T_delta), gather(res.success)
    poses, statuses = [], []
    for i in range(B):
        pose, velocity, lost, status = _integrate(
            state, T_delta[i], success[i], cfg)
        state = state._replace(status=status, pose=pose, velocity=velocity,
                               lost_count=lost,
                               frame_index=state.frame_index + 1)
        poses.append(pose)
        statuses.append(status)
    state = state._replace(pitch_kf=kf)
    out = FrameResult(
        pose=torch.stack(poses), T_delta=res.T_delta,
        status=torch.stack(statuses), n_matches=n_valid,
        n_inliers=res.n_inliers, moving_mask=uv_res.moving_mask,
        disparity=disparity, matches=m, vo_success=res.success,
        pitch=uv_res.pitch)
    return state, out


def track_frames_batched(state: TrackerState, lefts: torch.Tensor,
                         rights: torch.Tensor, K: Intrinsics,
                         generator: Optional[torch.Generator],
                         cfg: SlamConfig,
                         picks: Union[torch.Tensor, Callable, None] = None
                         ) -> Tuple[TrackerState, FrameResult]:
    """Throughput mode: (B+1, H, W) consecutive frames give the results of
    the B pairs (i-1, i), as one batched pass (see :func:`window_core`)."""
    return window_core(state, lefts[1:], rights[1:], lefts[:-1],
                       rights[:-1], K, generator, cfg, picks)


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
