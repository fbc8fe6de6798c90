"""RGB-D (TUM) tracking frontend: ORB matching against a ring of reference
frames and one pooled PnP solve per frame.

Counterpart of ``semantic_slam_mapping_tpu/frontend/rgbd_tracker.py``.
The state holds R reference slots of N features (descriptors, pixels and
world-frame 3-D points). A step extracts ORB, takes each feature's depth
from the depth image, matches the current descriptors against all R slots
as one batch, and solves one PnP over the pooled R*N correspondences
(world points against current pixels, so the solve gives the camera's
world pose directly). A frame that succeeds, and the first frame, are
pushed into the ring; a failed frame is not. The state stays on the device
and a step reads nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from semantic_slam_mapping_torch.backend import pnp as pnp_mod
from semantic_slam_mapping_torch.config import OrbConfig, SlamConfig
from semantic_slam_mapping_torch.geometry import se3
from semantic_slam_mapping_torch.geometry.camera import Intrinsics, backproject
from semantic_slam_mapping_torch.ops import matching, orb
from semantic_slam_mapping_torch.ops.image import bilinear_sample

NOT_READY = 0
OK = 1
LOST = 2


class RgbdTrackerState(NamedTuple):
    status: torch.Tensor       # int32 scalar
    pose: torch.Tensor         # (4, 4) T_w_c
    velocity: torch.Tensor     # (4, 4) last frame-to-frame motion
    lost_count: torch.Tensor   # int32 scalar
    frame_index: torch.Tensor  # int32 scalar
    # the reference ring: R slots of N features, 3-D points in the world
    # frame so that the pooled correspondences share one pose
    ref_desc: torch.Tensor     # (R, N, 256) uint8
    ref_xy: torch.Tensor       # (R, N, 2)
    ref_xyz_w: torch.Tensor    # (R, N, 3)
    ref_valid: torch.Tensor    # (R, N) bool
    ref_ptr: torch.Tensor      # int32: the next slot to write

    @classmethod
    def initial(cls, n_features: int, ref_frames: int = 5,
                device: str | torch.device = "cuda") -> "RgbdTrackerState":
        i32 = lambda v: torch.full((), v, dtype=torch.int32, device=device)  # noqa: E731
        shape = (ref_frames, n_features)
        return cls(status=i32(NOT_READY), pose=se3.identity(device=device),
                   velocity=se3.identity(device=device), lost_count=i32(0),
                   frame_index=i32(0),
                   ref_desc=torch.zeros(shape + (orb.DESC_BITS,),
                                        dtype=torch.uint8, device=device),
                   ref_xy=torch.zeros(shape + (2,), device=device),
                   ref_xyz_w=torch.zeros(shape + (3,), device=device),
                   ref_valid=torch.zeros(shape, dtype=torch.bool,
                                         device=device),
                   ref_ptr=i32(0))


class RgbdFrameResult(NamedTuple):
    pose: torch.Tensor
    T_delta: torch.Tensor
    status: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    success: torch.Tensor


def features_with_depth(gray: torch.Tensor, depth: torch.Tensor,
                        K: Intrinsics, ocfg: OrbConfig):
    """ORB features of a gray image and each feature's camera-frame 3-D
    point from the metric depth image, sampled bilinearly; returns
    (features, xyz, valid), valid where the depth lies in (0.05, 50) m."""
    feats = orb.extract(gray, ocfg)
    d = bilinear_sample(depth, feats.xy)
    xyz = backproject(K, feats.xy, torch.clamp(d, min=0.05))
    return feats, xyz, feats.valid & (d > 0.05) & (d < 50.0)


def track_frame_rgbd(state: RgbdTrackerState, gray: torch.Tensor,
                     depth: torch.Tensor, K: Intrinsics, cfg: SlamConfig
                     ) -> Tuple[RgbdTrackerState, RgbdFrameResult]:
    """One step on an (H, W) gray image in [0, 1] and its metric depth."""
    feats, xyz_cam, feat_valid3d = features_with_depth(gray, depth, K,
                                                       cfg.orb)

    # the current features against every reference slot, as one batch
    m = matching.match_descriptors(state.ref_desc, feats.desc,
                                   state.ref_valid, feats.valid,
                                   ratio=cfg.orb.knn_match_ratio)
    idx = torch.clamp(m.idx, 0, feats.xy.shape[0] - 1)
    obj = state.ref_xyz_w.reshape(-1, 3)
    img = feats.xy[idx].reshape(-1, 2)
    pair_valid = (m.valid & state.ref_valid).reshape(-1)
    n_matches = pair_valid.sum()

    # one PnP over the pooled set; obj is in the world frame, so the
    # solved transform is T_cur<-world and the pose its inverse
    pose_pred = se3.compose(state.pose, se3.inverse(state.velocity))
    res = pnp_mod.solve_pnp(obj, img, pair_valid, K, se3.inverse(pose_pred),
                            cfg.pnp)
    success = (res.success & (n_matches >= cfg.pnp.min_matches)
               & (res.n_inliers >= cfg.pnp.min_inliers))

    first = state.status == NOT_READY
    ok = success & ~first
    hold = torch.where(first, state.pose, pose_pred)
    new_pose = se3.orthonormalize(torch.where(ok, se3.inverse(res.T), hold))
    # prev -> cur motion in the stereo tracker's convention
    T_delta = se3.compose(se3.inverse(new_pose), state.pose)
    new_velocity = torch.where(ok, T_delta, state.velocity)
    new_lost = torch.where(ok | first, 0, state.lost_count + 1).int()
    new_status = torch.where(new_lost > cfg.tracker.max_lost_frames,
                             LOST, OK).int()

    # push the frame into the ring when it succeeded or is the first
    push = ok | first
    slot = (state.ref_ptr % state.ref_desc.shape[0]).long()[None]

    def ins(buf, row):
        return torch.where(push, buf.index_copy(0, slot, row[None]), buf)

    new_state = RgbdTrackerState(
        status=new_status, pose=new_pose, velocity=new_velocity,
        lost_count=new_lost, frame_index=state.frame_index + 1,
        ref_desc=ins(state.ref_desc, feats.desc),
        ref_xy=ins(state.ref_xy, feats.xy),
        ref_xyz_w=ins(state.ref_xyz_w,
                      se3.transform_points(new_pose, xyz_cam)),
        ref_valid=ins(state.ref_valid, feat_valid3d),
        ref_ptr=torch.where(push, state.ref_ptr + 1, state.ref_ptr))
    out = RgbdFrameResult(pose=new_pose, T_delta=T_delta, status=new_status,
                          n_matches=n_matches, n_inliers=res.n_inliers,
                          success=success)
    return new_state, out


def adjust(state: RgbdTrackerState, new_pose: torch.Tensor
           ) -> RgbdTrackerState:
    """Rewrite the pose after a backend correction. The ring's points are
    in the world frame and the next PnP is absolute against them, so they
    move by the same correction C = new_pose inv(old pose)."""
    dev = state.pose.device
    new_pose = se3.orthonormalize(new_pose.to(dev, torch.float32))
    C = se3.compose(new_pose, se3.inverse(state.pose))
    pts = se3.transform_points(C, state.ref_xyz_w.reshape(-1, 3))
    return state._replace(
        pose=new_pose, ref_xyz_w=pts.reshape(state.ref_xyz_w.shape),
        lost_count=torch.zeros((), dtype=torch.int32, device=dev),
        status=torch.full((), OK, dtype=torch.int32, device=dev))
