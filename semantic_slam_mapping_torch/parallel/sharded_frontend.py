"""The window frontend with its frame pairs split over the mesh.

Counterpart of ``semantic_slam_mapping_tpu/parallel/sharded_frontend.py``.
Every rank holds the window's B+1 frames; rank r of the data axis's n runs
SGBM (the K1 kernel on the card), quad matching, RANSAC VO and the
U-V-disparity pass on pairs [r B/n, (r+1) B/n), and ``window_core`` walks
the two sequential recurrences (the pitch Kalman filter, the pose chain)
on the all-gathered per-pair scalars and 4x4s: O(B) numbers of
collective traffic a window against the images' work.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from semantic_slam_mapping_torch.config import SlamConfig
from semantic_slam_mapping_torch.frontend import tracker, vo
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.parallel import mesh as pmesh


def track_frames_sharded(state: tracker.TrackerState, lefts: torch.Tensor,
                         rights: torch.Tensor, K: Intrinsics,
                         generator: Optional[torch.Generator],
                         cfg: SlamConfig, mesh: DeviceMesh,
                         picks: Union[torch.Tensor, Callable, None] = None
                         ) -> Tuple[tracker.TrackerState,
                                    tracker.FrameResult]:
    """``track_frames_batched`` over the mesh's data axis. lefts, rights:
    (B+1, H, W) on every rank, B a multiple of the axis's size; ``picks``
    as there, for the whole window. The state and the result's ``pose``
    and ``status`` cover the window; its other fields (disparity, moving
    mask, matches, ...) this rank's pairs (:func:`gather_result` brings
    them all)."""
    n = pmesh.axis_size(mesh)
    B = lefts.shape[0] - 1
    if B % n:
        raise ValueError(f"a window of {B} pairs does not split over {n} "
                         "ranks")
    r = pmesh.axis_index(mesh)
    part = slice(r * (B // n), (r + 1) * (B // n))
    return tracker.window_core(
        state, lefts[1:][part], rights[1:][part], lefts[:-1][part],
        rights[:-1][part], K, generator, cfg, picks,
        group=pmesh.axis_group(mesh))


def gather_result(out: tracker.FrameResult, mesh: DeviceMesh
                  ) -> tracker.FrameResult:
    """The per-pair fields of every rank's block, all-gathered in pair
    order: the whole window's FrameResult on every rank."""
    group = pmesh.axis_group(mesh)
    g = lambda x: pmesh.all_gather(x, group)          # noqa: E731
    return out._replace(
        T_delta=g(out.T_delta), n_matches=g(out.n_matches),
        n_inliers=g(out.n_inliers), moving_mask=g(out.moving_mask),
        disparity=g(out.disparity),
        matches=vo.QuadMatches(*(g(x) for x in out.matches)),
        vo_success=g(out.vo_success), pitch=g(out.pitch))
