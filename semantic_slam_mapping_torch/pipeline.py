"""The SLAM engine, frontend part: frames in, tracked trajectory out.

Counterpart of the stereo frontend of
``semantic_slam_mapping_tpu/pipeline.py::SlamSystem``: ``_upload_gray``,
``_dispatch_frame``, ``process_frame`` and the pipelined
``process_stream``. Frame N + 1's frontend is queued on the device before
frame N's host-side work reads its results, up to ``depth`` frames ahead.

The keyframe epoch that hangs off ``_postprocess_frame`` in the JAX
package (keyframe gate, ORB, PnP, loop closure, pose graph, map, lost
recovery to a reference keyframe and the correction transport) is not
ported yet: here ``_postprocess_frame`` appends the pose to the trajectory
and logs the frame's tracking numbers.
"""

from __future__ import annotations

from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from semantic_slam_mapping_torch.config import SlamConfig
from semantic_slam_mapping_torch.device import resolve
from semantic_slam_mapping_torch.frontend import tracker
from semantic_slam_mapping_torch.geometry.camera import Intrinsics


class FrameLog(NamedTuple):
    """Host copy of one tracked frame's numbers."""

    status: int
    vo_success: bool
    n_matches: int
    n_inliers: int
    n_moving: int      # pixels of the moving-object mask


class SlamSystem:
    """Single-process stereo SLAM engine (frontend only, for now)."""

    def __init__(self, cfg: SlamConfig, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve(device)
        self.cfg = cfg
        self.K = Intrinsics.from_config(cfg.camera)
        self.state = tracker.TrackerState.initial(cfg, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.trajectory: List[np.ndarray] = []
        self.frame_log: List[FrameLog] = []
        self.frame_count = 0
        self.last_result: Optional[tracker.FrameResult] = None
        self._prev = None  # previous (left, right) device images

    def _upload_gray(self, img) -> torch.Tensor:
        """A host float image uploads as uint8 (a quarter of the bytes) and
        becomes float32 in [0, 1] on the device; exact for images read from
        8-bit files. Tensors and integer arrays are taken as they are."""
        if isinstance(img, np.ndarray) and img.dtype in (np.float32,
                                                         np.float64):
            q = torch.from_numpy(
                (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
            if self.device.type == "cuda":
                q = q.pin_memory()
            return q.to(self.device, non_blocking=True).float() / 255.0
        return torch.as_tensor(img).to(self.device, torch.float32)

    def _dispatch_frame(self, left, right) -> Optional[tracker.FrameResult]:
        """Queue one frontend step on the device; reads nothing back. The
        very first frame only primes the pair buffer and returns None."""
        left = self._upload_gray(left)
        right = self._upload_gray(right)
        if self._prev is None:
            self._prev = (left, right)
            self.trajectory.append(np.eye(4))
            self.frame_count += 1
            return None
        prev_left, prev_right = self._prev
        self.state, out = tracker.track_frame(
            self.state, left, right, prev_left, prev_right, self.K,
            self.generator, self.cfg)
        self._prev = (left, right)
        return out

    def _postprocess_frame(self, out: tracker.FrameResult) -> None:
        """Host-side per-frame work: read the pose and the frame's numbers
        back and append them."""
        pose = out.pose.detach().to("cpu", torch.float64).numpy()
        status, success, n_matches, n_inliers, n_moving = torch.stack([
            out.status.long(), out.vo_success.long(), out.n_matches.long(),
            out.n_inliers.long(), out.moving_mask.sum()]).tolist()
        self.trajectory.append(pose)
        self.frame_log.append(FrameLog(status, bool(success), n_matches,
                                       n_inliers, n_moving))
        self.frame_count += 1
        self.last_result = out

    def process_frame(self, left, right) -> Optional[tracker.FrameResult]:
        """Feed one stereo frame; returns its FrameResult (None for the
        first frame, which only primes the pair buffer)."""
        out = self._dispatch_frame(left, right)
        if out is not None:
            self._postprocess_frame(out)
        return out

    def process_stream(self, frames, depth: int = 6) -> None:
        """Pipelined loop over ``frames`` yielding (left, right, ...)
        tuples: up to ``depth`` frames are queued on the device before the
        oldest one's results are read back. Results equal those of
        process_frame."""
        pending = deque()
        for item in frames:
            out = self._dispatch_frame(item[0], item[1])
            if out is not None:
                pending.append(out)
            while len(pending) > depth:
                self._postprocess_frame(pending.popleft())
        while pending:
            self._postprocess_frame(pending.popleft())
