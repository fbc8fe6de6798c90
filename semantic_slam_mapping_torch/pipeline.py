"""The stereo SLAM engine: frames in, tracked and loop-corrected trajectory
out.

Counterpart of the stereo path of
``semantic_slam_mapping_tpu/pipeline.py::SlamSystem``. Per frame, the
frontend (``frontend/tracker.py``) is queued on the card; ``process_stream``
keeps up to ``depth`` frames in flight before the oldest one's host-side
work reads its results. That work (``_postprocess_frame``) reads the pose
back, applies the correction transport, recovers a LOST tracker against the
reference keyframes, and checks the keyframe gate. A keyframe epoch then
runs, in this order:

1. ORB features and their 3-D points from the disparity;
2. the sparse BoW vector;
3. online SegNet labels, when ``cfg.segnet.online`` and the frame brought
   no labels;
4. the keyframe record, its float16 images and labels kept on the card;
5. the harvest of the previous epoch's deferred work;
6. the odometry edge to the previous keyframe;
7. the PnP edges to the nearby keyframes, queued now, harvested next epoch;
8. BoW loop scoring, queued now; the candidates are picked and verified at
   the next epoch (PnP gate, then the quad-match/VO re-measure or the
   reverse PnP) and harvested the epoch after;
9. the pose-graph optimisation when the accumulated chi^2 asks for it,
   with the frontend re-anchor and its PnP refinement;
10. with ``enable_mapping``, the keyframe's camera-frame voxel cloud,
    queued now; its count is read next epoch, its points the epoch after,
    when they go into the voxel map under the rebuild policy;
11. the eviction of old keyframes' device images.

``finish`` drains the deferred work, runs a forced global optimisation and
exports every frame through its keyframe anchor.

RGB-D mode (``SlamSystem(..., rgbd=True)``, fed by ``process_frame_rgbd`` or
``process_stream_rgbd``) runs the same keyframe epoch behind the ORB + PnP
frontend of ``frontend/rgbd_tracker.py``: a frame's depth image takes the
place of its disparity (the keyframe stores it in the disparity slot, its
features take their 3-D points from it, its cloud reads it as depth), no
frame primes a pair buffer, a keyframe has no right image, there is no
moving-object mask, and a loop candidate is verified by the reverse PnP
alone (no quad-match re-measure without a stereo pair).

Throughput mode (``process_window``) runs a window of B stereo pairs as one
batched frontend pass (``tracker.track_frames_batched``), then the host
work above per frame in order; a LOST frame inside the window is
relocalised and the later frames of the window move with it.

Mesh mode (``SlamSystem(..., mesh=make_mesh(...))``, one process a device,
every rank fed the same frames): the window's pairs split over the mesh's
data axis (``parallel/sharded_frontend.py``) and their per-pair results
are all-gathered, so every rank makes the same keyframe decisions; loop
scoring splits the BoW database's rows (``parallel/sharded_bow.py``), the
pose-graph solve the edges (``parallel/sharded_pcg.py``), and the map is
the slab-sharded ``parallel/sharded_map.ShardedGlobalMap``. The host
bookkeeping runs the same on every rank.

Deferred results are copied to pinned host memory behind a CUDA event as
soon as they are queued, and read at the next epoch, so edges land one
epoch late exactly as in the JAX package. The pose graph and the keyframe
poses live on the host in numpy; the images, features and BoW database
live on the device. The JAX package's deliberate deviations from the C++
reference (tiered loop verification, loop information scaled by PnP
inliers, the chi^2 trigger statistic) are kept as they are there.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from semantic_slam_mapping_torch.backend import looper as lp
from semantic_slam_mapping_torch.backend import pnp as pnp_mod
from semantic_slam_mapping_torch.backend import pose_graph as pg
from semantic_slam_mapping_torch.config import (MapperConfig, OrbConfig,
                                                SlamConfig)
from semantic_slam_mapping_torch.device import resolve
from semantic_slam_mapping_torch.frontend import quadmatch, tracker, vo
from semantic_slam_mapping_torch.frontend import rgbd_tracker as rt
from semantic_slam_mapping_torch.geometry import se3_np
from semantic_slam_mapping_torch.geometry.camera import (
    Intrinsics, disparity_to_depth, triangulate_stereo)
from semantic_slam_mapping_torch.mapping import mapper as mp
from semantic_slam_mapping_torch.mapping.native import NativeVoxelMap
from semantic_slam_mapping_torch.models import segnet as segnet_mod
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.ops import orb
from semantic_slam_mapping_torch.parallel import mesh as pmesh
from semantic_slam_mapping_torch.parallel import sharded_bow, sharded_pcg
from semantic_slam_mapping_torch.parallel.sharded_frontend import (
    gather_result, track_frames_sharded)
from semantic_slam_mapping_torch.parallel.sharded_map import ShardedGlobalMap
from semantic_slam_mapping_torch.utils.logging import get_logger
from semantic_slam_mapping_torch.utils.device import to_device
from semantic_slam_mapping_torch.utils.timing import StageTimer, span

log = get_logger("pipeline")

# newest keyframes whose float16 device images stay resident (~3 MB each
# at KITTI size); older ones rebuild from their host copies when a loop
# candidate needs them
_DEV_CACHE_KEYFRAMES = 64


def extract_features(left: torch.Tensor, disparity: torch.Tensor,
                     K: Intrinsics, ocfg: OrbConfig):
    """ORB features of a left image and each feature's camera-frame 3-D
    point from the disparity; returns (features, xyz, valid), valid where
    the feature has a disparity above 0.5 px."""
    feats = orb.extract(left, ocfg)
    d = im.bilinear_sample(disparity, feats.xy)
    xyz = triangulate_stereo(K, feats.xy, torch.clamp(d, min=0.5))
    return feats, xyz, feats.valid & (d > 0.5)


# float32(1/255): XLA folds the JAX package's division of a u8 color by
# 255.0 into a multiply by this constant
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _kf_cloud(disp_f16: torch.Tensor, left_f16: torch.Tensor,
              color: Optional[torch.Tensor], labels: Optional[torch.Tensor],
              moving_mask: Optional[torch.Tensor], K: Intrinsics,
              mcfg: MapperConfig, depth_input: bool = False):
    """Keyframe -> compacted camera-frame voxel cloud, quantized: (int16
    positions in 1/64 m, u8 colors, int8 labels, 0-d int32 count), the
    first ``count`` rows valid. Counterpart of the JAX package's
    ``_kf_cloud_jit``: every ``cloud_stride``-th pixel, depth from the
    float16 disparity with the full-resolution intrinsics, back-projection
    with the intrinsics divided by the stride (in float32), the gray image
    as color when there is none, label 1 where there are no labels.
    ``depth_input``: the disparity slot holds a metric depth image (an
    RGB-D keyframe), taken as it is."""
    st = max(int(mcfg.cloud_stride), 1)
    dev = disp_f16.device
    disp = disp_f16.float()
    if st > 1:
        disp = disp[::st, ::st]
        left_f16 = left_f16[::st, ::st]
        color = color[::st, ::st] if color is not None else None
        labels = labels[::st, ::st] if labels is not None else None
        moving_mask = (moving_mask[::st, ::st] if moving_mask is not None
                       else None)
    # disparities are in full-resolution pixels ...
    depth = disp if depth_input else disparity_to_depth(K, disp)
    if st > 1:
        # ... while the subsampled pixel grid projects with K / stride
        s32 = np.float32(st)
        K = K._replace(**{k: float(np.float32(getattr(K, k)) / s32)
                          for k in ("fx", "fy", "cx", "cy")})
    if color is None:
        color = left_f16.float()[..., None].expand(*disp.shape, 3)
    elif torch.is_floating_point(color):
        color = color.float()
    else:
        # a uint8 [0, 255] keyframe color
        color = color.float() * _INV_255
    if labels is None:
        labels = torch.ones(disp.shape, dtype=torch.int64, device=dev)
    mov = (moving_mask if moving_mask is not None
           else torch.zeros(disp.shape, dtype=torch.bool, device=dev))
    with span("map/points"):
        cloud = mp.generate_point_cloud(depth, color, labels, mov,
                                        torch.eye(4, device=dev), K, mcfg,
                                        budget=mcfg.max_points_per_frame)
    xyz_q = torch.clamp(torch.round(cloud.xyz * 64.0),
                        -32767, 32767).to(torch.int16)
    rgb_q = torch.clamp(torch.round(cloud.rgb * 255.0), 0, 255).to(
        torch.uint8)
    return (xyz_q, rgb_q, cloud.label.to(torch.int8),
            cloud.valid.sum().to(torch.int32))


def _stage_to_host(tensors: Sequence[torch.Tensor]
                   ) -> Callable[[], List[np.ndarray]]:
    """Start copying small device results to pinned host memory as soon as
    they are computed; the returned callable waits for the copies and gives
    numpy arrays. A later harvest thus pays no wait on the device queue."""
    if tensors[0].device.type != "cuda":
        return lambda: [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def read():
        done.synchronize()
        return [h.numpy() for h in host]
    return read


def _dev_img(kf: "Keyframe", attr: str, device: torch.device):
    """Device float16 image of a keyframe, rebuilt from the host copy after
    an eviction."""
    dev = getattr(kf, attr + "_dev", None)
    if dev is None:
        dev = to_device(getattr(kf, attr + "_host"), device).half()
        setattr(kf, attr + "_dev", dev)
    return dev


def _motion_size(d: np.ndarray):
    """(translation norm, rotation angle in rad) of a relative pose."""
    return (float(np.linalg.norm(d[:3, 3])),
            float(np.arccos(np.clip(0.5 * (np.trace(d[:3, :3]) - 1.0),
                                    -1.0, 1.0))))


@dataclasses.dataclass
class Keyframe:
    """Keyframe record. Features, BoW and images live on the device
    (``*_dev``); host copies (``*_host``) are made lazily, when a host
    reader asks or the device copy is evicted."""

    kf_id: int
    frame_index: int
    pose: np.ndarray              # (4, 4) T_w_c
    bow_idx_host: Optional[np.ndarray] = None   # (B,) sorted word ids
    bow_w_host: Optional[np.ndarray] = None     # (B,) tf-idf weights
    bow_dev: Optional[tuple] = None             # (idx, w)
    feat_xy_host: Optional[np.ndarray] = None     # (N, 2)
    feat_desc_host: Optional[np.ndarray] = None   # (N, 256) uint8
    feat_xyz_host: Optional[np.ndarray] = None    # (N, 3) camera frame
    feat_valid_host: Optional[np.ndarray] = None  # (N,)
    feats_dev: Optional[tuple] = None             # (xy, desc, xyz, valid)
    left_host: Optional[np.ndarray] = None        # (H, W) float16
    right_host: Optional[np.ndarray] = None
    disparity_host: Optional[np.ndarray] = None
    left_dev: Optional[torch.Tensor] = None
    right_dev: Optional[torch.Tensor] = None
    disparity_dev: Optional[torch.Tensor] = None
    color: Optional[np.ndarray] = None            # (H, W, 3), for the map
    # labels: given ones stay on the host; online SegNet's stay on the
    # device (an eager readback would wait on the frames in flight)
    semantic_host: Optional[np.ndarray] = None    # (H, W) int8
    semantic_dev: Optional[torch.Tensor] = None

    def _host(self, attr: str) -> Optional[np.ndarray]:
        h = getattr(self, attr + "_host")
        if h is None:
            dev = getattr(self, attr + "_dev")
            if dev is None:
                return None
            h = dev.cpu().numpy()
            setattr(self, attr + "_host", h)
        return h

    @property
    def bow_idx(self) -> Optional[np.ndarray]:
        if self.bow_idx_host is None and self.bow_dev is not None:
            self.bow_idx_host = self.bow_dev[0].cpu().numpy()
        return self.bow_idx_host

    @property
    def bow_w(self) -> Optional[np.ndarray]:
        if self.bow_w_host is None and self.bow_dev is not None:
            self.bow_w_host = self.bow_dev[1].cpu().numpy()
        return self.bow_w_host

    def _feats_host(self, i: int, attr: str) -> Optional[np.ndarray]:
        h = getattr(self, attr + "_host")
        if h is None and self.feats_dev is not None:
            h = self.feats_dev[i].cpu().numpy()
            setattr(self, attr + "_host", h)
        return h

    @property
    def feat_xy(self) -> np.ndarray:
        return self._feats_host(0, "feat_xy")

    @property
    def feat_desc(self) -> np.ndarray:
        return self._feats_host(1, "feat_desc")

    @property
    def feat_xyz(self) -> np.ndarray:
        return self._feats_host(2, "feat_xyz")

    @property
    def feat_valid(self) -> np.ndarray:
        return self._feats_host(3, "feat_valid")

    @property
    def semantic(self) -> Optional[np.ndarray]:
        return self._host("semantic")

    @property
    def left(self) -> np.ndarray:
        return self._host("left")

    @property
    def right(self) -> np.ndarray:
        return self._host("right")

    @property
    def disparity(self) -> np.ndarray:
        return self._host("disparity")

    def feats_on(self, device: torch.device) -> tuple:
        """(xy, desc, xyz, valid) on the device (uploaded if evicted)."""
        if self.feats_dev is not None:
            return self.feats_dev
        return tuple(to_device(a, device) for a in (
            self.feat_xy, self.feat_desc, self.feat_xyz, self.feat_valid))


class FrameLog(NamedTuple):
    """Host copy of one tracked frame's numbers."""

    status: int
    vo_success: bool
    n_matches: int
    n_inliers: int
    n_moving: int      # pixels of the moving-object mask


class SlamSystem:
    """Single-process stereo SLAM engine. ``vocab`` (a
    ``backend.looper.Vocabulary``, e.g. from ``build_vocabulary`` or
    ``load_vocabulary``) turns loop detection on; without it the engine
    keeps odometry and nearby-keyframe edges only. ``enable_mapping``
    builds the semantic voxel map (``self.map``, the C++ map of
    ``mapping/native.py``); ``cfg.segnet.online`` labels keyframes that
    bring no labels with SegNet (``cfg.segnet.weights``, or a network drawn
    from ``seed``). ``rgbd`` selects the RGB-D frontend, fed by
    ``process_frame_rgbd`` and ``process_stream_rgbd``. ``mesh`` (a
    ``parallel.mesh.make_mesh`` over ``device``'s type) runs the mesh mode
    of the module's docstring; the map is then the sharded one."""

    def __init__(self, cfg: SlamConfig,
                 vocab: Optional[lp.Vocabulary] = None, seed: int = 0,
                 enable_mapping: bool = False,
                 device: str | torch.device = "cuda", rgbd: bool = False,
                 mesh=None):
        self.device = resolve(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a system on "
                             f"{self.device}")
        self.mesh = mesh
        self.cfg = cfg
        self.K = Intrinsics.from_config(cfg.camera)
        self.rgbd = rgbd
        self.state = (rt.RgbdTrackerState.initial(
            cfg.orb.n_features, max(1, cfg.tracker.ref_frames), self.device)
            if rgbd else tracker.TrackerState.initial(cfg, self.device))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.vocab = vocab.to(self.device) if vocab is not None else None
        self.keyframes: List[Keyframe] = []
        # the graph lives on the host: insertion is fine-grained mutation;
        # it goes to the device only to be optimised. Worst case per
        # keyframe: 1 odometry + 5 nearby + 5 loop edges; 12 slots each.
        M = cfg.pose_graph.max_keyframes
        E = M * 12
        self.graph = pg.PoseGraph(
            poses=np.broadcast_to(np.eye(4, dtype=np.float32),
                                  (M, 4, 4)).copy(),
            vertex_valid=np.zeros(M, bool),
            edge_i=np.zeros(E, np.int64), edge_j=np.zeros(E, np.int64),
            edge_T=np.broadcast_to(np.eye(4, dtype=np.float32),
                                   (E, 4, 4)).copy(),
            edge_info=np.zeros(E, np.float32),
            edge_valid=np.zeros(E, bool),
            edge_is_loop=np.zeros(E, bool))
        # continuations queued at epoch K, run at epoch K + 1
        self._pending_work: List = []
        # monotone eviction frontier, and keyframes whose device images
        # were rebuilt for a loop candidate and need evicting again
        self._evict_frontier = 0
        self._rebuilt_kfs: dict = {}
        self.n_edges = 0
        self.local_error = 0.0
        self.loop_error = 0.0
        self.trajectory: List[np.ndarray] = []
        # per-frame anchor (kf_id, T_rel): frame pose = kf.pose @ T_rel, so
        # finish() carries every optimisation to the whole trajectory
        self._anchors: List = []
        self.frame_log: List[FrameLog] = []
        self.frame_count = 0
        self.last_result: Optional[tracker.FrameResult] = None
        self.n_loop_edges = 0
        # PnP inliers of the loop candidates that passed the PnP gate, and
        # of the accepted loop edges
        self.loop_candidate_inliers: List[int] = []
        self.loop_edge_inliers: List[int] = []
        # (pnp_inliers, viso_ok, dt_m, dr_deg, dt_rev_m) per candidate
        self.loop_verify_log: List[tuple] = []
        self.n_optimizations = 0
        self.n_global_optimizations = 0
        self.n_local_optimizations = 0
        self.n_recoveries = 0
        self._prev = None            # previous (left, right) device images
        self._last_disparity = None  # disparity of the newest tracked frame
        # dispatch and processing ordinals: a state rewrite while later
        # frames are in flight is composed onto their poses when they are
        # processed. _corrections holds (until_ordinal, C, exact).
        self._dispatched = 0
        self._processed = 0
        self._corrections: List = []
        # the reference keyframes of relocalisation (newest last)
        self.ref_frames: deque = deque(maxlen=max(1, cfg.tracker.ref_frames))
        # the loop BoW database on the device, (cap, B), grown in powers
        # of two; row i is keyframe i
        self._db_idx = None
        self._db_w = None
        self._db_n = 0
        self.timer = StageTimer()
        self.map = None
        self._map_updates = 0
        self._mapped_ids: set = set()
        # kf_id -> host (xyz, rgb, label) of its camera-frame cloud: made
        # once per keyframe, moved by the current pose at each insert
        self._cloud_cache: dict = {}
        if enable_mapping:
            self.map = (ShardedGlobalMap(mesh, cfg.mapper.resolution)
                        if mesh is not None
                        else NativeVoxelMap(cfg.mapper.resolution))
        self._segnet = None
        if cfg.segnet.online:
            if cfg.segnet.weights:
                model, meta = segnet_mod.load_checkpoint(cfg.segnet.weights)
                log.info("segnet weights %s (mIoU %.3f)", cfg.segnet.weights,
                         meta.get("miou", float("nan")))
            else:
                model = segnet_mod.create(
                    cfg.segnet, torch.Generator().manual_seed(seed))
            self._segnet = model.to(self.device)

    # ------------------------------------------------------------------
    def _upload_gray(self, img) -> torch.Tensor:
        """A host float image uploads as uint8 (a quarter of the bytes) and
        becomes float32 in [0, 1] on the device, as u8 * float32(1/255):
        the JAX package's conversion under XLA, to the bit. Tensors and
        integer arrays are taken as they are."""
        if isinstance(img, np.ndarray) and img.dtype in (np.float32,
                                                         np.float64):
            q = torch.from_numpy(
                (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
            if self.device.type == "cuda":
                q = q.pin_memory()
            q = q.to(self.device, non_blocking=True)
            return q.float() * (1.0 / 255.0)
        return to_device(img, self.device).float()

    def _dispatch_frame(self, left, right) -> Optional[tracker.FrameResult]:
        """Queue one frontend step on the device; reads nothing back. The
        very first frame only primes the pair buffer and returns None."""
        left = self._upload_gray(left)
        right = self._upload_gray(right)
        if self._prev is None:
            self._prev = (left, right)
            self.trajectory.append(np.eye(4))
            self._append_anchor(np.eye(4))
            self.frame_count += 1
            return None
        prev_left, prev_right = self._prev
        self.state, out = tracker.track_frame(
            self.state, left, right, prev_left, prev_right, self.K,
            self.generator, self.cfg)
        self._prev = (left, right)
        self._last_disparity = out.disparity
        self._dispatched += 1
        return out

    def _postprocess_frame(self, out: tracker.FrameResult, left, right,
                           color=None, semantic=None) -> None:
        """Host-side per-frame work: the pose and the frame's numbers are
        read back, pending corrections applied, a LOST tracker recovered,
        and the keyframe gate checked."""
        with self.timer.stage("frontend"):
            n_moving = (out.moving_mask.sum() if out.moving_mask is not None
                        else torch.zeros_like(out.n_inliers))
            stats = torch.stack([
                out.status.long(), out.vo_success.long(),
                out.n_matches.long(), out.n_inliers.long(), n_moving.long()])
            with self.timer.stage("sync/poses"):
                pose = out.pose.detach().to("cpu", torch.float64).numpy()
                status, success, n_matches, n_inliers, n_moving = \
                    stats.tolist()
        self._processed += 1
        if self._corrections:
            for until, C, exact in self._corrections:
                if (self._processed == until if exact
                        else self._processed <= until):
                    pose = C @ pose
            self._corrections = [e for e in self._corrections
                                 if e[0] > self._processed]
        self.trajectory.append(pose)
        self._append_anchor(pose)
        self.frame_log.append(FrameLog(status, bool(success), n_matches,
                                       n_inliers, n_moving))
        self.frame_count += 1
        self.last_result = out

        if status == tracker.LOST and self.ref_frames:
            self._lost_recover(left, out.disparity)

        if self._keyframe_due(self.trajectory[-1]):
            self._insert_keyframe(out, self.trajectory[-1], left, right,
                                  color, semantic)

    def process_frame(self, left, right, color=None, semantic=None
                      ) -> Optional[tracker.FrameResult]:
        """Feed one stereo frame, with its color image ((H, W, 3) uint8 or
        float in [0, 1]) and labels ((H, W) class ids) for the map when
        there are any; returns its FrameResult (None for the first frame,
        which only primes the pair buffer)."""
        out = self._dispatch_frame(left, right)
        if out is not None:
            self._postprocess_frame(out, self._prev[0], self._prev[1],
                                    color, semantic)
        return out

    def process_stream(self, frames, depth: int = 6) -> None:
        """Pipelined loop over ``frames`` yielding (left, right[, color[,
        semantic]]) tuples: up to ``depth`` frames are queued on the device
        before the oldest one's host-side work runs, so a keyframe epoch
        overlaps the next frames' frontends. Results equal those of
        process_frame up to the correction transport of a rewrite while
        frames are in flight."""
        self._stream(frames, depth, self._dispatch_frame)

    def _stream(self, frames, depth: int, dispatch) -> None:
        """The pipelined loop of both stream methods: ``dispatch`` queues
        a frame's frontend step (None for a priming frame) and the oldest
        queued frame is post-processed once ``depth`` are in flight. An
        RGB-D keyframe has no right image."""
        pending = deque()
        for item in frames:
            out = dispatch(item[0], item[1])
            if out is not None:
                right = None if self.rgbd else self._prev[1]
                pending.append((out, self._prev[0], right, *item[2:4]))
            while len(pending) > depth:
                self._postprocess_frame(*pending.popleft())
        while pending:
            self._postprocess_frame(*pending.popleft())

    # ------------------------------------------------------------------
    def _dispatch_frame_rgbd(self, gray, depth) -> tracker.FrameResult:
        """Queue one RGB-D frontend step; reads nothing back. The result
        comes as a FrameResult whose disparity is the depth image and
        which has no moving mask and no quad matches."""
        gray = self._upload_gray(gray)
        depth = (to_device(np.asarray(depth, np.float32), self.device)
                 if isinstance(depth, np.ndarray)
                 else to_device(depth, self.device).float())
        self.state, out = rt.track_frame_rgbd(self.state, gray, depth,
                                              self.K, self.cfg)
        self._prev = (gray, depth)
        self._last_disparity = depth
        self._dispatched += 1
        return tracker.FrameResult(
            pose=out.pose, T_delta=out.T_delta, status=out.status,
            n_matches=out.n_matches, n_inliers=out.n_inliers,
            moving_mask=None, disparity=depth, matches=None,
            vo_success=out.success,
            pitch=torch.zeros((), device=self.device))

    def process_frame_rgbd(self, gray, depth, color=None, semantic=None
                           ) -> tracker.FrameResult:
        """Feed one RGB-D frame (gray in [0, 1], metric depth) through the
        whole system; every frame is tracked, the first too."""
        out = self._dispatch_frame_rgbd(gray, depth)
        self._postprocess_frame(out, self._prev[0], None, color, semantic)
        return out

    def process_stream_rgbd(self, frames, depth: int = 6) -> None:
        """Pipelined loop over ``frames`` yielding (gray, depth[, color[,
        semantic]]) tuples, as :meth:`process_stream`."""
        self._stream(frames, depth, self._dispatch_frame_rgbd)

    # ------------------------------------------------------------------
    def _upload_window(self, frames) -> torch.Tensor:
        """(B+1, H, W) frames to the device as float32, as they are (the
        JAX package's ``process_window`` takes them so, unquantised)."""
        if isinstance(frames, torch.Tensor):
            return frames.to(self.device, torch.float32)
        t = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _window_picks(self, n_valid: torch.Tensor) -> Optional[torch.Tensor]:
        """The RANSAC samples of a window's pairs, given their (B,) counts
        of valid matches: None draws them from the generator. A test
        replays the JAX package's keys through it, as through
        :meth:`_loop_vo`."""
        return None

    def process_window(self, lefts, rights, colors=None, semantics=None
                       ) -> tracker.FrameResult:
        """Throughput mode: feed B+1 consecutive frames ((B+1, H, W) each,
        grey in [0, 1]); the B pairs (i-1, i) run as one batched frontend
        pass on the device, then the keyframe and backend work runs per
        frame on the host. Consecutive windows overlap by one frame: the
        next window starts with this one's last (``lefts[4:9]`` after
        ``lefts[:5]``). ``colors`` and ``semantics``, when given, hold the
        B+1 frames' color images and labels for the map. Returns the
        batched FrameResult (fields with a leading B)."""
        lefts = self._upload_window(lefts)
        rights = self._upload_window(rights)
        B = lefts.shape[0] - 1
        if self._prev is None:
            self.trajectory.append(np.eye(4))
            self.frame_count += 1
            self._append_anchor(np.eye(4))
        with self.timer.stage("window"):
            if self.mesh is not None:
                self.state, out = track_frames_sharded(
                    self.state, lefts, rights, self.K, self.generator,
                    self.cfg, self.mesh, picks=self._window_picks)
                out = gather_result(out, self.mesh)
            else:
                self.state, out = tracker.track_frames_batched(
                    self.state, lefts, rights, self.K, self.generator,
                    self.cfg, picks=self._window_picks)
        self._prev = (lefts[-1], rights[-1])
        self._last_disparity = out.disparity[-1]
        self._dispatched += B
        self._processed += B
        with self.timer.stage("frontend"):
            stats = torch.stack([
                out.status.long(), out.vo_success.long(),
                out.n_matches.long(), out.n_inliers.long(),
                out.moving_mask.sum(dim=(-2, -1)).long()])
            with self.timer.stage("sync/poses"):
                poses = out.pose.detach().to("cpu", torch.float64).numpy()
                statuses, success, n_matches, n_inliers, n_moving = \
                    stats.tolist()
        # a frame relocalised inside the window corrects the later ones,
        # which were integrated from its lost pose
        C = np.eye(4)
        corrected = False
        for i in range(B):
            with span("frame/host"):
                pose_i = (C @ poses[i]) if corrected else poses[i]
                self.trajectory.append(pose_i)
                self._append_anchor(pose_i)
                self.frame_log.append(FrameLog(statuses[i], bool(success[i]),
                                               n_matches[i], n_inliers[i],
                                               n_moving[i]))
                self.frame_count += 1
                if statuses[i] == tracker.LOST and self.ref_frames:
                    rec = self._relocalize(lefts[i + 1], out.disparity[i],
                                           pose_i)
                    if rec is None:
                        ref = self.ref_frames[-1]
                        new_pose = ref.pose.astype(np.float64)
                        log.info("lost: re-seeded at keyframe %d pose",
                                 ref.kf_id)
                    else:
                        new_pose, ref = rec
                        log.info("relocalized against keyframe %d", ref.kf_id)
                    self.n_recoveries += 1
                    self._rewrite_last(new_pose, anchor_kf=ref)
                    self.ref_frames.clear()
                    self.ref_frames.append(ref)
                    C = new_pose @ np.linalg.inv(poses[i])
                    corrected = True
                    pose_i = new_pose
                single = tracker.FrameResult(
                    pose=to_device(pose_i.astype(np.float32), self.device),
                    T_delta=out.T_delta[i], status=out.status[i],
                    n_matches=out.n_matches[i], n_inliers=out.n_inliers[i],
                    moving_mask=out.moving_mask[i], disparity=out.disparity[i],
                    matches=vo.QuadMatches(*(x[i] for x in out.matches)),
                    vo_success=out.vo_success[i], pitch=out.pitch[i])
                self.last_result = single
                if self._keyframe_due(pose_i):
                    self._insert_keyframe(
                        single, pose_i, lefts[i + 1], rights[i + 1],
                        colors[i + 1] if colors is not None else None,
                        semantics[i + 1] if semantics is not None else None)
        if corrected:
            # the live tracker state moves by the window's correction
            self._adjust_state(C @ self._state_pose())
        return out

    # ------------------------------------------------------------------
    def _adjust_state(self, new_pose: np.ndarray):
        """Rewrite the tracker's pose (status OK, lost count 0); the RGB-D
        tracker also moves its world-frame reference points."""
        adjust = rt.adjust if self.rgbd else tracker.adjust
        self.state = adjust(self.state, to_device(
            np.asarray(new_pose, np.float32), self.device))

    def _state_pose(self) -> np.ndarray:
        with self.timer.stage("sync/state_pose"):
            return self.state.pose.detach().to("cpu", torch.float64).numpy()

    def _append_anchor(self, pose: np.ndarray):
        if self.keyframes:
            kf = self.keyframes[-1]
            self._anchors.append(
                (kf.kf_id, np.linalg.inv(kf.pose) @ pose))
        else:
            self._anchors.append((-1, pose.copy()))

    def _rewrite_last(self, pose: np.ndarray, anchor_kf=None):
        """Rewrite the newest trajectory entry and its anchor relation."""
        self.trajectory[-1] = np.asarray(pose)
        if anchor_kf is not None:
            self._anchors[-1] = (anchor_kf.kf_id,
                                 np.linalg.inv(anchor_kf.pose) @ pose)
        elif self.keyframes:
            kf = self.keyframes[-1]
            self._anchors[-1] = (kf.kf_id, np.linalg.inv(kf.pose) @ pose)

    def _keyframe_due(self, pose) -> bool:
        """The first frame; then translation > keyframe_min_translation or
        rotation > keyframe_min_rotation relative to the last keyframe."""
        if not self.keyframes:
            return True
        rel = np.linalg.inv(self.keyframes[-1].pose) @ np.asarray(pose)
        dt, dr = _motion_size(rel)
        return (dt > self.cfg.pose_graph.keyframe_min_translation
                or dr > self.cfg.pose_graph.keyframe_min_rotation)

    def _extract_features(self, left, disparity):
        """``disparity`` is the depth image in RGB-D mode."""
        fn = rt.features_with_depth if self.rgbd else extract_features
        return fn(left, disparity, self.K, self.cfg.orb)

    # ------------------------------------------------------------------
    def _insert_keyframe(self, out, pose, left, right, color=None,
                         semantic=None):
        cfg = self.cfg
        kf_id = len(self.keyframes)
        if kf_id >= cfg.pose_graph.max_keyframes:
            log.warning("keyframe budget exhausted; dropping keyframe")
            return
        with self.timer.stage("kf/features"):
            feats, xyz, feat_valid = self._extract_features(
                left, out.disparity)
        with self.timer.stage("kf/bow"):
            bow = (lp.transform_sparse(self.vocab, feats.desc, feats.valid,
                                       cfg.looper.scoring_level,
                                       budget=cfg.looper.bow_budget)
                   if self.vocab is not None else None)
        if semantic is None and self._segnet is not None:
            with self.timer.stage("kf/segnet"):
                semantic = self._run_segnet(left, color)
        with self.timer.stage("kf/store"):
            kf = self._store_keyframe(out, pose, left, right, color,
                                      semantic, kf_id, feats, xyz,
                                      feat_valid, bow)

        # the previous epoch's deferred work first: its device programs
        # have finished behind the frontends by now
        with self.timer.stage("kf/harvest"):
            self._drain_pending()

        if kf_id > 0:
            prev = self.keyframes[kf_id - 1]
            self._add_edge(kf_id - 1, kf_id,
                           np.linalg.inv(prev.pose) @ kf.pose, is_loop=False)

            lo = max(0, kf_id - 1 - cfg.pose_graph.nearby_keyframes)
            refs = self.keyframes[lo:kf_id - 1]
            if refs:
                with self.timer.stage("kf/nearby_edges"):
                    self._pending_work.append(
                        self._dispatch_edges(refs, kf, is_loop=False))

            if self.vocab is not None:
                with self.timer.stage("kf/loops"):
                    self._try_loops(kf)

            with self.timer.stage("kf/optimize"):
                self._maybe_optimize()

        # every keyframe is mapped, the first too: the cloud is queued now,
        # the readback and the map insert are deferred
        if self.map is not None:
            with self.timer.stage("kf/map"):
                self._dispatch_map_update(kf, out)

        # keep the newest _DEV_CACHE_KEYFRAMES keyframes' device copies;
        # older ones (and rebuilt loop candidates) go to the host
        hi = len(self.keyframes) - _DEV_CACHE_KEYFRAMES
        stale = self.keyframes[self._evict_frontier:hi] if hi > 0 else []
        self._evict_frontier = max(self._evict_frontier, hi)
        rebuilt = [k for i, k in self._rebuilt_kfs.items()
                   if i < max(hi, 0)]
        self._rebuilt_kfs = {i: k for i, k in self._rebuilt_kfs.items()
                             if i >= max(hi, 0)}
        for old in stale + rebuilt:
            if old.left_dev is None and old.feats_dev is None:
                continue
            with self.timer.stage("sync/evict"):
                old._host("left"), old._host("right"), old._host("disparity")
                old._host("semantic")
                for i, a in enumerate(("feat_xy", "feat_desc",
                                       "feat_xyz", "feat_valid")):
                    old._feats_host(i, a)
            old.left_dev = old.right_dev = old.disparity_dev = None
            old.semantic_dev = None
            old.feats_dev = None

    def _store_keyframe(self, out, pose, left, right, color, semantic,
                        kf_id, feats, xyz, feat_valid, bow) -> Keyframe:
        with self.timer.stage("store/readback"):
            kf = self._build_keyframe(out, pose, left, right, color,
                                      semantic, kf_id, feats, xyz,
                                      feat_valid, bow)
        self.keyframes.append(kf)
        self.ref_frames.append(kf)
        if self._anchors:
            self._anchors[-1] = (kf_id, np.eye(4))  # this frame IS the kf
        self.graph.poses[kf_id] = kf.pose
        self.graph.vertex_valid[kf_id] = True
        return kf

    def _build_keyframe(self, out, pose, left, right, color, semantic,
                        kf_id, feats, xyz, feat_valid, bow) -> Keyframe:
        on_host = isinstance(semantic, np.ndarray)
        return Keyframe(
            kf_id=kf_id, frame_index=self.frame_count - 1,
            pose=np.asarray(pose, np.float32),
            bow_dev=(bow.idx, bow.w) if bow is not None else None,
            feats_dev=(feats.xy, feats.desc, xyz, feat_valid),
            left_dev=left.half(),
            right_dev=right.half() if right is not None else None,
            disparity_dev=out.disparity.half(),
            color=np.asarray(color) if color is not None else None,
            semantic_host=semantic.astype(np.int8) if on_host else None,
            semantic_dev=(semantic.to(self.device, torch.int8)
                          if semantic is not None and not on_host
                          else None))

    # ------------------------------------------------------------------
    def _add_edge(self, i, j, T_rel, is_loop, chi2=0.0, info=None):
        e = self.n_edges
        if e >= self.graph.edge_T.shape[0]:
            log.warning("edge budget exhausted; dropping edge")
            return
        self.graph.edge_i[e] = i
        self.graph.edge_j[e] = j
        self.graph.edge_T[e] = np.asarray(T_rel, np.float32)
        self.graph.edge_info[e] = (
            info if info is not None
            else self.cfg.pose_graph.information_weight)
        self.graph.edge_valid[e] = True
        self.graph.edge_is_loop[e] = is_loop
        self.n_edges += 1
        if is_loop:
            self.loop_error += chi2
            self.n_loop_edges += 1
        else:
            self.local_error += chi2

    def _drain_pending(self):
        """Run the continuations queued by the previous epoch; one that
        returns a callable queues it for the next drain."""
        work, self._pending_work = self._pending_work, []
        for fn in work:
            nxt = fn()
            if callable(nxt):
                self._pending_work.append(nxt)

    def _drain_all(self):
        while self._pending_work:
            self._drain_pending()

    def _dev_img_tracked(self, kf: Keyframe, attr: str):
        """_dev_img, recording a rebuilt keyframe for re-eviction."""
        rebuilt = getattr(kf, attr + "_dev", None) is None
        dev = _dev_img(kf, attr, self.device)
        if rebuilt:
            self._rebuilt_kfs[kf.kf_id] = kf
        return dev

    def _try_edges_batched(self, refs, kf: Keyframe, is_loop: bool) -> int:
        """Dispatch the batched edge work and harvest it at once."""
        return self._dispatch_edges(refs, kf, is_loop)()

    def _loop_vo(self, m: vo.QuadMatches) -> vo.VoResult:
        """The loop re-measure's RANSAC + GN motion for a batch of
        candidates ((n, N) matches, one row a candidate), solved in one
        batched call; each candidate's samples are drawn from the generator
        in turn. Pairwise: each candidate's pose has the bits of its own
        unbatched solve, since a loop edge takes it as its measurement and
        an epoch's later PnP gates can turn on its last bit. A test replays
        the JAX package's samples through it."""
        n_valid = m.valid.sum(dim=-1)
        picks = torch.stack([
            vo._distinct3(self.generator, n_valid[c],
                          self.cfg.vo.ransac_iters)
            for c in range(n_valid.shape[0])])
        return vo.estimate_motion(m, self.K, None, self.cfg.vo, picks=picks,
                                  pairwise=True)

    def _dispatch_edges(self, refs, kf: Keyframe, is_loop: bool):
        """Queue the edge work against up to nearby_keyframes reference
        keyframes, padded to that count: one batched PnP gate and, for loop
        candidates, the quad-match/VO re-measure and the reverse PnP.
        Returns the harvest: it reads the staged results, decides which
        edges exist, inserts them and returns how many it added."""
        cfg, dev = self.cfg, self.device
        nb = cfg.pose_graph.nearby_keyframes
        refs = refs[:nb]
        n = len(refs)
        pick = refs + [refs[0]] * (nb - n)
        ref_valid = np.arange(nb) < n

        with self.timer.stage("edges/stack"):
            ref_feats = [r.feats_on(dev) for r in pick]
            xy_r, desc_r, xyz_r, val_r = (torch.stack(x)
                                          for x in zip(*ref_feats))
            if is_loop and not self.rgbd:
                left_r = [self._dev_img_tracked(r, "left").float()
                          for r in refs]
                right_r = [self._dev_img_tracked(r, "right").float()
                           for r in refs]
            T_init = to_device(np.stack(
                [np.linalg.inv(np.linalg.inv(r.pose) @ kf.pose)
                 .astype(np.float32) for r in pick]), dev)
            kf_xy, kf_desc, kf_xyz, kf_val = kf.feats_on(dev)

        with self.timer.stage("edges/pnp"):
            infos = pnp_mod.solve_pnp_lazy(
                desc_r, xyz_r, val_r, kf_desc, kf_xy, kf_val, self.K,
                T_init, cfg.pnp, cfg.orb.knn_match_ratio)

        # loop candidates only: the quad-match/VO re-measure, its KLT legs
        # seeded by the image flow the PnP solution implies for a mid-depth
        # principal-ray point (loop pairs revisit from an offset lane)
        staged = [infos.success, infos.n_inliers, infos.T]
        if is_loop and self.rgbd:
            with self.timer.stage("edges/revpnp"):
                # no stereo pair: the reverse PnP (kf's 3D against each
                # candidate's 2D) is the only check, started from the
                # graph's relative pose
                T_init_rev = to_device(np.stack(
                    [(np.linalg.inv(r.pose) @ kf.pose).astype(np.float32)
                     for r in pick]), dev)
                res_rev = pnp_mod.solve_pnp_lazy(
                    kf_desc, kf_xyz, kf_val, desc_r, xy_r, val_r, self.K,
                    T_init_rev, cfg.pnp, cfg.orb.knn_match_ratio)
            staged += [res_rev.success, res_rev.T]
        elif is_loop:
            with self.timer.stage("edges/viso"):
                kf_left = self._dev_img_tracked(kf, "left").float()
                kf_right = self._dev_img_tracked(kf, "right").float()
                z_nom = 0.5 * cfg.camera.roiz
                # infos.T maps ref-cam -> kf-cam; the legs track kf -> ref
                R_ = infos.T[:, :3, :3].transpose(1, 2)
                t_ = -torch.einsum("nij,nj->ni", R_, infos.T[:, :3, 3])
                Xp = R_[:, :, 2] * z_nom + t_
                z_ = torch.clamp(Xp[:, 2], min=1e-3)
                priors = torch.stack([self.K.fx * Xp[:, 0] / z_,
                                      self.K.fy * Xp[:, 1] / z_], dim=-1)
                priors = torch.where(infos.success[:, None], priors, 0.0)
                # the real candidates only, as one batch: a padding slot's
                # result is never read
                res = self._loop_vo(quadmatch.quad_match(
                    cur_left=kf_left.expand(n, -1, -1),
                    cur_right=kf_right.expand(n, -1, -1),
                    prev_left=torch.stack(left_r),
                    prev_right=torch.stack(right_r),
                    qcfg=cfg.quadmatch, gcfg=cfg.gftt, kcfg=cfg.klt,
                    flow_prior=priors[:n]))
                viso_success = torch.cat(
                    [res.success, res.success[:1].expand(nb - n)])
                viso_T = torch.cat(
                    [res.T_delta, res.T_delta[:1].expand(nb - n, 4, 4)])
            with self.timer.stage("edges/revpnp"):
                # the reverse PnP (kf's 3D against each candidate's 2D),
                # started from the forward solution's inverse
                Rt_f = infos.T[:, :3, :3].transpose(1, 2)
                T_init_rev = torch.zeros_like(infos.T)
                T_init_rev[:, :3, :3] = Rt_f
                T_init_rev[:, :3, 3] = -torch.einsum(
                    "nij,nj->ni", Rt_f, infos.T[:, :3, 3])
                T_init_rev[:, 3, 3] = 1.0
                res_rev = pnp_mod.solve_pnp_lazy(
                    kf_desc, kf_xyz, kf_val, desc_r, xy_r, val_r, self.K,
                    T_init_rev, cfg.pnp, cfg.orb.knn_match_ratio)
            staged += [viso_success, viso_T, res_rev.success, res_rev.T]
        read = _stage_to_host(staged)

        def harvest() -> int:
            with self.timer.stage("edges/readback"):
                with self.timer.stage("sync/edges"):
                    vals = read()
                ok = vals[0] & ref_valid
                pnp_inl = vals[1]
                T_pnp = se3_np.inverse(vals[2].astype(np.float64))
                if is_loop and self.rgbd:
                    # the reverse PnP takes the re-measure's place; it
                    # solves kf-cam -> ref-cam directly
                    viso_ok = vals[3]
                    T_viso = vals[4].astype(np.float64)
                elif is_loop:
                    viso_ok = vals[3]
                    T_viso = se3_np.inverse(vals[4].astype(np.float64))
                    rev_ok = vals[5]
                    # the reverse PnP solves kf-cam -> ref-cam directly
                    T_rev = vals[6].astype(np.float64)
            added = 0
            pgc = self.cfg.pose_graph
            for i in range(n):
                if not ok[i]:
                    continue
                if is_loop:
                    self.loop_candidate_inliers.append(int(pnp_inl[i]))
                ref = refs[i]
                use_viso = use_rev = False
                dt = dr = dt_rev = float("nan")
                if is_loop and viso_ok[i]:
                    dt, dr = _motion_size(
                        np.linalg.inv(T_viso[i]) @ T_pnp[i])
                    use_viso = dt < 0.5 and dr < np.radians(3.0)
                if is_loop and not self.rgbd and rev_ok[i]:
                    dt_rev, dr_rev = _motion_size(
                        np.linalg.inv(T_rev[i]) @ T_pnp[i])
                    use_rev = dt_rev < 0.5 and dr_rev < np.radians(3.0)
                if is_loop:
                    self.loop_verify_log.append(
                        (int(pnp_inl[i]), bool(viso_ok[i]), dt,
                         float(np.degrees(dr)), dt_rev))
                # a loop edge needs an independent check that agrees with
                # the PnP pose (< 0.5 m, < 3 deg) and the inlier floor
                if is_loop and not ((use_viso or use_rev)
                                    and pnp_inl[i] >= pgc.loop_min_inliers):
                    continue
                T_rel = T_viso[i] if use_viso else T_pnp[i]
                T_odo = np.linalg.inv(ref.pose) @ kf.pose
                # the trigger statistic: the se3-log discrepancy between
                # the measurement and the odometry chain, at the uniform
                # reference weight
                r = se3_np.log(np.linalg.inv(T_rel) @ T_odo)
                info = (pgc.information_weight if is_loop
                        else pgc.nearby_information_weight)
                chi2 = float(info * (r @ r))
                if is_loop and pgc.info_from_inliers:
                    s = min(float(pnp_inl[i]) / pgc.info_full_inliers,
                            1.0) ** 2
                    info = info * max(s, pgc.info_min_scale)
                self._add_edge(ref.kf_id, kf.kf_id, T_rel, is_loop, chi2,
                               info=info)
                if is_loop:
                    self.loop_edge_inliers.append(int(pnp_inl[i]))
                added += 1
            return added

        return harvest

    # ------------------------------------------------------------------
    def _bow_db_sync(self):
        """Append the keyframes not yet in the device BoW database."""
        while self._db_n < len(self.keyframes):
            k = self.keyframes[self._db_n]
            bi, bw = (k.bow_dev if k.bow_dev is not None
                      else (to_device(k.bow_idx, self.device),
                            to_device(k.bow_w, self.device)))
            if self._db_idx is None:
                cap = 64
                self._db_idx = torch.full((cap,) + bi.shape, lp.PAD_WORD,
                                          dtype=bi.dtype, device=self.device)
                self._db_w = torch.zeros((cap,) + bw.shape,
                                         device=self.device)
            if self._db_n == self._db_idx.shape[0]:   # grow x2
                self._db_idx = torch.cat(
                    [self._db_idx, torch.full_like(self._db_idx, 2 ** 30)])
                self._db_w = torch.cat(
                    [self._db_w, torch.zeros_like(self._db_w)])
            self._db_idx[self._db_n] = bi
            self._db_w[self._db_n] = bw
            self._db_n += 1

    def _try_loops(self, kf: Keyframe):
        """Queue BoW scoring now; the next epoch picks the best-scoring
        candidates (at most nearby_keyframes) and queues their
        verification, harvested the epoch after."""
        cfg = self.cfg.looper
        if len(self.keyframes) <= 1:
            return
        self._bow_db_sync()
        cap = self._db_idx.shape[0]
        n = self._db_n
        # row i is keyframe i; the query's own row is excluded by the
        # frame-gap gate, padding rows by db_valid
        ids = np.zeros(cap, np.int64)
        ids[:n] = [k.frame_index for k in self.keyframes[:n]]
        db_valid = np.arange(cap) < n
        with self.timer.stage("loops/score"):
            ids, db_valid = (to_device(ids, self.device),
                             to_device(db_valid, self.device))
            # under a mesh the rows split over the data axis when they
            # divide by it (the capacity is a power of two)
            if (self.mesh is not None
                    and cap % pmesh.axis_size(self.mesh) == 0):
                scores_dev, mask_dev = \
                    sharded_bow.get_possible_loops_sparse_sharded(
                        *kf.bow_dev, self._db_idx, self._db_w, ids,
                        db_valid, kf.frame_index, self.mesh,
                        cfg.min_sim_score, cfg.min_interval)
            else:
                scores_dev, mask_dev = lp.get_possible_loops_sparse(
                    lp.SparseBow(*kf.bow_dev), self._db_idx, self._db_w,
                    ids, db_valid, kf.frame_index, cfg.min_sim_score,
                    cfg.min_interval)
        read = _stage_to_host([scores_dev, mask_dev])

        def pick_and_dispatch():
            with self.timer.stage("sync/loops"):
                scores, mask = read()
            # the best-scoring candidates, at most the nearby budget
            idx = np.nonzero(mask)[0]
            nb = self.cfg.pose_graph.nearby_keyframes
            idx = idx[np.argsort(-scores[idx])[:nb]]
            cand = [self.keyframes[int(i)] for i in idx]
            if not cand:
                return None
            with self.timer.stage("loops/verify_dispatch"):
                harvest = self._dispatch_edges(cand, kf, is_loop=True)

            def harvest_loops():
                added = harvest()
                if added:
                    log.info("%d loop edge(s) -> kf %d", added, kf.kf_id)
            return harvest_loops

        self._pending_work.append(pick_and_dispatch)

    # ------------------------------------------------------------------
    def _maybe_optimize(self, force_global: bool = False):
        """Optimise the graph when the accumulated chi^2 asks for it
        (global over the loop error, else local), then re-anchor the
        frontend on the newest keyframe."""
        cfg = self.cfg.pose_graph
        n = len(self.keyframes)
        did = False

        def solve(mask_of, iters):
            # the live region, in power-of-two buckets
            nv, ne = 64, 128
            while nv < n:
                nv *= 2
            while ne < self.n_edges:
                ne *= 2
            nv = min(nv, self.graph.poses.shape[0])
            ne = min(ne, self.graph.edge_T.shape[0])
            host = pg.PoseGraph(
                self.graph.poses[:nv], self.graph.vertex_valid[:nv],
                self.graph.edge_i[:ne], self.graph.edge_j[:ne],
                self.graph.edge_T[:ne], self.graph.edge_info[:ne],
                self.graph.edge_valid[:ne], self.graph.edge_is_loop[:ne])
            g = pg.PoseGraph(*(to_device(a, self.device) for a in host))
            if self.mesh is not None:
                # the edges split over the mesh's data axis
                g = sharded_pcg.optimize_sharded(g, mask_of(g), self.mesh,
                                                 cfg, iters=iters)
            else:
                table = pg.vertex_edge_table(host.edge_i, host.edge_j,
                                             host.edge_valid, nv)
                g = pg.optimize(g, mask_of(g), cfg, iters=iters,
                                table=table)
            with self.timer.stage("sync/optimize"):
                self.graph.poses[:nv] = g.poses.cpu().numpy()

        if force_global or self.loop_error > cfg.loop_accumulate_error:
            # the solve ends in a readback, so the stage is its wall time
            with self.timer.stage("optimize/global"):
                solve(pg.global_free_mask, cfg.global_iters)
            self.loop_error = 0.0
            self.local_error = 0.0
            did = True
            self.n_global_optimizations += 1
            log.info("global optimization over %d keyframes", n)
        elif self.local_error > cfg.local_accumulate_error:
            solve(lambda g: pg.local_free_mask(g, n, cfg.local_window), 5)
            self.local_error = 0.0
            did = True
            self.n_local_optimizations += 1
            log.info("local optimization (last %d of %d keyframes)",
                     cfg.local_window, n)
        if did:
            self.n_optimizations += 1
            pre_opt = self.keyframes[-1].pose.copy()
            poses = self.graph.poses[:n]
            for i, kfr in enumerate(self.keyframes):
                kfr.pose = poses[i]
            self._adjust_frontend(self.keyframes[-1], pre_opt)

    # ------------------------------------------------------------------
    def _pnp_to_ref(self, ref: Keyframe, left, disparity,
                    T_init: np.ndarray):
        """PnP the live frame against a reference keyframe; returns the new
        T_w_c or None."""
        feats, _, _ = self._extract_features(left, disparity)
        _, r_desc, r_xyz, r_val = ref.feats_on(self.device)
        info = pnp_mod.solve_pnp_lazy(
            r_desc, r_xyz, r_val, feats.desc, feats.xy, feats.valid,
            self.K, to_device(T_init.astype(np.float32), self.device),
            self.cfg.pnp, self.cfg.orb.knn_match_ratio)
        with self.timer.stage("sync/pnp_ref"):
            if not bool(info.success):
                return None
            T = info.T.detach().to("cpu", torch.float64).numpy()
        # info.T maps ref-camera coordinates to current-camera ones
        return ref.pose @ np.linalg.inv(T)

    def _adjust_frontend(self, ref: Keyframe, ref_pose_pre_opt: np.ndarray):
        """Re-anchor the frontend on the optimised reference keyframe and
        reset the reference deque to it. The newest trajectory entry is the
        keyframe's own frame and takes its optimised pose; the live tracker
        state, which may be ahead of it, gets the optimisation's
        correction, refined by PnP against the keyframe when the live frame
        is past it."""
        self._rewrite_last(ref.pose.astype(np.float64), anchor_kf=ref)
        cur_pose = self._state_pose()
        C = ref.pose.astype(np.float64) @ np.linalg.inv(
            ref_pose_pre_opt.astype(np.float64))
        new_pose = C @ cur_pose
        # in-flight frames get the pure optimisation transport; the PnP
        # refinement is specific to the newest dispatched frame
        self._note_correction(C)
        live_is_ref = np.allclose(cur_pose, ref_pose_pre_opt, atol=1e-5)
        if not live_is_ref and self._prev is not None \
                and self._last_disparity is not None:
            refined = self._pnp_to_ref(
                ref, self._prev[0], self._last_disparity,
                np.linalg.inv(new_pose) @ ref.pose)
            if refined is not None:
                self._note_correction(refined @ np.linalg.inv(new_pose),
                                      exact=True)
                new_pose = refined
        self._adjust_state(new_pose)
        self.ref_frames.clear()
        self.ref_frames.append(ref)

    def _relocalize(self, left, disparity, cur_pose):
        """PnP the live frame against the reference keyframes, newest
        first; returns (new_pose, ref) or None."""
        cur_pose = np.asarray(cur_pose, np.float64)
        for ref in reversed(self.ref_frames):
            T_init = np.linalg.inv(cur_pose) @ ref.pose
            new_pose = self._pnp_to_ref(ref, left, disparity, T_init)
            if new_pose is not None:
                return new_pose, ref
        return None

    def _lost_recover(self, left, disparity) -> bool:
        """Relocalise a LOST frame against the reference keyframes; when
        every one fails, re-seed at the newest one's pose."""
        old_pose = np.asarray(self.trajectory[-1], np.float64)
        rec = self._relocalize(left, disparity, old_pose)
        if rec is not None:
            new_pose, ref = rec
            found = True
            log.info("relocalized against keyframe %d", ref.kf_id)
        else:
            ref = self.ref_frames[-1]
            new_pose = ref.pose.astype(np.float64)
            found = False
            log.info("lost: re-seeded at keyframe %d pose", ref.kf_id)
        # the live state may be ahead of the recovered frame: compose
        C = new_pose @ np.linalg.inv(old_pose)
        self._adjust_state(C @ self._state_pose())
        self._note_correction(C)
        self._rewrite_last(new_pose, anchor_kf=ref)
        self.n_recoveries += 1
        return found

    def _note_correction(self, C: np.ndarray, exact: bool = False):
        """Register a correction for the frames in flight (their poses came
        from the pre-rewrite state); ``exact`` applies it to the newest
        dispatched frame only."""
        if self._dispatched > self._processed:
            self._corrections.append((self._dispatched, np.asarray(C),
                                      exact))

    # ------------------------------------------------------------------
    def _run_segnet(self, left: torch.Tensor, color=None) -> torch.Tensor:
        """Online labels of one keyframe, (H, W) int64 on the device: the
        color image (uint8 [0, 255] or float [0, 1]; the gray image when
        there is none) resized with antialiasing to the input size padded
        to a multiple of 32, the network and its argmax, then a nearest
        resize back (interpolating class ids would invent classes)."""
        dev = self.device
        if color is not None:
            img = to_device(color, dev)
            if torch.is_floating_point(img):
                img = img.float()
            else:
                # a true division on every device (a Python-float divisor
                # becomes a reciprocal multiply on the card)
                img = img.float() / torch.full((), 255.0, device=dev)
        else:
            img = left.float()[..., None].expand(*left.shape, 3)
        H0, W0 = img.shape[:2]
        h = -(-self.cfg.segnet.input_height // 32) * 32
        w = -(-self.cfg.segnet.input_width // 32) * 32
        x = im.resize_bilinear(img.permute(2, 0, 1), (h, w)).permute(1, 2, 0)
        labels = segnet_mod.infer(self._segnet, x[None])[0]
        return im.resize_nearest(labels[None], (H0, W0))[0]

    # ------------------------------------------------------------------
    def _dispatch_kf_cloud(self, kf: Keyframe, moving_mask=None):
        """Queue this keyframe's camera-frame voxel cloud (pose-free, so it
        is made once and moved by the current pose at each insert) and
        stage its count to the host. Returns a two-stage continuation: the
        first reads the count and stages the next power-of-two prefix of
        the quantized arrays (at least 256 rows), the second reads them
        into ``_cloud_cache[kf_id]``."""
        dev = self.device
        color = to_device(kf.color, dev) if kf.color is not None else None
        # online SegNet's labels are on the device already
        sem = (kf.semantic_dev if kf.semantic_dev is not None
               else kf.semantic_host)
        labels = None
        if sem is not None:
            labels = (sem if isinstance(sem, torch.Tensor)
                      else to_device(sem, dev)).long()
        xyz_q, rgb_q, lbl_q, n_dev = _kf_cloud(
            _dev_img(kf, "disparity", dev), _dev_img(kf, "left", dev),
            color, labels, moving_mask, self.K, self.cfg.mapper,
            depth_input=self.rgbd)
        read_n = _stage_to_host([n_dev])

        def stage2():
            with self.timer.stage("sync/map_count"):
                n = int(read_n()[0])
            L = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 8)
            L = min(L, self.cfg.mapper.max_points_per_frame)
            read = _stage_to_host([xyz_q[:L], rgb_q[:L], lbl_q[:L]])

            def stage3():
                with self.timer.stage("sync/map"):
                    xq, rq, lq = read()
                self._cloud_cache[kf.kf_id] = (
                    xq[:n].astype(np.float32) / 64.0,
                    rq[:n].astype(np.float32) / 255.0,
                    lq[:n].astype(np.int32))
            return stage3
        return stage2

    def _kf_cloud_camera(self, kf: Keyframe, moving_mask=None):
        """The camera-frame cloud made and read at once (a keyframe mapped
        before its deferred cloud landed, e.g. after a resume)."""
        stage = self._dispatch_kf_cloud(kf, moving_mask)
        while callable(stage):
            stage = stage()
        return self._cloud_cache[kf.kf_id]

    def _dispatch_map_update(self, kf: Keyframe, out):
        """Queue the cloud now; its count is read at the next epoch, and the
        epoch after reads the points and runs the map update, two epochs
        after the keyframe as in the JAX package."""
        with self.timer.stage("map/cloud"):
            stage2 = self._dispatch_kf_cloud(kf, out.moving_mask)

        def s2():
            stage3 = stage2()

            def s3():
                with self.timer.stage("map/readback"):
                    stage3()
                with self.timer.stage("map/update"):
                    self._update_map(kf)
            return s3
        self._pending_work.append(s2)

    def _insert_kf_into_map(self, kf: Keyframe, moving_mask=None):
        if kf.kf_id not in self._cloud_cache:
            with self.timer.stage("map/cloud_sync"):
                self._kf_cloud_camera(kf, moving_mask)
        xyz_c, rgb, lbl = self._cloud_cache[kf.kf_id]
        R, t = kf.pose[:3, :3], kf.pose[:3, 3]
        with span("map/insert"):
            self.map.insert(xyz_c @ R.T.astype(np.float32) +
                            t.astype(np.float32), rgb, lbl)

    def _update_map(self, kf: Keyframe):
        """The map's update policy: every ``full_rebuild_every``-th update a
        full rebuild from every ``full_rebuild_stride``-th keyframe (their
        poses may have moved), else the keyframes of the last
        ``incremental_window`` not yet mapped. Only keyframes up to ``kf``
        take part: newer ones have their own updates in flight."""
        cfg = self.cfg.mapper
        done = self.keyframes[:kf.kf_id + 1]
        self._map_updates += 1
        if self._map_updates % cfg.full_rebuild_every == 0:
            self.map.clear()
            self._mapped_ids = set()
            for k in done[::cfg.full_rebuild_stride]:
                self._insert_kf_into_map(k)
                self._mapped_ids.add(k.kf_id)
        else:
            for k in done[-cfg.incremental_window:]:
                if k.kf_id in self._mapped_ids:
                    continue
                self._insert_kf_into_map(k)
                self._mapped_ids.add(k.kf_id)
        log.info("map: %d voxels after update %d", len(self.map),
                 self._map_updates)

    # ------------------------------------------------------------------
    def finish(self) -> np.ndarray:
        """Drain the deferred work, run a forced global optimisation, and
        export every frame through its keyframe anchor: (F, 4, 4)."""
        self._drain_all()
        if len(self.keyframes) > 1:
            self._maybe_optimize(force_global=True)
        traj = []
        for pose, (kf_id, T_rel) in zip(self.trajectory, self._anchors):
            traj.append(pose if kf_id < 0
                        else self.keyframes[kf_id].pose @ T_rel)
        return np.stack(traj)

    # ------------------------------------------------------------------
    def save_g2o(self, path: str):
        """Write the graph as VERTEX_SE3:QUAT and EDGE_SE3:QUAT lines, each
        edge with its own information (the upper triangle of a diagonal 6x6
        block), so that reading it back gives the same problem."""
        with open(path, "w") as f:
            for kf in self.keyframes:
                q = se3_np.rotation_to_quaternion(kf.pose[:3, :3])
                t = kf.pose[:3, 3]
                f.write(f"VERTEX_SE3:QUAT {kf.kf_id} "
                        f"{t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n")
            ne = self.n_edges
            ei, ej = self.graph.edge_i[:ne], self.graph.edge_j[:ne]
            eT, ew = self.graph.edge_T[:ne], self.graph.edge_info[:ne]
            for i in range(ne):
                q = se3_np.rotation_to_quaternion(eT[i, :3, :3])
                t = eT[i, :3, 3]
                info_upper = " ".join(
                    repr(float(ew[i])) if r == c else "0.0"
                    for r in range(6) for c in range(r, 6))
                f.write(f"EDGE_SE3:QUAT {ei[i]} {ej[i]} "
                        f"{t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]} "
                        f"{info_upper}\n")


def load_g2o(path: str) -> dict:
    """Read a file of :meth:`SlamSystem.save_g2o` back: ``vertex_ids``
    (V,), ``poses`` (V, 4, 4), ``edge_i`` and ``edge_j`` (E,), ``edge_T``
    (E, 4, 4) and ``edge_info`` (E,), the [0, 0] entry of each 6x6
    information block."""
    vid, poses = [], []
    ei, ej, eT, ew = [], [], [], []

    def pose(vals):
        tx, ty, tz, qx, qy, qz, qw = (float(v) for v in vals)
        T = np.eye(4)
        T[:3, :3] = se3_np.quaternion_to_rotation(
            np.array([qw, qx, qy, qz]))
        T[:3, 3] = (tx, ty, tz)
        return T

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VERTEX_SE3:QUAT":
                vid.append(int(parts[1]))
                poses.append(pose(parts[2:9]))
            elif parts[0] == "EDGE_SE3:QUAT":
                ei.append(int(parts[1]))
                ej.append(int(parts[2]))
                eT.append(pose(parts[3:10]))
                ew.append(float(parts[10]))
    return dict(vertex_ids=np.array(vid, np.int32),
                poses=np.stack(poses) if poses else np.zeros((0, 4, 4)),
                edge_i=np.array(ei, np.int32), edge_j=np.array(ej, np.int32),
                edge_T=np.stack(eT) if eT else np.zeros((0, 4, 4)),
                edge_info=np.array(ew, np.float64))
