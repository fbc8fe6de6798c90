"""Command-line entry points of the port, with the JAX package's
sub-commands, arguments, defaults, printed lines and output files
(``python -m semantic_slam_mapping_torch.cli <command> ...``):

  slam         stereo SLAM on a KITTI sequence
  tracker      the same without loop closure
  rgbd         ORB + PnP tracking on a TUM sequence
  pnp          frame-to-frame PnP odometry on a KITTI sequence
  segnet       offline SegNet labels of a sequence
  synth        a synthetic street with exact ground truth
  make-vocab   a BoW vocabulary from a sequence
  read-frames  a dataset reader probe
  match-orb    a consecutive-frame ORB matching probe
  train-segnet SegNet trained on synthetic rendered views (segnet.pkl)

Every command takes ``--device`` (default ``cuda``): it runs on the card
and raises when there is none; ``--device cpu`` runs the plain PyTorch
path on the CPU (the tests use it). Accuracy is printed as one JSON line
of ATE and RPE whenever ground truth is given.

Differences from the JAX package's ``cli.py``: ``synth`` draws its world
from a ``torch.Generator`` seeded 0 (the JAX package draws from
``jax.random.PRNGKey(0)``, which torch cannot replay), so its street is
another one; the JAX package's persistent XLA compilation cache has no
counterpart (nothing here is compiled per shape); ``train-segnet`` draws
its batches from torch generators seeded as the JAX package seeds its keys
(other batches, the same families), and with ``--mesh`` runs one process
a device, started by torchrun (``torchrun --nproc-per-node N -m
semantic_slam_mapping_torch.cli train-segnet --mesh ...``; NCCL between
cards, gloo with ``--device cpu``) or alone as a world of one, where JAX
shards one process over its local devices; rank 0 alone prints and writes
``segnet.pkl``; ``segnet --checkpoint`` reads the pickle with
``models/segnet.load_checkpoint`` (the network of the pickle's own width
and dtype); a trajectory plot's caption is a PNG text chunk, not drawn
(``utils/plot.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

# the JAX package's shipped SegNet checkpoint, read by path when it exists
_SHIPPED_SEGNET = (Path(__file__).resolve().parents[1]
                   / "semantic_slam_mapping_tpu" / "models" / "weights"
                   / "segnet.pkl")


def _load_cfg(args):
    from semantic_slam_mapping_torch.config import (default_config,
                                                    load_parameters_file)
    if args.parameters:
        return load_parameters_file(args.parameters)
    return default_config()


def _report_accuracy(est, gt_path, gt=None):
    from semantic_slam_mapping_torch.io.gt_pose import read_kitti_poses
    from semantic_slam_mapping_torch.utils import metrics
    if gt is None:
        if not gt_path:
            return
        gt = read_kitti_poses(gt_path)
    n = min(len(est), len(gt))
    ate = metrics.absolute_trajectory_error(est[:n], gt[:n])
    rpe_t, rpe_r = metrics.relative_pose_error(est[:n], gt[:n])
    print(json.dumps({
        "ate_rmse_m": round(ate.rmse, 4), "ate_median_m": round(ate.median, 4),
        "rpe_t_rmse_m": round(rpe_t.rmse, 4),
        "rpe_r_rmse_rad": round(rpe_r.rmse, 6), "frames": n}))


def _to_device(a, device):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _plot(out_dir, traj, gt_path=None, gt=None):
    from semantic_slam_mapping_torch.io.gt_pose import read_kitti_poses
    from semantic_slam_mapping_torch.utils.plot import plot_trajectories
    if gt is None and gt_path:
        gt = read_kitti_poses(gt_path)[:len(traj)]
    plot_trajectories(out_dir / "trajectory.png", traj, gt)


def cmd_slam(args):
    from semantic_slam_mapping_torch.io.gt_pose import write_kitti_poses
    from semantic_slam_mapping_torch.io.kitti import KittiReader
    from semantic_slam_mapping_torch.pipeline import SlamSystem
    from semantic_slam_mapping_torch.utils.timing import StageTimer

    cfg = _load_cfg(args)
    if getattr(args, "segnet_online", False):
        # online labels of each keyframe, by default with the JAX package's
        # shipped checkpoint (a seeded network when it is not there)
        weights = args.segnet_weights or str(_SHIPPED_SEGNET)
        cfg = dataclasses.replace(cfg, segnet=dataclasses.replace(
            cfg.segnet, online=True,
            weights=weights if Path(weights).exists() else None))
    reader = KittiReader(args.data or cfg.dataset.data_source,
                         start_index=cfg.dataset.start_index,
                         end_index=cfg.dataset.end_index,
                         semantic_dir=args.semantic_dir)
    vocab = None
    if args.vocab:
        from semantic_slam_mapping_torch.backend.looper import load_vocabulary
        vocab = load_vocabulary(args.vocab)
    system = SlamSystem(cfg, vocab=vocab, device=args.device)
    timer = StageTimer()
    t0 = time.time()
    if getattr(args, "no_pipeline", False):
        # one frame fully processed at a time (frames go up as float
        # tensors, as the JAX package's serial mode passes device arrays)
        for frame in reader:
            with timer.stage("frame"):
                out = system.process_frame(
                    _to_device(frame.left, args.device),
                    _to_device(frame.right, args.device),
                    color=frame.color, semantic=frame.semantic)
            if out is not None and args.verbose:
                print(f"frame {frame.index}: inliers={int(out.n_inliers)} "
                      f"kf={len(system.keyframes)}", file=sys.stderr)
    else:
        # the pipelined loop: later frames' frontends are queued on the
        # device while a keyframe's host work runs
        def stream():
            for frame in reader:
                yield (frame.left, frame.right, frame.color, frame.semantic)
                if args.verbose and frame.index % 25 == 0:
                    print(f"frame {frame.index}: kf={len(system.keyframes)}"
                          f" loops={system.n_loop_edges}"
                          f" opt={system.n_optimizations}", file=sys.stderr)
        system.process_stream(stream())
    wall = time.time() - t0
    n_done = max(system.frame_count, 1)
    print(f"# {n_done} frames in {wall:.1f}s = {n_done / wall:.3f} fps",
          file=sys.stderr)
    traj = system.finish()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_kitti_poses(out_dir / "trajectory.txt", traj)
    system.save_g2o(str(out_dir / "traj.g2o"))
    if getattr(args, "no_pipeline", False):
        print(timer.report(), file=sys.stderr)
    print(system.timer.report(), file=sys.stderr)
    _report_accuracy(traj, args.gt)
    if args.plot:
        _plot(out_dir, traj, args.gt)


def cmd_tracker(args):
    """The frontend and the pose graph without loop closure."""
    args.vocab = None
    cmd_slam(args)


def _tum_accuracy(est, timestamps, gt_file):
    """ATE/RPE against a TUM groundtruth.txt, associated by timestamp."""
    from semantic_slam_mapping_torch.io.gt_pose import read_tum_trajectory
    gt_ts, gt_poses = read_tum_trajectory(gt_file)
    idx = np.searchsorted(gt_ts, np.asarray(timestamps))
    idx = np.clip(idx, 0, len(gt_ts) - 1)
    _report_accuracy(est, None, gt=gt_poses[idx])
    return gt_poses[idx]


def cmd_rgbd(args):
    """TUM RGB-D tracking: ORB matching against the reference ring and one
    pooled PnP a frame (``frontend/rgbd_tracker.py``)."""
    from semantic_slam_mapping_torch.config import CameraConfig
    from semantic_slam_mapping_torch.frontend.rgbd_tracker import (
        RgbdTrackerState, track_frame_rgbd)
    from semantic_slam_mapping_torch.geometry.camera import Intrinsics
    from semantic_slam_mapping_torch.io.gt_pose import write_kitti_poses
    from semantic_slam_mapping_torch.io.tum import TumReader
    from semantic_slam_mapping_torch.utils.timing import StageTimer

    cfg = _load_cfg(args)
    # TUM fr1 intrinsics by default
    cfg = cfg.replace(camera=CameraConfig(
        fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy,
        baseline=cfg.camera.baseline, scale=args.depth_scale))
    K = Intrinsics.from_config(cfg.camera)
    reader = TumReader(args.data, depth_scale=args.depth_scale,
                       end_index=args.frames or None)
    state = RgbdTrackerState.initial(cfg.orb.n_features,
                                     cfg.tracker.ref_frames, args.device)
    traj, ts = [], []
    timer = StageTimer()
    for frame in reader:
        with timer.stage("frame"):
            state, out = track_frame_rgbd(
                state, _to_device(frame.left, args.device),
                _to_device(frame.depth, args.device), K, cfg)
        traj.append(out.pose.cpu().numpy())
        ts.append(reader.timestamps[frame.index])
        if args.verbose:
            print(f"frame {frame.index}: matches={int(out.n_matches)} "
                  f"inliers={int(out.n_inliers)}", file=sys.stderr)
    traj = np.stack(traj)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_kitti_poses(out_dir / "trajectory.txt", traj)
    print(timer.report(), file=sys.stderr)
    gt = _tum_accuracy(traj, ts, args.gt) if args.gt else None
    if args.plot:
        _plot(out_dir, traj, gt=gt)


def stereo_depth(left, right, cfg):
    """``pnp``'s depth map: SGBM, then fx * baseline / max(disparity,
    1e-3) where the disparity is valid, else 0. The numerator is a float32
    tensor, so the division is a true one, as in the JAX package (a Python
    float over a tensor would become a reciprocal times it on the card)."""
    import torch

    from semantic_slam_mapping_torch.ops import sgbm

    res = sgbm.compute(left, right, cfg.sgbm)
    bf = torch.full((), cfg.camera.fx * cfg.camera.baseline,
                    dtype=torch.float32, device=left.device)
    return torch.where(res.valid, torch.div(
        bf, torch.clamp(res.disparity, min=1e-3)), 0.0)


def cmd_pnp(args):
    """Frame-to-frame PnP odometry on KITTI stereo: depth from SGBM
    (``stereo_depth``), ORB matching against the reference ring, one PnP a
    frame."""
    from semantic_slam_mapping_torch.frontend.rgbd_tracker import (
        RgbdTrackerState, track_frame_rgbd)
    from semantic_slam_mapping_torch.geometry.camera import Intrinsics
    from semantic_slam_mapping_torch.io.gt_pose import write_kitti_poses
    from semantic_slam_mapping_torch.io.kitti import KittiReader
    from semantic_slam_mapping_torch.utils.timing import StageTimer

    cfg = _load_cfg(args)
    K = Intrinsics.from_config(cfg.camera)
    reader = KittiReader(args.data or cfg.dataset.data_source,
                         start_index=cfg.dataset.start_index,
                         end_index=cfg.dataset.end_index)

    def step(state, left, right):
        depth = stereo_depth(left, right, cfg)
        return track_frame_rgbd(state, left, depth, K, cfg)

    state = RgbdTrackerState.initial(cfg.orb.n_features,
                                     cfg.tracker.ref_frames, args.device)
    traj = []
    timer = StageTimer()
    for frame in reader:
        with timer.stage("frame"):
            state, out = step(state, _to_device(frame.left, args.device),
                              _to_device(frame.right, args.device))
        traj.append(out.pose.cpu().numpy())
        if args.verbose:
            print(f"frame {frame.index}: matches={int(out.n_matches)} "
                  f"inliers={int(out.n_inliers)}", file=sys.stderr)
    traj = np.stack(traj)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_kitti_poses(out_dir / "trajectory.txt", traj)
    print(timer.report(), file=sys.stderr)
    _report_accuracy(traj, args.gt)
    if args.plot:
        _plot(out_dir, traj, args.gt)


def cmd_read_frames(args):
    """Dataset reader probe: shapes and ranges of each frame, optionally
    the first frames written as PNGs."""
    from semantic_slam_mapping_torch.io.png import write_png
    if args.dataset == "tum":
        from semantic_slam_mapping_torch.io.tum import TumReader
        reader = TumReader(args.data)
    else:
        from semantic_slam_mapping_torch.io.kitti import KittiReader
        reader = KittiReader(args.data, semantic_dir=args.semantic_dir)
    n = 0
    for frame in reader:
        parts = [f"frame {frame.index}: left {frame.left.shape}"]
        if frame.color is not None:
            parts.append(f"color {frame.color.shape}")
        if frame.depth is not None:
            d = frame.depth[frame.depth > 0]
            parts.append(f"depth [{d.min():.2f}, {d.max():.2f}]m"
                         if d.size else "depth empty")
        if frame.semantic is not None:
            parts.append(f"semantic classes {np.unique(frame.semantic)[:8]}")
        print("  ".join(parts))
        if args.dump and n < args.dump:
            out_dir = Path(args.out)
            out_dir.mkdir(parents=True, exist_ok=True)
            write_png(out_dir / f"{frame.index:06d}_left.png",
                      (np.asarray(frame.left) * 255).astype(np.uint8))
            if frame.depth is not None:
                dv = np.asarray(frame.depth)
                dn = (255 * dv / max(float(dv.max()), 1e-6)).astype(np.uint8)
                write_png(out_dir / f"{frame.index:06d}_depth.png", dn)
        n += 1
        if args.frames and n >= args.frames:
            break
    print(f"{n} frames OK", file=sys.stderr)


def _draw_keypoints(path, img01, xy, valid):
    """Write a keypoint overlay PNG: green 3x3 crosses on the grey
    image."""
    from semantic_slam_mapping_torch.io.png import write_png
    g = (np.clip(np.asarray(img01), 0, 1) * 255).astype(np.uint8)
    rgb = np.stack([g, g, g], axis=-1)
    H, W = g.shape
    for u, v in np.asarray(xy)[np.asarray(valid)]:
        ui, vi = int(round(float(u))), int(round(float(v)))
        if 1 <= ui < W - 1 and 1 <= vi < H - 1:
            rgb[vi, ui - 1:ui + 2] = (0, 255, 0)
            rgb[vi - 1:vi + 2, ui] = (0, 255, 0)
    write_png(path, rgb)


def cmd_match_orb(args):
    """Consecutive-frame ORB matching probe: keypoints, ratio-test
    matches and the time of each frame; with --dump N, keypoint overlay
    PNGs of the first N frames."""
    from semantic_slam_mapping_torch.ops import matching
    from semantic_slam_mapping_torch.ops import orb as orb_mod

    cfg = _load_cfg(args)
    if args.dataset == "tum":
        from semantic_slam_mapping_torch.io.tum import TumReader
        reader = TumReader(args.data, end_index=args.frames or None)
    else:
        from semantic_slam_mapping_torch.io.kitti import KittiReader
        reader = KittiReader(args.data, end_index=args.frames or None)
    prev = None
    for frame in reader:
        t0 = time.time()
        feats = orb_mod.extract(_to_device(frame.left, args.device), cfg.orb)
        n_kp = int(feats.valid.sum())
        if prev is not None:
            m = matching.match_descriptors(
                prev.desc, feats.desc, valid_a=prev.valid,
                valid_b=feats.valid, ratio=cfg.orb.knn_match_ratio)
            n_match = int(m.valid.sum())
            dt = (time.time() - t0) * 1e3
            print(f"frame {frame.index}: {n_kp} keypoints, "
                  f"{n_match} matches, {dt:.1f} ms")
        else:
            print(f"frame {frame.index}: {n_kp} keypoints")
        if getattr(args, "dump", 0) and frame.index < args.dump:
            out_dir = Path(args.out)
            out_dir.mkdir(parents=True, exist_ok=True)
            _draw_keypoints(out_dir / f"{frame.index:06d}_orb.png",
                            frame.left, feats.xy.cpu().numpy(),
                            feats.valid.cpu().numpy())
        prev = feats


def cmd_segnet(args):
    """Offline segmentation pass: label images (segnet_0/) and colored
    overlays (result_0/) of every frame."""
    import torch

    from semantic_slam_mapping_torch.config import SegNetConfig
    from semantic_slam_mapping_torch.io.kitti import KittiReader
    from semantic_slam_mapping_torch.io.png import write_png
    from semantic_slam_mapping_torch.mapping.semantics import colorize
    from semantic_slam_mapping_torch.models import segnet
    from semantic_slam_mapping_torch.ops.image import resize_bilinear

    cfg = SegNetConfig()
    if args.checkpoint:
        model, _ = segnet.load_checkpoint(args.checkpoint)
    else:
        model = segnet.create(cfg, torch.Generator().manual_seed(0))
    model = model.to(args.device)
    reader = KittiReader(args.data)
    label_dir = Path(args.out) / "segnet_0"
    result_dir = Path(args.out) / "result_0"
    label_dir.mkdir(parents=True, exist_ok=True)
    result_dir.mkdir(parents=True, exist_ok=True)
    h = -(-cfg.input_height // 32) * 32
    w = -(-cfg.input_width // 32) * 32
    for frame in reader:
        color = frame.color if frame.color is not None else \
            np.stack([frame.left] * 3, -1)
        x = resize_bilinear(_to_device(color, args.device).permute(2, 0, 1),
                            (h, w)).permute(1, 2, 0)[None]
        labels = segnet.infer(model, x)[0]
        H0, W0 = frame.left.shape
        # class ids resized as floats and truncated, as the JAX package does
        lab_full = resize_bilinear(labels.float()[None], (H0, W0))[0] \
            .cpu().numpy().astype(np.uint8)
        write_png(label_dir / f"{frame.index:06d}.png", lab_full)
        overlay = (0.6 * color * 255 + 0.4 * colorize(lab_full)).astype(
            np.uint8)
        write_png(result_dir / f"{frame.index:06d}.png", overlay)
        print(f"segmented {frame.index}", file=sys.stderr)


def cmd_synth(args):
    """Synthetic street with exact ground truth, no dataset needed. The
    world is drawn from a torch.Generator seeded 0."""
    import torch

    from semantic_slam_mapping_torch.config import default_config
    from semantic_slam_mapping_torch.geometry.camera import Intrinsics
    from semantic_slam_mapping_torch.io import synthetic
    from semantic_slam_mapping_torch.io.gt_pose import write_kitti_poses
    from semantic_slam_mapping_torch.pipeline import SlamSystem

    cfg = default_config()
    K = Intrinsics.from_config(cfg.camera)
    gen = torch.Generator(device=args.device).manual_seed(0)
    world = synthetic.make_world(gen, n_boxes=14, device=args.device)
    poses = synthetic.straight_trajectory(args.frames, speed=0.8,
                                          device=args.device)
    seq = synthetic.render_sequence(K, world, poses, 376, 1248)
    system = SlamSystem(cfg, device=args.device)
    t0 = time.time()
    for i in range(args.frames):
        system.process_frame(seq["left"][i], seq["right"][i])
    traj = system.finish()
    dt = time.time() - t0
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_kitti_poses(out_dir / "trajectory.txt", traj)
    print(f"{args.frames} frames in {dt:.1f}s "
          f"({args.frames / dt:.2f} fps incl. compile)", file=sys.stderr)
    _report_accuracy(traj, None, gt=seq["poses"].cpu().numpy())


def cmd_make_vocab(args):
    """A BoW vocabulary from a sequence's ORB descriptors (the
    looper_vocab_file artifact)."""
    from semantic_slam_mapping_torch.backend import looper as lp
    from semantic_slam_mapping_torch.io.kitti import KittiReader
    from semantic_slam_mapping_torch.ops import orb as orb_mod

    cfg = _load_cfg(args)
    reader = KittiReader(args.data)
    descs = []
    for i in range(reader.start, reader.end, args.stride):
        frame = reader.get(i)
        f = orb_mod.extract(_to_device(frame.left, args.device), cfg.orb)
        descs.append(f.desc[f.valid].cpu().numpy())
        print(f"extracted {i}: {len(descs[-1])} descriptors", file=sys.stderr)
    train = np.concatenate(descs)
    vocab = lp.build_vocabulary(train, branching=args.branching,
                                depth=args.depth)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    lp.save_vocabulary(str(out / "vocab.npz"), vocab)
    print(f"vocabulary: {vocab.n_leaves} words from {len(train)} "
          f"descriptors -> {out / 'vocab.npz'}")


class TrainBatches:
    """The data of ``train-segnet``, drawn as the JAX package's
    ``cmd_train_segnet`` draws it, from ``torch.Generator``s seeded as it
    seeds its keys: (image, label) batches of ``batch`` views rendered at
    ``size`` (padded up to a multiple of 32) by a camera with fx = fy = 200
    at the image centre, the grey image stacked three times.

    Two training families alternate, street worlds on even steps and
    loop-canyon views on odd steps, drawn from the generator seeded 0;
    the class weights come from two batches of each family from the
    generator seeded 77; the holdout batch is a street batch from 9999 and
    the held-out world a batch of another loop family from 424242. A
    caller may pass another object with the same four methods to
    :func:`cmd_train_segnet` (a test replays JAX-drawn batches so). The
    worlds and poses are drawn on the host, so a seed gives the same
    batches on every device."""

    STREET_NOISE = (0.5, 0.1, 0.5, 0.02, 0.05, 0.01)
    LOOP_NOISE = (0.3, 0.05, 0.3, 0.01, 0.03, 0.005)

    def __init__(self, size: int, batch: int, device):
        import torch

        from semantic_slam_mapping_torch.config import CameraConfig
        from semantic_slam_mapping_torch.geometry.camera import Intrinsics
        self.hw = -(-size // 32) * 32
        self.batch = batch
        self.device = device
        self.K = Intrinsics.from_config(CameraConfig(
            fx=200.0, fy=200.0, cx=self.hw / 2, cy=self.hw / 2))
        self._train = torch.Generator().manual_seed(0)

    def _noise(self, gen, sigma):
        import torch

        from semantic_slam_mapping_torch.geometry import se3
        return se3.exp(torch.randn(6, generator=gen) * torch.tensor(sigma))

    def _render(self, world, pose):
        import torch

        from semantic_slam_mapping_torch.io import synthetic
        img, _, sem, _ = synthetic.render(self.K, pose.to(self.device),
                                          world, self.hw, self.hw)
        return torch.stack([img] * 3, -1), sem

    def _stack(self, one, gen):
        import torch
        xs, ys = zip(*(one(gen) for _ in range(self.batch)))
        return torch.stack(xs), torch.stack(ys)

    def _street(self, gen):
        from semantic_slam_mapping_torch.io import synthetic
        # vehicles and pedestrians, so every class the mapper filters
        # appears in the training data
        world = synthetic.make_world(gen, n_boxes=10, with_moving_box=True,
                                     n_moving=9, device=self.device)
        return self._render(world, self._noise(gen, self.STREET_NOISE))

    def _loop_view(self, gen, radius, index):
        from semantic_slam_mapping_torch.geometry import se3
        from semantic_slam_mapping_torch.io import synthetic
        world = synthetic.make_loop_world(gen, n_boxes=32, radius=radius,
                                          n_moving=6, device=self.device)
        traj = synthetic.loop_trajectory(8, radius=radius, laps=1.0,
                                         device="cpu")
        pose = se3.compose(traj[index(gen)],
                           self._noise(gen, self.LOOP_NOISE))
        return self._render(world, pose)

    def _loop(self, gen):
        # the second training family: loop-canyon views at one of the 8
        # poses of the ring
        import torch
        return self._loop_view(gen, 28.0, lambda g: int(
            torch.randint(0, 8, (), generator=g)))

    def _heldout(self, gen):
        # the held-out family: another ring radius, the pose at index
        # floor(th / 2 pi * 7) of an angle th uniform in [0, 2 pi)
        import torch
        return self._loop_view(gen, 25.0, lambda g: int(
            float(torch.rand((), generator=g)) * 7))

    def class_weight_batches(self):
        import torch
        gen = torch.Generator().manual_seed(77)
        return [self._stack(f, gen)[1] for f in
                (self._street, self._street, self._loop, self._loop)]

    def holdout(self):
        import torch
        return self._stack(self._street, torch.Generator().manual_seed(9999))

    def heldout_world(self):
        import torch
        return self._stack(self._heldout,
                           torch.Generator().manual_seed(424242))

    def train(self, it: int):
        return self._stack(self._street if it % 2 == 0 else self._loop,
                           self._train)


def cmd_train_segnet(args, batches=None, model=None):
    """Train SegNet on synthetic rendered (image, label) pairs, as the JAX
    package's ``cmd_train_segnet`` does: Adam on the class-weighted
    cross-entropy (median-frequency weights of four sample batches, capped
    at 4), both mIoUs every 25 steps and on the last, the best checkpoint
    by their mean kept, per-class recall on the held-out world, then
    ``segnet.pkl`` with the JAX package's ``meta``. ``batches`` (default
    :class:`TrainBatches`) and ``model`` (default ``segnet.create`` from a
    generator seeded 0) let a caller supply the data and the start.

    With ``--mesh`` this process is one rank of a dp x tp mesh (torchrun's
    environment, else a world of one; JAX's default shape) and trains the
    start sharded by ``parallel.sharded_segnet`` on the same batches as
    every rank; the evaluations run on the gathered parameters, and rank 0
    alone prints and writes ``segnet.pkl``, whose layout is a meshless
    run's."""
    import torch

    from semantic_slam_mapping_torch.config import SegNetConfig
    from semantic_slam_mapping_torch.mapping import semantics as semcls
    from semantic_slam_mapping_torch.models import segnet

    seg_cfg = SegNetConfig(input_height=args.size, input_width=args.size,
                           width_mult=args.width)
    if model is None:
        model = segnet.create(seg_cfg, torch.Generator().manual_seed(0))
    mesh = None
    if args.mesh:
        from semantic_slam_mapping_torch.parallel import mesh as pmesh
        from semantic_slam_mapping_torch.parallel import sharded_segnet
        pmesh.initialize_distributed(device=args.device)
        mesh = pmesh.make_mesh(device=args.device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    if mesh is not None and lead:
        shape = {axis: pmesh.axis_size(mesh, axis)
                 for axis in mesh.mesh_dim_names}
        print(f"training on mesh {shape}", file=sys.stderr)
    model = model.to(args.device)
    if batches is None:
        batches = TrainBatches(args.size, args.batch, args.device)
    n_classes = seg_cfg.num_classes

    # median-frequency class balancing from a label sample, the rare-class
    # boost capped at 4
    cw = torch.clamp(segnet.median_frequency_weights(
        batches.class_weight_batches(), n_classes), max=4.0)
    if lead:
        print("class weights:", np.round(cw.numpy(), 2), file=sys.stderr)
    if mesh is None:
        step = segnet.make_train_step(model, segnet.adam(model, args.lr),
                                      class_weights=cw.to(args.device))
        full = lambda: model                        # noqa: E731
    else:
        model = pmesh.shard_params(model, mesh)
        step = sharded_segnet.make_sharded_train_step(
            model, mesh, args.lr, class_weights=cw.to(args.device))
        full = lambda: pmesh.gather_params(model, mesh)   # noqa: E731
    hold_x, hold_y = batches.holdout()
    ho_x, ho_y = batches.heldout_world()

    def eval_miou(net, x, y):
        pred = segnet.infer(net.eval(), x)
        return float(segnet.miou(pred, y, n_classes))

    best = (-1.0, None)   # (mean of the two eval mIoUs, state)
    net = None
    t0 = time.time()
    for it in range(args.steps):
        x, y = batches.train(it)
        loss = step(x, y)
        if it % 25 == 0 or it == args.steps - 1:
            net = full()    # on a mesh, every rank joins the gather
            if not lead:
                continue
            mh = eval_miou(net, hold_x, hold_y)
            mw = eval_miou(net, ho_x, ho_y)
            if 0.5 * (mh + mw) > best[0]:
                best = (0.5 * (mh + mw),
                        {k: v.detach().clone()
                         for k, v in net.state_dict().items()})
            print(f"step {it}: loss {float(loss):.4f} holdout mIoU "
                  f"{mh:.3f} heldout-world mIoU {mw:.3f}",
                  file=sys.stderr, flush=True)
    train_s = time.time() - t0
    if mesh is not None:
        model = net if net is not None else full()
        torch.distributed.destroy_process_group()
        if not lead:
            return
    print(f"trained {args.steps} steps in {train_s:.2f} s "
          f"({args.steps / max(train_s, 1e-9):.3f} steps/s)",
          file=sys.stderr)
    # ship the best-by-eval checkpoint, not the last step
    if best[1] is not None:
        model.load_state_dict(best[1])
    final_miou = eval_miou(model, hold_x, hold_y)
    world_miou = eval_miou(model, ho_x, ho_y)

    pred = segnet.infer(model.eval(), ho_x).cpu().numpy()
    gt = ho_y.cpu().numpy()
    recall = {}
    for c, name in enumerate(semcls.CLASS_NAMES):
        mask = gt == c
        if mask.sum() > 0:
            recall[name] = round(float((pred[mask] == c).mean()), 4)
    print("per-class recall (held-out world):", recall, file=sys.stderr)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    segnet.save_checkpoint(
        out / "segnet.pkl", seg_cfg, model,
        meta={"miou": final_miou,
              "miou_heldout_world": world_miou,
              "per_class_recall_heldout_world": recall,
              "steps": args.steps, "width_mult": args.width,
              "train_size": args.size,
              "holdout_frames": int(args.batch),
              "heldout_world": "loop-circuit family, seed stream 424242"})
    print(f"saved {out / 'segnet.pkl'} (holdout mIoU {final_miou:.3f}, "
          f"held-out world mIoU {world_miou:.3f})")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="semantic_slam_mapping_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--parameters", help="reference-format parameters.txt")
    common.add_argument("--data", help="dataset directory")
    common.add_argument("--gt", help="KITTI GT pose file")
    common.add_argument("--out", default="out")
    common.add_argument("--verbose", action="store_true")
    common.add_argument("--plot", action="store_true",
                        help="write a top-down trajectory PNG")
    common.add_argument("--no-pipeline", action="store_true",
                        help="serialized per-frame processing (debug); "
                             "default is the pipelined loop")
    common.add_argument("--device", default="cuda",
                        help="torch device (default cuda; raises without a "
                             "card; cpu runs the plain PyTorch path)")

    p = sub.add_parser("slam", parents=[common])
    p.add_argument("--vocab")
    p.add_argument("--semantic-dir")
    p.add_argument("--segnet-online", action="store_true",
                   help="segment keyframes in-pipeline with the shipped "
                        "SegNet checkpoint (vs --semantic-dir pre-pass)")
    p.add_argument("--segnet-weights", help="override checkpoint path")
    p.set_defaults(fn=cmd_slam)

    p = sub.add_parser("tracker", parents=[common])
    p.add_argument("--semantic-dir")
    p.set_defaults(fn=cmd_tracker)

    p = sub.add_parser("segnet", parents=[common])
    p.add_argument("--checkpoint")
    p.set_defaults(fn=cmd_segnet)

    p = sub.add_parser("synth", parents=[common])
    p.add_argument("--frames", type=int, default=12)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("rgbd", parents=[common],
                       help="TUM RGB-D ORB+PnP tracking")
    p.add_argument("--fx", type=float, default=517.3)
    p.add_argument("--fy", type=float, default=516.5)
    p.add_argument("--cx", type=float, default=318.6)
    p.add_argument("--cy", type=float, default=255.3)
    p.add_argument("--depth-scale", type=float, default=5000.0)
    p.add_argument("--frames", type=int, default=0)
    p.set_defaults(fn=cmd_rgbd)

    p = sub.add_parser("pnp", parents=[common],
                       help="KITTI frame-to-frame PnP odometry")
    p.set_defaults(fn=cmd_pnp)

    p = sub.add_parser("read-frames", parents=[common],
                       help="dataset I/O sanity probe")
    p.add_argument("--dataset", choices=("kitti", "tum"), default="kitti")
    p.add_argument("--semantic-dir")
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--dump", type=int, default=0,
                   help="dump the first N frames as PNGs")
    p.set_defaults(fn=cmd_read_frames)

    p = sub.add_parser("match-orb", parents=[common],
                       help="consecutive-frame ORB match probe")
    p.add_argument("--dataset", choices=("kitti", "tum"), default="tum")
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--dump", type=int, default=0,
                   help="write keypoint-overlay PNGs for the first N "
                        "frames")
    p.set_defaults(fn=cmd_match_orb)

    p = sub.add_parser("make-vocab", parents=[common])
    p.add_argument("--stride", type=int, default=10,
                   help="train on every Nth frame")
    p.add_argument("--branching", type=int, default=10)
    p.add_argument("--depth", type=int, default=3)
    p.set_defaults(fn=cmd_make_vocab)

    p = sub.add_parser("train-segnet", parents=[common])
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--width", type=float, default=1.0,
                   help="channel width multiplier (slim checkpoints)")
    p.add_argument("--mesh", action="store_true",
                   help="shard training dp x tp over local devices")
    p.set_defaults(fn=cmd_train_segnet)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from semantic_slam_mapping_torch.device import resolve
    args.device = resolve(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
