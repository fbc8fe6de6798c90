#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one flushed JSON line with the seconds elapsed:

1. ``device``: the card's name, count, and name and power limit from
   nvidia-smi. Fails when there is no CUDA device.
2. ``build``: compiles the kernel source of the port's main path with
   nvcc for sm_90a into build/torch_kernels/ (``-Xptxas -v`` prints its
   registers and spills), and the C++ voxel map with g++.
3. ``kernels``: holds each kernel against its plain PyTorch version on the
   card, exactly (tolerance 0) and in the volume's dtype, at the main
   path's shape in float32 and bfloat16, and at a few small and ragged
   shapes; then times the kernel and each of its two launches with CUDA
   events (median of 25 batches of 10 calls after 3 warm-ups; the 75 MB
   volume exceeds the 50 MB L2, so it runs cold), and the launches of
   variants built with one part switched off, to show what bounds it.
4. ``slice``: renders 10 KITTI-size (376x1248) stereo frames of a
   fixed-seed synthetic street on the card and runs them through
   ``SlamSystem(cfg, enable_mapping=True, device="cuda").process_stream``
   with the default configuration (80 disparities, 11x11 window, bfloat16
   cost volume, 512 features, 200 RANSAC hypotheses), no vocabulary, and
   online SegNet at full width (VGG16, bfloat16, 384x480 input) with
   weights drawn from seed 0. Every kernel launch count is zeroed just
   before and read just after; each kernel must have been launched, and
   every SGM aggregate of the run must be bfloat16. Every tracked frame
   must have a VO success, the trajectory's ATE RMSE against the rendered
   ground truth must be below 0.3 m, the results and the keyframes' SegNet
   labels must live on the card, and the map must have voxels.
5. ``epoch``: the whole stereo SLAM at KITTI size with the default
   configuration: 250 frames of a circular course (radius 15 m, 1.25 laps,
   0.47 m a frame) through a fixed-seed loop world with 6 movers, with the
   renderer's ground-truth labels as each frame's fourth item, a
   vocabulary built by ``build_vocabulary`` (branching 10, depth 4) from
   the ORB descriptors of every 12th frame, then ``SlamSystem(cfg, vocab,
   enable_mapping=True, device="cuda").process_stream(depth=6)`` and
   ``finish()``. Counts zeroed just before and read just after: the SGM
   kernel must run exactly twice per tracked frame. The run must make at
   least 10 keyframes, accept a loop edge, fire a global optimisation
   before ``finish``, keep its features and BoW database on the card,
   finish with an ATE RMSE below 0.8 m, and build a map of more than
   50,000 voxels with no voxel of an excluded class (sky, pole,
   bicyclist), whose PCD reads back with POINTS equal to the voxel count.
   Prints frames/s, the stage timer, the counts, the map, and the
   device-busy share of one profiled keyframe epoch.
6. ``segnet``: times the full-width SegNet alone on a (1, 384, 480, 3)
   input and ``SlamSystem._run_segnet`` on one KITTI-size keyframe (CUDA
   events, median of 15), with its launches per call and its rate against
   the card's bfloat16 peak.
7. ``stages``: times each stage of one frontend step on the card, then
   profiles one step: device-busy time, idle share, launches, top kernels.
8. ``candidates``: card time and launches of the keyframe epoch's
   kernel candidates (Hamming matching, batched PnP, the vocabulary
   descent, the LM + PCG solve, the keyframe cloud) at the epoch's shapes,
   per call and per keyframe, beside one PyTorch call computing the same
   function where there is one.
9. ``parity``: runs SGBM, an argmin with planted ties, quad matching, VO
   with fixed samples, ORB, the PnP gate, the pose-graph solve, the
   quantized keyframe cloud, SegNet's pooling with planted ties, one
   bfloat16 SegNet layer and SegNet's labels of one frame on the card and
   on the host CPU with the same inputs from one KITTI-size frame pair or
   keyframe, and the pose-graph solve twice on the card; prints each
   tolerance and error, and raises on a miss.

Then the kernels line ``{"kernels": [...]}``, the card's name and power
limit as nvidia-smi gives them, and last ``{"ok": true, "device": ...}``.
Any failure raises and the script exits non-zero without that last line.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from semantic_slam_mapping_torch import pipeline
from semantic_slam_mapping_torch.backend import looper, pnp
from semantic_slam_mapping_torch.backend import pose_graph as pg
from semantic_slam_mapping_torch.config import SegNetConfig, SlamConfig
from semantic_slam_mapping_torch.frontend import quadmatch, tracker, vo
from semantic_slam_mapping_torch.frontend import uvdisparity as uvd
from semantic_slam_mapping_torch.geometry import stereo as gstereo
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.io import synthetic
from semantic_slam_mapping_torch.mapping import native, semantics
from semantic_slam_mapping_torch.models import segnet as segnet_mod
from semantic_slam_mapping_torch.ops import matching, orb, sgbm
from semantic_slam_mapping_torch.ops.cuda import sgm_cuda
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils.metrics import ate_rmse

T0 = time.time()
H, W = 376, 1248
N_FRAMES = 10
ATE_BOUND_M = 0.3
# the epoch phase: a 250-frame circular course, 0.47 m a frame
N_EPOCH = 250
LOOP_RADIUS_M = 15.0
LOOP_LAPS = 1.25
EPOCH_ATE_BOUND_M = 0.8
VOCAB_EVERY = 12
# the map of the epoch: at least this many voxels
EPOCH_MIN_VOXELS = 50_000
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the
# tensor cores, dense bf16 FLOP/s on them
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12
# SegNet's input: the configured 360x480 padded to multiples of 32
SEGNET_HW = (384, 480)
# f32 operations per (pixel, disparity) of sgm_aggregate4, per direction:
# a min-reduction term, 4 adds, 3 mins, 1 subtract and the add into the
# four-direction sum
SGM_OPS_PER_ELEMENT = 4 * 10
# what bounds the SGM kernel: variants of its source with one part switched
# off (wrong numbers, timed only): no cp.async loads, no stores to device
# memory, a lane's own minimum in place of the warp's redux.sync
SGM_VARIANTS = {
    "no_loads": ('  asm volatile("cp.async.cg.shared.global',
                 '  if (0) asm volatile("cp.async.cg.shared.global'),
    "no_stores": ("      if (active) Q::store(out, o);",
                  "      if (o.x == 0x12345u) Q::store(out, o);"),
    "no_redux": ("__uint_as_float(__reduce_min_sync(kFull, lm))",
                 "__uint_as_float(lm)"),
}
# the small checks: ragged lines, a single row, a pixel stride the wrapper
# pads, the widest D
SGM_SMALL = ((37, 24, 16), (24, 37, 16), (1, 7, 13), (33, 20, 13),
             (9, 40, 96))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t_s": round(time.time() - T0, 2),
                      **fields}), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=5, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, reps: int = 25, batch: int = 1) -> float:
    """Median milliseconds of fn() on the card, by CUDA events around
    `batch` calls in a row (so that the card does not wait for the host
    between calls of a short kernel), over `reps` such batches."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    # full float32 in matmuls and convolutions: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    card = nvidia_smi()
    emit("device", **dev, nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)
    return {"device": dev, "card": card}


def phase_build() -> None:
    t = time.time()
    lib = sgm_cuda.build(verbose=True)
    nvcc_s = time.time() - t
    t = time.time()
    voxel_lib = native.build()
    emit("build", seconds=round(nvcc_s, 2), libraries=[lib.name],
         voxel_map_seconds=round(time.time() - t, 2),
         voxel_map_library=voxel_lib.name)


def check_sgm(vol: torch.Tensor, p1: float, p2: float, label: str) -> float:
    """Max abs error of the SGM kernel against its plain version; raises
    unless the two agree exactly in the volume's dtype."""
    out = sgm_cuda.sgm_aggregate4(vol, p1, p2)
    ref = sgm_cuda.sgm_aggregate4_plain(vol, p1, p2)
    torch.cuda.synchronize()
    max_abs = float((out.float() - ref.float()).abs().max())
    ok = out.dtype == ref.dtype == vol.dtype and torch.equal(out, ref)
    emit("kernels", kernel="sgm_aggregate4", check=label,
         dtype=str(vol.dtype).split(".")[-1], shape=list(vol.shape),
         out_dtype=str(out.dtype).split(".")[-1], max_abs_err=max_abs,
         tolerance=0.0, ok=ok)
    if not ok:
        raise AssertionError(f"sgm_aggregate4 ({label}, {vol.dtype}) "
                             f"disagrees with its plain version: max abs "
                             f"{max_abs}, {out.dtype}")
    return max_abs


def sgm_variant_ms(vol: torch.Tensor, p1: float, p2: float) -> dict:
    """Milliseconds of the vertical and the horizontal launch of each
    SGM_VARIANTS build, on the main path's bf16 volume."""
    H_, W_, D_ = vol.shape
    vsum, out = torch.empty_like(vol), torch.empty_like(vol)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name, (old, new) in SGM_VARIANTS.items():
        src = sgm_cuda.SOURCE.read_text()
        if old not in src:
            raise AssertionError(f"variant {name}: no {old!r} in the source")
        build = sgm_cuda.BUILD_DIR / "variants"
        build.mkdir(parents=True, exist_ok=True)
        (build / f"{name}.cu").write_text(src.replace(old, new))
        lib = build / f"lib{name}.so"
        subprocess.run([sgm_cuda._nvcc(), *sgm_cuda.NVCC_FLAGS, "-o",
                        str(lib), str(build / f"{name}.cu")], check=True,
                       timeout=120)
        fn = ctypes.CDLL(str(lib)).sgm_aggregate_pass
        fn.argtypes = sgm_cuda._library().sgm_aggregate_pass.argtypes
        fn.restype = ctypes.c_int

        def launch(horizontal, addend, dest):
            if fn(vol.data_ptr(), addend, dest.data_ptr(), H_, W_, D_, D_,
                  p1, p2, 1, horizontal, stream):
                raise RuntimeError(f"variant {name} failed to launch")

        res[name] = {
            "vertical_ms": cuda_ms(lambda: launch(0, None, vsum), batch=10),
            "horizontal_ms": cuda_ms(lambda: launch(1, vsum.data_ptr(), out),
                                     batch=10)}
    return res


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = SlamConfig().sgbm
    p1, p2 = cfg.p1 / 16.0, cfg.p2 / 16.0
    D = cfg.num_disparities
    row = {"name": "sgm_aggregate4", "route": "cuda",
           "source": "semantic_slam_mapping_torch/csrc/sgm_aggregate.cu",
           "replaces": "semantic_slam_mapping_tpu/ops/pallas/sgm_pallas.py:74",
           "library_ms": None}
    errs = []
    for shape in SGM_SMALL:
        small = torch.rand(shape, generator=gen, device="cuda") * 200.0
        for dt in (torch.float32, torch.bfloat16):
            errs.append(check_sgm(small.to(dt), 7.0, 50.0, "small"))
    base = torch.rand((H, W, D), generator=gen, device="cuda") * 200.0
    for dt in (torch.float32, torch.bfloat16):
        errs.append(check_sgm(base.to(dt).contiguous(), p1, p2, "main"))

    # times on the main path's input: the bf16 volume, each launch alone
    # and the two together
    vol = base.to(torch.bfloat16).contiguous()
    vsum, out = torch.empty_like(vol), torch.empty_like(vol)
    vertical_ms = cuda_ms(lambda: sgm_cuda.sgm_pass(
        vol, vsum, D, p1, p2, horizontal=False), batch=10)
    horizontal_ms = cuda_ms(lambda: sgm_cuda.sgm_pass(
        vol, out, D, p1, p2, horizontal=True, addend=vsum), batch=10)
    variants = sgm_variant_ms(vol, p1, p2)
    ms = cuda_ms(lambda: sgm_cuda.sgm_aggregate4(vol, p1, p2), batch=10)
    plain_ms = cuda_ms(lambda: sgm_cuda.sgm_aggregate4_plain(vol, p1, p2),
                       warmup=1, reps=5)
    # the contract's bytes: the volume read once, the aggregate (in the
    # volume's dtype) written once
    n_bytes = 2 * vol.numel() * vol.element_size()
    n_ops = vol.numel() * SGM_OPS_PER_ELEMENT
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S
    row.update(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit("kernels", kernel="sgm_aggregate4", dtype="bfloat16",
         shape=[H, W, D], ms=ms, vertical_ms=vertical_ms,
         horizontal_ms=horizontal_ms, variants_ms=variants, plain_ms=plain_ms,
         bound_ms=row["bound_ms"], bound_by=row["bound_by"], bytes=n_bytes,
         ops=n_ops, library_ms=None)
    return row


def render_frames(cfg: SlamConfig):
    K = Intrinsics.from_config(cfg.camera)
    gen = torch.Generator(device="cuda").manual_seed(0)
    world = synthetic.make_world(gen, n_boxes=14, with_moving_box=True,
                                 device="cuda")
    poses = synthetic.straight_trajectory(N_FRAMES, speed=0.8, device="cuda")
    seq = synthetic.render_sequence(K, world, poses, H, W)
    # frames reach the system from the host, as a dataset reader gives them
    frames = list(zip(seq["left"].cpu().numpy(), seq["right"].cpu().numpy()))
    return (frames, seq["poses"].cpu().numpy().astype(np.float64),
            seq["moving"])


def segnet_config() -> SlamConfig:
    """The default configuration with online SegNet (full width, seeded
    weights)."""
    cfg = SlamConfig()
    return cfg.replace(segnet=dataclasses.replace(cfg.segnet, online=True))


def phase_slice(card: str):
    cfg = segnet_config()
    t = time.time()
    frames, gt, gt_moving = render_frames(cfg)
    torch.cuda.synchronize()
    emit("slice", step="rendered", frames=len(frames), shape=[H, W],
         seconds=round(time.time() - t, 2))

    # warm-up: one tracked frame, its keyframe's SegNet and cloud
    warm = SlamSystem(cfg, enable_mapping=True, device="cuda")
    for left, right in frames[:2]:
        warm.process_frame(left, right)
    warm.finish()
    torch.cuda.synchronize()

    # sgbm.compute looks _aggregate up at each call: record the dtype of
    # every aggregate the main path makes
    agg_dtypes = []
    aggregate = sgbm._aggregate

    def recording_aggregate(vol, sgbm_cfg):
        agg = aggregate(vol, sgbm_cfg)
        agg_dtypes.append(agg.dtype)
        return agg

    system = SlamSystem(cfg, enable_mapping=True, device="cuda")
    sgbm._aggregate = recording_aggregate
    try:
        sgm_cuda.sgm_aggregate4.launches = 0
        t = time.time()
        system.process_stream(frames, depth=6)
        torch.cuda.synchronize()
        seconds = time.time() - t
        launches = {"sgm_aggregate4": sgm_cuda.sgm_aggregate4.launches}
    finally:
        sgbm._aggregate = aggregate
    system._drain_all()

    tracked = N_FRAMES - 1
    if launches["sgm_aggregate4"] != 2 * tracked:
        raise AssertionError(f"sgm_aggregate4 launched "
                             f"{launches['sgm_aggregate4']} times for "
                             f"{tracked} tracked frames, expected 2 each")
    if agg_dtypes != [torch.bfloat16] * tracked:
        raise AssertionError(f"SGM aggregates of the main path: {agg_dtypes}"
                             f", expected {tracked} in bfloat16")
    log = system.frame_log
    if len(log) != tracked or not all(f.vo_success for f in log):
        raise AssertionError(f"VO failed on a frame: {log}")
    est = np.stack(system.trajectory)
    if not np.all(np.isfinite(est)):
        raise AssertionError("non-finite pose in the trajectory")
    ate = ate_rmse(est, gt)
    last = system.last_result
    on_card = [last.pose, last.moving_mask, last.disparity,
               last.matches.lc, system.state.pose,
               *(k.semantic_dev for k in system.keyframes)]
    if not all(x is not None and x.device.type == "cuda" for x in on_card):
        raise AssertionError("a result of the main path or a keyframe's "
                             "SegNet labels are not on the card")
    timer = system.timer.summary()
    mov, mov_gt = last.moving_mask, gt_moving[-1]
    iou = float((mov & mov_gt).sum()) / max(float((mov | mov_gt).sum()), 1.0)
    emit("slice", frames=N_FRAMES, tracked=tracked,
         seconds=seconds, frames_per_s=N_FRAMES / seconds,
         ms_per_tracked_frame=seconds / tracked * 1e3,
         launches=launches, aggregate_dtype="bfloat16", ate_rmse_m=ate,
         ate_bound_m=ATE_BOUND_M,
         n_inliers=[f.n_inliers for f in log],
         n_matches=[f.n_matches for f in log],
         moving_px_per_frame=[f.n_moving for f in log],
         last_frame_moving_px=int(mov.sum()),
         last_frame_gt_moving_px=int(mov_gt.sum()),
         last_frame_moving_iou=iou, keyframes=len(system.keyframes),
         map_voxels=len(system.map),
         kf_segnet_host_ms=timer["kf/segnet"]["mean_ms"],
         kf_segnet_calls=timer["kf/segnet"]["calls"],
         first_keyframe_label_counts=np.bincount(
             system.keyframes[0].semantic.reshape(-1).astype(np.int64),
             minlength=12).tolist(),
         card=card)
    if not ate < ATE_BOUND_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_BOUND_M} m")
    if timer["kf/segnet"]["calls"] != len(system.keyframes) or \
            not len(system.map):
        raise AssertionError("online SegNet did not label every keyframe "
                             "or the map is empty")
    return launches, frames, system


def phase_stages(frames) -> None:
    """Milliseconds of each stage of one frontend step (CUDA events)."""
    cfg = SlamConfig()
    K = Intrinsics.from_config(cfg.camera)
    up = SlamSystem(cfg, device="cuda")._upload_gray
    cl, cr = up(frames[2][0]), up(frames[2][1])
    pl, pr = up(frames[1][0]), up(frames[1][1])
    gen = torch.Generator(device="cuda").manual_seed(0)
    vol = sgbm._cost_volume(cl, cr, cfg.sgbm)
    agg = sgbm._aggregate(vol, cfg.sgbm)
    disp, uniq = sgbm._wta_subpixel(agg, cfg.sgbm)
    valid = uniq & sgbm._lr_check(agg, disp, cfg.sgbm)
    sg = sgbm.compute(cl, cr, cfg.sgbm)
    d = torch.where(sg.valid, sg.disparity, 0.0)
    m = quadmatch.quad_match(cl, cr, pl, pr, cfg.quadmatch, cfg.gftt,
                             cfg.klt, d)
    res = vo.estimate_motion(m, K, gen, cfg.vo)
    pts = gstereo.triangulate_image(K, d, cfg.camera)
    state = tracker.TrackerState.initial(cfg, "cuda")

    def uv_stage():
        D = cfg.sgbm.num_disparities
        _, a, b = uvd.measure_pitch(d, sg.valid, pts.roi, K, D,
                                    cfg.uvdisparity)
        uvd.detect_moving_objects(d, sg.valid, pts.roi, m.lc,
                                  m.valid & res.inliers, m.lc,
                                  m.valid & ~res.inliers, K, D,
                                  cfg.uvdisparity, (a, b))

    stages = {
        "sgbm.cost_volume": lambda: sgbm._cost_volume(cl, cr, cfg.sgbm),
        "sgbm.aggregate(kernel)": lambda: sgbm._aggregate(vol, cfg.sgbm),
        "sgbm.wta_lr": lambda: sgbm._lr_check(
            agg, sgbm._wta_subpixel(agg, cfg.sgbm)[0], cfg.sgbm),
        "sgbm.speckle": lambda: sgbm._speckle_filter(disp, valid, cfg.sgbm),
        "sgbm.compute": lambda: sgbm.compute(cl, cr, cfg.sgbm),
        "quad_match": lambda: quadmatch.quad_match(
            cl, cr, pl, pr, cfg.quadmatch, cfg.gftt, cfg.klt, d),
        "vo.estimate_motion": lambda: vo.estimate_motion(m, K, gen, cfg.vo),
        "uvdisparity": uv_stage,
        "track_frame": lambda: tracker.track_frame(
            state, cl, cr, pl, pr, K, gen, cfg),
    }
    ms = {k: cuda_ms(f, warmup=1, reps=3) for k, f in stages.items()}
    emit("stages", ms=ms)

    # one frontend step under the profiler: device-busy time, against the
    # step's time with and without the profiler, and the kernels it
    # launches
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.time()
        tracker.track_frame(state, cl, cr, pl, pr, K, gen, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    step_ms = ms["track_frame"]
    emit("stages", profiled="track_frame", wall_ms_profiled=wall_ms,
         step_ms=step_ms, device_busy_ms=busy_ms if dev_events else None,
         device_idle_share=(1.0 - busy_ms / step_ms) if dev_events else None,
         device_events=len(dev_events), top_device_ms=dict(top))


def device_launches(fn) -> int:
    """CUDA kernels one call of fn launches (profiler count)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def loop_camera(height: int, width: int) -> SlamConfig:
    """The default configuration, its intrinsics scaled to the image size
    (KITTI's at 376x1248)."""
    cfg = SlamConfig()
    s = width / W
    cam = dataclasses.replace(cfg.camera, fx=cfg.camera.fx * s,
                              fy=cfg.camera.fy * s, cx=cfg.camera.cx * s,
                              cy=cfg.camera.cy * s)
    return cfg.replace(camera=cam)


def render_loop(cfg: SlamConfig, n_frames: int, height: int, width: int,
                device: str):
    """The epoch phase's sequence, rendered in chunks on ``device``:
    (host frames [(left, right, None, labels)], ground-truth poses); the
    labels are the renderer's, in int8."""
    K = Intrinsics.from_config(cfg.camera)
    gen = torch.Generator(device=device).manual_seed(7)
    world = synthetic.make_loop_world(gen, n_boxes=48, radius=LOOP_RADIUS_M,
                                      n_moving=6, device=device)
    poses = synthetic.loop_trajectory(n_frames, radius=LOOP_RADIUS_M,
                                      laps=LOOP_LAPS, pitch_amp=0.006,
                                      device=device)
    frames = []
    for start in range(0, n_frames, 25):
        seq = synthetic.render_sequence(K, world, poses[start:start + 25],
                                        height, width, start_index=start)
        frames += [(left, right, None, sem) for left, right, sem in zip(
            seq["left"].cpu().numpy(), seq["right"].cpu().numpy(),
            seq["semantic"].to(torch.int8).cpu().numpy())]
    return frames, poses.cpu().numpy().astype(np.float64)


def loop_vocabulary(cfg: SlamConfig, frames, device: str):
    """The vocabulary of the sequence itself: ORB descriptors of every
    VOCAB_EVERY-th frame, clustered to branching 10, depth 4."""
    up = SlamSystem(cfg, device=device)._upload_gray
    descs = []
    for frame in frames[::VOCAB_EVERY]:
        f = orb.extract(up(frame[0]), cfg.orb)
        descs.append(f.desc[f.valid].cpu().numpy())
    return looper.build_vocabulary(np.concatenate(descs), branching=10,
                                   depth=4)


class CallCounter:
    """Counts the calls of module functions during a run (to give the
    epoch's calls per keyframe of each kernel candidate)."""

    def __init__(self, targets):
        self.targets = targets        # {name: (module, attribute)}
        self.calls = {name: 0 for name in targets}
        self.saved = {}

    def __enter__(self):
        for name, (mod, attr) in self.targets.items():
            fn = getattr(mod, attr)
            self.saved[name] = fn

            def counted(*a, _fn=fn, _name=name, **k):
                self.calls[_name] += 1
                return _fn(*a, **k)
            setattr(mod, attr, counted)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.saved[name])


def run_epoch(cfg: SlamConfig, frames, vocab, device: str):
    """The main path: process_stream(depth=6) then finish(), with the
    kernel launch counts zeroed just before and read just after."""
    system = SlamSystem(cfg, vocab=vocab, enable_mapping=True,
                        device=device)
    counter = CallCounter({
        "solve_pnp_lazy": (pnp, "solve_pnp_lazy"),
        "transform_sparse": (looper, "transform_sparse"),
        "optimize": (pg, "optimize"),
        "_kf_cloud": (pipeline, "_kf_cloud")})
    with counter:
        sgm_cuda.sgm_aggregate4.launches = 0
        t = time.time()
        system.process_stream(frames, depth=6)
        if device == "cuda":
            torch.cuda.synchronize()
        stream_s = time.time() - t
        globals_before_finish = system.n_global_optimizations
        traj = system.finish()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.time() - t
        launches = {"sgm_aggregate4": sgm_cuda.sgm_aggregate4.launches}
    return dict(system=system, traj=traj, stream_s=stream_s,
                seconds=seconds, launches=launches, calls=counter.calls,
                globals_before_finish=globals_before_finish)


def profile_epoch(system: SlamSystem) -> dict:
    """One keyframe epoch in isolation, under the profiler: a keyframe
    inserted at the newest frame and all its deferred work drained, on an
    idle card. Device-busy time against the host wall time."""
    out, (left, right) = system.last_result, system._prev
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.time()
        system._insert_keyframe(out, system.trajectory[-1], left, right)
        system._drain_all()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_events": len(dev)}


def phase_epoch(card: str, device: str = "cuda", height: int = H,
                width: int = W, n_frames: int = N_EPOCH) -> dict:
    cfg = loop_camera(height, width)
    t = time.time()
    frames, gt = render_loop(cfg, n_frames, height, width, device)
    emit("epoch", step="rendered", frames=len(frames),
         shape=[height, width], seconds=round(time.time() - t, 2))
    t = time.time()
    vocab = loop_vocabulary(cfg, frames, device)
    emit("epoch", step="vocabulary", leaves=vocab.n_leaves,
         seconds=round(time.time() - t, 2))

    run = run_epoch(cfg, frames, vocab, device)
    system, traj = run["system"], run["traj"]
    tracked = n_frames - 1
    kfs = system.keyframes
    ate = ate_rmse(traj, gt)
    n_kf = max(len(kfs), 1)
    map_fields = map_report(system)
    fields = dict(
        frames=n_frames, tracked=tracked, shape=[height, width],
        seconds=run["seconds"], stream_seconds=run["stream_s"],
        frames_per_s=n_frames / run["seconds"],
        ms_per_frame=run["seconds"] / n_frames * 1e3,
        launches=run["launches"], keyframes=len(kfs),
        edges=system.n_edges, loop_edges=system.n_loop_edges,
        loop_candidate_inliers=system.loop_candidate_inliers,
        loop_edge_inliers=system.loop_edge_inliers,
        loop_verify_log=system.loop_verify_log,
        global_optimizations=system.n_global_optimizations,
        global_optimizations_before_finish=run["globals_before_finish"],
        local_optimizations=system.n_local_optimizations,
        recoveries=system.n_recoveries,
        vo_failures=sum(not f.vo_success for f in system.frame_log),
        calls=run["calls"],
        calls_per_keyframe={k: v / n_kf for k, v in run["calls"].items()},
        ate_rmse_m=ate, ate_bound_m=EPOCH_ATE_BOUND_M,
        ate_rmse_odometry_m=ate_rmse(np.stack(system.trajectory), gt),
        timer={k: {"calls": v["calls"], "mean_ms": v["mean_ms"],
                   "total_s": v["total_s"]}
               for k, v in system.timer.summary().items()},
        **map_fields, card=card)
    if device == "cuda":
        fields["profiled_epoch"] = profile_epoch(system)
    emit("epoch", **fields)

    if device == "cuda" and run["launches"]["sgm_aggregate4"] != 2 * tracked:
        raise AssertionError(f"sgm_aggregate4 launched "
                             f"{run['launches']['sgm_aggregate4']} times "
                             f"for {tracked} tracked frames, expected 2 "
                             "each")
    if len(kfs) < 10:
        raise AssertionError(f"{len(kfs)} keyframes, expected >= 10")
    if system.n_loop_edges < 1:
        raise AssertionError("no loop edge was accepted")
    if run["globals_before_finish"] < 1:
        raise AssertionError("no global optimisation before finish()")
    if not np.all(np.isfinite(traj)) or not ate < EPOCH_ATE_BOUND_M:
        raise AssertionError(f"ATE {ate} m >= {EPOCH_ATE_BOUND_M} m")
    if map_fields["map_voxels"] <= EPOCH_MIN_VOXELS:
        raise AssertionError(f"map of {map_fields['map_voxels']} voxels, "
                             f"expected more than {EPOCH_MIN_VOXELS}")
    if map_fields["excluded_class_voxels"]:
        raise AssertionError("a voxel of an excluded class is in the map")
    if not map_fields["pcd_reads_back"]:
        raise AssertionError(f"the PCD holds {map_fields['pcd_points']} "
                             f"points ({map_fields['pcd_bytes']} bytes) for "
                             f"{map_fields['map_voxels']} voxels")
    on_card = [*kfs[-1].feats_dev, *kfs[-1].bow_dev, system._db_idx,
               system._db_w, kfs[-1].left_dev]
    if device == "cuda" and not all(x.device.type == "cuda"
                                    for x in on_card):
        raise AssertionError("keyframe features or the BoW database are "
                             "not on the card")
    return {"launches": run["launches"], "system": system,
            "calls": run["calls"], "vocab": vocab}


def map_report(system: SlamSystem) -> dict:
    """The epoch's map: voxel count, labels, the PCD written and read
    back (its POINTS header and whether its size is one 16-byte point per
    voxel), and the bytes of the keyframe clouds read back."""
    _, rgb, lbl = system.map.as_arrays()
    n_voxels = len(system.map)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "map.pcd"
        system.map.save_pcd(str(path))
        data = path.read_bytes()
    head = data[:data.index(b"DATA binary\n")].decode()
    points = int(head.split("POINTS ")[1].split()[0])
    # each keyframe's cloud comes back as a power-of-two prefix (>= 256
    # rows) of int16 xyz, u8 rgb and i8 label: 10 bytes a row
    budget = system.cfg.mapper.max_points_per_frame
    rows = [min(budget, max(256, 1 << int(np.ceil(np.log2(max(len(c[0]),
                                                               1))))))
            for c in system._cloud_cache.values()]
    fields = dict(
        map_voxels=n_voxels, map_updates=system._map_updates,
        map_label_counts=np.bincount(lbl, minlength=12).tolist(),
        map_mean_rgb=rgb.mean(0).tolist() if n_voxels else None,
        pcd_bytes=len(data), pcd_points=points,
        cloud_points_per_keyframe=[len(c[0]) for c in
                                   system._cloud_cache.values()],
        cloud_readback_bytes_per_keyframe=10 * float(np.mean(rows)),
        excluded_class_voxels=int(
            np.isin(lbl, semantics.MAP_EXCLUDED_CLASSES).sum()),
        pcd_reads_back=bool(points == n_voxels and len(data) == len(head)
                            + len(b"DATA binary\n") + 16 * points))
    return fields


def phase_candidates(epoch: dict) -> None:
    """Card time and launches of the epoch's kernel candidates (K7-K10 of
    ROADMAP.md, and the keyframe cloud) at the epoch's own shapes: the
    newest keyframe against the five before it, its BoW, one global solve
    of the final graph, and its cloud."""
    system, vocab = epoch["system"], epoch["vocab"]
    cfg, K = system.cfg, system.K
    kfs = system.keyframes
    kf, refs = kfs[-1], kfs[-6:-1]
    n_kf = len(kfs)
    kf_xy, kf_desc, _, kf_val = kf.feats_on(system.device)
    xy_r, desc_r, xyz_r, val_r = (torch.stack(x) for x in zip(
        *[r.feats_on(system.device) for r in refs]))
    T_init = torch.from_numpy(np.stack([
        np.linalg.inv(np.linalg.inv(r.pose) @ kf.pose).astype(np.float32)
        for r in refs])).to(system.device)
    feats = orb.extract(kf.left_dev.float(), cfg.orb)  # the BoW's input
    vocab = vocab.to(system.device)
    g, table, mask = final_graph(system)
    cloud_args = keyframe_cloud_inputs(system)

    cands = {
        "K7 hamming_matrix+knn2_ratio": (
            lambda: matching.knn2_ratio(matching.hamming_matrix(
                desc_r, kf_desc, val_r, kf_val), cfg.orb.knn_match_ratio),
            lambda: torch.cdist(desc_r.float(), kf_desc.float(), p=0),
            "solve_pnp_lazy"),
        "K8 solve_pnp_lazy (5 refs)": (
            lambda: pnp.solve_pnp_lazy(desc_r, xyz_r, val_r, kf_desc, kf_xy,
                                       kf_val, K, T_init, cfg.pnp,
                                       cfg.orb.knn_match_ratio),
            None, "solve_pnp_lazy"),
        "K9 transform_sparse": (
            lambda: looper.transform_sparse(vocab, feats.desc, feats.valid,
                                            cfg.looper.scoring_level),
            None, "transform_sparse"),
        "K10 optimize (global)": (
            lambda: pg.optimize(g, mask, cfg.pose_graph,
                                iters=cfg.pose_graph.global_iters,
                                table=table),
            None, "optimize"),
        "keyframe cloud (_kf_cloud)": (
            lambda: pipeline._kf_cloud(*cloud_args, K, cfg.mapper),
            None, "_kf_cloud"),
    }
    rows = {}
    for name, (fn, lib, calls_key) in cands.items():
        ms = cuda_ms(fn, warmup=1, reps=5)
        launches = device_launches(fn)
        per_kf = epoch["calls"][calls_key] / n_kf
        rows[name] = {
            "ms": ms, "launches_per_call": launches,
            "calls_per_keyframe": per_kf, "ms_per_keyframe": ms * per_kf,
            "launches_per_keyframe": launches * per_kf,
            "library_ms": cuda_ms(lib, warmup=1, reps=5) if lib else None}
    emit("candidates", keyframes=n_kf, graph_vertices=int(g.poses.shape[0]),
         graph_edges=int(g.edge_valid.sum()), rows=rows)


def keyframe_cloud_inputs(system: SlamSystem, device: str = "cuda"):
    """The cloud inputs of the newest keyframe with labels on ``device``:
    float16 disparity and gray image, no color, its labels, the newest
    frame's moving mask."""
    kf = next(k for k in reversed(system.keyframes)
              if k.disparity_dev is not None
              and (k.semantic_dev is not None or k.semantic_host is not None))
    labels = (kf.semantic_dev if kf.semantic_dev is not None
              else torch.from_numpy(kf.semantic_host))
    return tuple(x.to(device) if x is not None else None for x in (
        kf.disparity_dev, kf.left_dev, None, labels.long(),
        system.last_result.moving_mask))


def final_graph(system: SlamSystem):
    """The device graph, gather table and global mask that a global
    optimisation of the system's graph solves (as _maybe_optimize builds
    them)."""
    n = len(system.keyframes)
    nv, ne = 64, 128
    while nv < n:
        nv *= 2
    while ne < system.n_edges:
        ne *= 2
    host = pg.PoseGraph(*(a[:nv] if i < 2 else a[:ne]
                          for i, a in enumerate(system.graph)))
    table = pg.vertex_edge_table(host.edge_i, host.edge_j, host.edge_valid,
                                 nv)
    g = pg.PoseGraph(*(torch.from_numpy(np.ascontiguousarray(a))
                       .to(system.device) for a in host))
    return g, table, pg.global_free_mask(g)


def phase_segnet(slice_system: SlamSystem, frames, card: str) -> dict:
    """The full-width SegNet (bfloat16, the slice's seeded weights) alone
    on a (1, 384, 480, 3) input, and the online labelling of one KITTI-size
    keyframe (``_run_segnet``: resize, network, argmax, nearest resize
    back), by CUDA events, median of 15; launches per call by the
    profiler."""
    model = slice_system._segnet
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((1, *SEGNET_HW, 3), generator=gen, device="cuda")
    left = slice_system._upload_gray(frames[3][0])

    def net():
        with torch.no_grad():
            return model(x)

    def online():
        return slice_system._run_segnet(left)

    flops = segnet_mod.flops(model, *SEGNET_HW)
    n_params = sum(p.numel() for p in model.parameters())
    # the least bytes: the input and the float32 weights read once, the
    # float32 logits written once
    n_bytes = (x.numel() * 4 + n_params * 4
               + SEGNET_HW[0] * SEGNET_HW[1] * model.num_classes * 4)
    t_ops, t_bytes = flops / PEAK_BF16_S, n_bytes / PEAK_BYTES_S
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(net, warmup=3, reps=15)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    online_ms = cuda_ms(online, warmup=2, reps=15)
    row = dict(
        shape=[1, *SEGNET_HW, 3], dtype="bfloat16", width_mult=1.0,
        params=n_params, flops=flops, ms=ms,
        tflop_s=flops / (ms * 1e-3) / 1e12,
        share_of_bf16_peak=flops / (ms * 1e-3) / PEAK_BF16_S,
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        launches_per_call=device_launches(net),
        peak_memory_mb=peak_mb,
        run_segnet_ms=online_ms, run_segnet_input=[H, W],
        run_segnet_launches_per_call=device_launches(online),
        library_ms=None, card=card)
    emit("segnet", **row)
    return row


class Parity:
    """Card-against-CPU checks: each records its error and tolerance and
    raises on a miss."""

    def __init__(self):
        self.rows = {}

    def check(self, name: str, error: float, tolerance: float,
              **extra) -> None:
        ok = bool(error <= tolerance)
        self.rows[name] = {"error": error, "tolerance": tolerance, "ok": ok,
                           **extra}
        emit("parity", check=name, error=error, tolerance=tolerance, ok=ok,
             **extra)
        if not ok:
            raise AssertionError(f"parity {name}: error {error} > "
                                 f"tolerance {tolerance}")


def phase_parity(frames, system: SlamSystem, card_dev: str = "cuda") -> None:
    """The same inputs through the card and the host CPU. Tolerances are
    stated a priori: float rounding may differ between the devices (fused
    multiply-adds, reduction orders), so each check allows what that
    rounding can move and nothing an algorithmic difference would."""
    cfg = SlamConfig()
    K = Intrinsics.from_config(cfg.camera)
    par = Parity()
    upload = SlamSystem(cfg, device=card_dev)._upload_gray
    (pl, pr), (cl, cr) = frames[1], frames[2]
    img = {dev: [upload(x).to(dev) for x in (cl, cr, pl, pr)]
           for dev in (card_dev, "cpu")}

    # SGBM: disparity on the jointly valid pixels, and the masks
    sg = {dev: sgbm.compute(img[dev][0], img[dev][1], cfg.sgbm)
          for dev in img}
    gv, cv = sg[card_dev].valid.cpu(), sg["cpu"].valid
    both = gv & cv
    par.check("sgbm.compute disparity (jointly valid px)", float(
        (sg[card_dev].disparity.cpu() - sg["cpu"].disparity)[both].abs()
        .max()), 1e-3, valid_px=int(both.sum()))
    par.check("sgbm.compute valid-mask disagreement (share of px)",
              float((gv != cv).float().mean()), 1e-3)

    # argmin over D of a bf16 aggregate with planted ties: the first
    # minimum on both devices
    gen = torch.Generator().manual_seed(0)
    agg = (torch.rand((H, W, cfg.sgbm.num_disparities), generator=gen)
           * 1000 + 10).to(torch.bfloat16)
    d1 = torch.randint(0, 40, (H, W, 1), generator=gen)
    d2 = d1 + torch.randint(1, 40, (H, W, 1), generator=gen)
    agg.scatter_(-1, d1, 0.0)
    agg.scatter_(-1, d2, 0.0)
    for dev in (card_dev, "cpu"):
        wrong = int((torch.argmin(agg.to(dev), dim=-1).cpu()
                     != d1[..., 0]).sum())
        par.check(f"argmin bf16 ties on {dev}: pixels not at the first "
                  "minimum", wrong, 0)

    # quad matching on the same images and disparity (the CPU's)
    disp = torch.where(sg["cpu"].valid, sg["cpu"].disparity, 0.0)
    qm = {dev: quadmatch.quad_match(*img[dev], cfg.quadmatch, cfg.gftt,
                                    cfg.klt, disp.to(dev))
          for dev in img}
    mg = [x.cpu() for x in qm[card_dev]]
    mc = list(qm["cpu"])
    same_slot = mg[4] & mc[4] & (mg[2] == mc[2]).all(-1)
    n_valid = max(int(mg[4].sum()), int(mc[4].sum()), 1)
    par.check("quad_match: valid matches not matched on the other device "
              "(share)", 1.0 - float(same_slot.sum()) / n_valid, 0.02,
              valid=[int(mg[4].sum()), int(mc[4].sum())])
    leg_err = max(float((a - b)[same_slot].abs().max())
                  for a, b in zip(mg[:4], mc[:4]))
    par.check("quad_match: points of common matches (px)", leg_err, 0.05)

    # VO with fixed samples, on the same matches (the CPU's)
    picks = vo._distinct3(torch.Generator().manual_seed(1),
                          mc[4].sum(), cfg.vo.ransac_iters)
    res = {dev: vo.estimate_motion(vo.QuadMatches(*(x.to(dev) for x in mc)),
                                   K, None, cfg.vo, picks=picks)
           for dev in (card_dev, "cpu")}
    par.check("estimate_motion pose (fixed picks)", float(
        (res[card_dev].T_delta.cpu() - res["cpu"].T_delta).abs().max()), 1e-4,
        inliers=[int(res[d].n_inliers) for d in res])

    # ORB on the same image
    fo = {dev: orb.extract(img[dev][0], cfg.orb) for dev in img}
    og, oc = [x.cpu() for x in fo[card_dev]], list(fo["cpu"])
    kg = {tuple(p) for p in og[0][og[5]].tolist()}
    kc = {tuple(p) for p in oc[0][oc[5]].tolist()}
    par.check("orb.extract: keypoints in one set only (share)",
              len(kg ^ kc) / max(len(kg), 1), 0.01,
              keypoints=[len(kg), len(kc)])
    same = og[5] & oc[5] & (og[0] == oc[0]).all(-1)
    par.check("orb.extract: angle of common keypoints (rad)", float(
        (og[2] - oc[2])[same].abs().max()), 1e-3)
    par.check("orb.extract: descriptor bits differing (share, common "
              "keypoints)", float((og[4] != oc[4])[same].float().mean()),
              0.005)

    # the PnP gate between the two frames: the current frame's features
    # with 3D from its disparity against the previous frame's, on the CPU's
    # features
    f_ref, xyz_ref, v_ref = pipeline.extract_features(img["cpu"][0], disp,
                                                      K, cfg.orb)
    f_cur = orb.extract(img["cpu"][2], cfg.orb)
    args = (f_ref.desc, xyz_ref, v_ref, f_cur.desc, f_cur.xy, f_cur.valid,
            torch.eye(4))
    pn = {dev: pnp.solve_pnp_lazy(*(a.to(dev) for a in args[:6]), K,
                                  args[6].to(dev), cfg.pnp,
                                  cfg.orb.knn_match_ratio)
          for dev in (card_dev, "cpu")}
    par.check("solve_pnp_lazy pose", float(
        (pn[card_dev].T.cpu() - pn["cpu"].T).abs().max()), 1e-4,
        inliers=[int(pn[d].n_inliers) for d in pn],
        matches=[int(pn[d].n_matches) for d in pn],
        success=[bool(pn[d].success) for d in pn])
    par.check("solve_pnp_lazy inliers (count difference)",
              abs(int(pn[card_dev].n_inliers) - int(pn["cpu"].n_inliers)), 0)

    # the pose-graph solve of the epoch's final graph: twice on the card,
    # identical; the CPU's result is printed beside it
    g, table, mask = final_graph(system)
    cfg_pg = system.cfg.pose_graph
    a = pg.optimize(g, mask, cfg_pg, iters=cfg_pg.global_iters, table=table)
    b = pg.optimize(g, mask, cfg_pg, iters=cfg_pg.global_iters, table=table)
    c = pg.optimize(pg.PoseGraph(*(x.cpu() for x in g)), mask.cpu(), cfg_pg,
                    iters=cfg_pg.global_iters, table=table)
    par.check("pose_graph.optimize: two card runs (max abs difference)",
              float((a.poses - b.poses).abs().max()), 0.0,
              card_vs_cpu=float((a.poses.cpu() - c.poses).abs().max()),
              vertices=len(system.keyframes))

    # the quantized cloud of one KITTI-size keyframe: float32 arithmetic
    # in the same order with true divisions on both devices, a stable sort
    card, host = (pipeline._kf_cloud(*keyframe_cloud_inputs(system, dev),
                                     system.K, system.cfg.mapper)
                  for dev in (card_dev, "cpu"))
    n = [int(card[3]), int(host[3])]
    wrong = sum(int((card[i][:n[1]].cpu() != host[i][:n[1]]).sum())
                for i in range(3))
    par.check("keyframe cloud: count difference", abs(n[0] - n[1]), 0,
              points=n)
    par.check("keyframe cloud: quantized entries differing", wrong, 0)

    # SegNet's 2x2 pooling on bf16 activations with planted ties: the
    # first maximal entry of each window on both devices
    act = torch.randint(0, 3, (1, 96, 120, 64), generator=gen).to(
        torch.bfloat16) * 0.75
    pools = {dev: segnet_mod.max_pool_with_indices(act.to(dev))
             for dev in (card_dev, "cpu")}
    win = act.reshape(1, 48, 2, 60, 2, 64)
    tied = ((win == win.amax((2, 4), keepdim=True)).sum((2, 4)) > 1)
    par.check("max_pool_with_indices with ties: indices differing", int(
        (pools[card_dev][1].cpu() != pools["cpu"][1]).sum()), 0,
        tied_window_share=float(tied.float().mean()))

    segnet_parity(par, frames, card_dev)


def segnet_parity(par: Parity, frames, card_dev: str) -> None:
    """SegNet on the card and the CPU with the same seeded full-width
    weights. One bfloat16 ConvBNRelu: all but 0.5% of the outputs equal
    and the rest within one bfloat16 ulp of the layer's largest output
    (float32 sums in another order round a bf16 tie either way, and
    BatchNorm and ReLU carry that ulp on). The labels of one frame through
    ``_run_segnet``: at least 99% of the pixels agree with the network in
    float32 (TF32 off). A random network in bfloat16 amplifies those
    one-ulp differences over its 27 layers until its labels are rounding
    noise (on the CPU its bf16 labels agree with its own float64 ones on
    73% of the pixels), so its card-against-CPU agreement is printed, not
    held."""
    gen = torch.Generator().manual_seed(5)
    model = segnet_mod.create(SegNetConfig(), torch.Generator().manual_seed(0))
    act = torch.rand((1, 96, 120, 64), generator=gen).to(torch.bfloat16)
    layer = model.blocks[1]
    with torch.no_grad():
        y = {dev: copy.deepcopy(layer).to(dev)(act.to(dev)).cpu().float()
             for dev in (card_dev, "cpu")}
    a, b = y[card_dev], y["cpu"]
    # one bf16 ulp at the layer's largest output
    ulp = 2.0 ** (float(torch.floor(torch.log2(b.abs().max()))) - 7)
    par.check("segnet ConvBNRelu bf16: outputs differing (share)",
              float((a != b).float().mean()), 0.005)
    par.check("segnet ConvBNRelu bf16: largest difference (in bf16 ulps "
              "of the largest output)", float((a - b).abs().max()) / ulp,
              1.0)

    labels = {}
    for dtype in ("float32", "bfloat16"):
        cfg = segnet_config()
        cfg = cfg.replace(segnet=dataclasses.replace(cfg.segnet, dtype=dtype))
        for dev in (card_dev, "cpu"):
            s = SlamSystem(cfg, device=dev)
            labels[dtype, dev] = s._run_segnet(
                s._upload_gray(frames[3][0])).cpu()
    agree = {d: float((labels[d, card_dev] == labels[d, "cpu"]).float()
                      .mean()) for d in ("float32", "bfloat16")}
    par.check("segnet labels of one frame, float32: pixels disagreeing "
              "(share)", 1.0 - agree["float32"], 0.01,
              bf16_agreement_printed_only=agree["bfloat16"],
              classes=int(labels["float32", "cpu"].unique().numel()))


def main() -> int:
    info = phase_device()
    phase_build()
    row = phase_kernels()
    _, frames, slice_system = phase_slice(info["card"])
    epoch = phase_epoch(info["card"])
    phase_segnet(slice_system, frames, info["card"])
    phase_stages(frames)
    phase_candidates(epoch)
    phase_parity(frames, epoch["system"])
    row["launches"] = epoch["launches"][row["name"]]
    print(json.dumps({"kernels": [row]}), flush=True)
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": info["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
