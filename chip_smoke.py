#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one flushed JSON line with the seconds elapsed:

1. ``device``: the card's name, count, and name and power limit from
   nvidia-smi. Fails when there is no CUDA device.
2. ``build``: compiles the kernel sources of the port's main path with
   nvcc for sm_90a into build/torch_kernels/ (``-Xptxas -v`` prints their
   registers and spills), and the C++ voxel map with g++.
3. ``kernels``: holds the SGM kernel against its plain PyTorch version on the
   card, exactly (tolerance 0) and in the volume's dtype, in float32 and
   bfloat16, at the command line's KITTI shape (376, 1241, 80), at an odd
   height (375, 1241, 80), at the synthetic phases' (376, 1248, 80), and
   at a few small and ragged shapes; and on a batch of frames, the
   window's (8, 376, 1241, 80) and a ragged (3, 37, 45, 13), where it must
   also equal B single calls and make exactly 2 launches a call. Then
   times the kernel at 1241, at 1248 and at the batch of 8, and each of
   its two launches, with CUDA events (median of 25 batches of 10 calls
   after 3 warm-ups; the 75 MB volume exceeds the 50 MB L2, so it runs
   cold), prints each launch's plan (blocks, blocks an SM holds, ring
   stages) at B = 1 and B = 8, and times the launches of variants built
   with one part switched off, to show what bounds it. Then the KLT
   kernel (``klt``): the quad match's 4 legs at the street window's shape
   (32 pairs at 376x1241, 512 GFTT features a frame, SGBM's stereo init)
   through the kernel and through its plain version on the card, each leg
   from the same points (positions within 1e-3 px where both track, status
   on 99.5% of the features), 4 launches a quad match; then the kernel's
   device time over the 4 legs (the profiler's), the wrapper's and the
   plain version's (CUDA events), and the bound.
4. ``cli``: the user's workflow through the command line, as subprocesses
   on the card that run ``semantic_slam_mapping_torch.cli`` as
   ``__main__`` (what ``python -m`` does) after zeroing the kernel counts,
   and print the counts when they exit. A KITTI-layout directory of 30
   frames at 376x1241 (a fixed-seed street at 0.8 m a frame; image_0/1/2
   and the renderer's labels written by the port's PNG codec with each
   row's filter chosen as libpng chooses it, poses.txt, and a
   parameters.txt with the KITTI 00-02 camera) goes through
   ``make-vocab``, ``slam --vocab --semantic-dir --gt --parameters`` and
   ``pnp``; a TUM-layout directory of the first 20 frames of the rgbd
   phase's course scaled to a room (radius 2 m) at 480x640 (TUM fr1
   intrinsics, 16-bit depth at TUM's 5000 a metre with no reading past
   10 m, groundtruth.txt) through ``rgbd --gt``. Each must exit 0 and
   write a trajectory of a row a frame whose ATE RMSE is under 0.3 m
   (slam), 1 m (pnp) or 0.3 m times the room's scale (rgbd); slam's
   traj.g2o must read back and it must print its frames/s line; SGM must
   run twice per tracked frame in slam and pnp. Prints frames/s, and the
   PNG decode time a frame of the reader and of one 376x1241 grey frame
   written with filter 0, with Paeth and with libpng's choice, on the host
   CPU.
5. ``rgbd``: the whole RGB-D system on the card: 200 frames at 480x640
   (TUM fr1 intrinsics) of the loop world at radius 10 m (1.25 laps, the
   revisit from frame 160), gray, depth and the renderer's labels through
   ``SlamSystem(cfg, vocab, rgbd=True, enable_mapping=True,
   device="cuda").process_stream_rgbd`` and ``finish()``, with the keyframe
   gating of the JAX package's RGB-D golden run (1.0 m, 0.4 rad). It must
   accept a loop edge, fire a global optimisation before ``finish``,
   finish with an ATE RMSE under 0.8 m and build a map with no voxel of an
   excluded class. Also times one ``track_frame_rgbd`` step.
6. ``slice``: renders 10 KITTI-size (376x1248) stereo frames of a
   fixed-seed synthetic street on the card and runs them through
   ``SlamSystem(cfg, enable_mapping=True, device="cuda").process_stream``
   with the default configuration (80 disparities, 11x11 window, bfloat16
   cost volume, 512 features, 200 RANSAC hypotheses), no vocabulary, and
   online SegNet at full width (VGG16, bfloat16, 384x480 input) with
   the weights the ``train`` phase trained. Every kernel launch count is zeroed just
   before and read just after; each kernel must have been launched, and
   every SGM aggregate of the run must be bfloat16. Every tracked frame
   must have a VO success, the trajectory's ATE RMSE against the rendered
   ground truth must be below 0.3 m, the results and the keyframes' SegNet
   labels must live on the card, and the map must have voxels.
7. ``epoch``: the whole stereo SLAM at KITTI size with the default
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
8. ``segnet``: times the full-width SegNet alone on a (1, 384, 480, 3)
   input and ``SlamSystem._run_segnet`` on one KITTI-size keyframe (CUDA
   events, median of 15), with its launches per call and its rate against
   the card's bfloat16 peak.
9. ``stages``: times each stage of one frontend step on the card, then
   profiles one step: device-busy time, idle share, launches, top kernels.
10. ``candidates``: card time and launches of the keyframe epoch's
   kernel candidates (Hamming matching, batched PnP, the vocabulary
   descent, the LM + PCG solve, the keyframe cloud) at the epoch's shapes,
   per call and per keyframe, beside one PyTorch call computing the same
   function where there is one.
11. ``window``: the throughput mode at the command line's size: 33
   frames of the street of ``cli`` (376x1241, 0.6 m a frame, fixed seed)
   with the renderer's labels, as 4 windows of B = 8 pairs overlapping by
   one frame, through ``SlamSystem(cfg, enable_mapping=True,
   device="cuda").process_window`` with the default configuration.
   Counts zeroed just before and read just after: the SGM kernel must run
   exactly twice a window and the KLT kernel 4 times. Every pair must have
   a VO success, the ATE RMSE must be under 0.3 m, every aggregate must be
   a (8, 376, 1241, 80)
   bfloat16 batch, the results and the keyframes' images and labels must
   be on the card, and the map must have voxels. The first 17 of the
   frames then go through ``process_stream``; both frames/s and both ATEs
   are printed. Last, one window's frontend is profiled: device-busy time,
   idle share and launches a frame.
12. ``parity``: runs SGBM, an argmin with planted ties, quad matching, VO
   with fixed samples, ORB, the PnP gate, the pose-graph solve, the
   quantized keyframe cloud, SegNet's pooling with planted ties, one
   bfloat16 SegNet layer and SegNet's labels of one frame on the card and
   on the host CPU with the same inputs from one KITTI-size frame pair or
   keyframe, and the pose-graph solve twice on the card; prints each
   tolerance and error, and raises on a miss. It also holds the
   8-direction (``full_dp``) aggregate of one volume on the card to the
   CPU's exactly, and batched SGBM on the card (4 and 8 directions) to
   per-frame SGBM on the card exactly.
13. ``train`` (run after ``rgbd``, before ``slice``: the slice, segnet and
   parity phases label with the network it trains): SegNet training, the
   recipe of the JAX package's full-width checkpoint: ``cli train-segnet --size 192 --width 1.0 --steps 600
   --batch 4`` as a subprocess on the card, which must reach a holdout
   mIoU of 0.85 and a held-out world mIoU of 0.80 (the JAX recipe reached
   0.953 and 0.928); prints both, the per-class recall, the wall and
   training seconds and steps/s. The trained network in float32 labels
   the held-out world batch on the card and the CPU (at most 0.1% of the
   pixels may differ) and, through ``SlamSystem._run_segnet``, a
   KITTI-size frame of the slice phase's street (its mIoU against the
   renderer's labels is printed). One float32 full-width train step from
   the same weights and batch is held card against CPU (tolerances in
   ``train_step_parity``), and one bfloat16 train step is timed at (4,
   192, 192, 3) and at the serving size (4, 384, 480, 3): CUDA events,
   launches, peak memory, share of the bf16 peak and the bound.

14. ``golden`` (run after ``window``): the first 60 frames of the JAX
   package's golden circuit (``golden.py``: 500 frames at 376x1248,
   radius 30 m, 1.25 laps, 6 movers) through ``golden_torch.py``'s
   functions: the seed-7 world read from
   ``golden_worlds/loop_s7_r30_b48_m6.json`` (the JAX package's own draw),
   rendered on the card and kept there as float16, a vocabulary of the
   sequence, each frame fed as a float32 tensor on the card with the
   renderer's labels, the map on, then ``finish()``. Counts zeroed just
   before and read just after: the SGM kernel must run exactly twice per
   tracked frame. The run must need no recovery, keep every excluded
   class out of the map, build a record with every key of
   ``GOLDEN_r05.json``, leave the newest frame at the last keyframe's
   pose (where ``finish()`` puts it, as the JAX package's does) and hold
   the other frames to an ATE RMSE under 0.56 m (2% of the 27.8 m driven).
   Prints the record's numbers (its ATE over every frame too) and the peak
   device memory.

15. ``mesh`` (run after ``golden``): the multi-device serving path on a
   world of one. ``parallel.mesh.initialize_distributed`` starts NCCL
   with one rank (a ``file://`` store in a temporary directory) and
   ``make_mesh(1, dp=1, tp=1)`` builds the (data, model) mesh. The window
   phase's 33 street frames at 376x1241 with the renderer's labels, as 4
   windows of B = 8, go through ``SlamSystem(cfg, vocab,
   enable_mapping=True, device="cuda")`` and through the same with
   ``mesh=mesh`` (a vocabulary of the street, so that loops are scored),
   each with ``finish()``, in turns: meshless, mesh, mesh, meshless.
   Counts zeroed just before the first mesh run and read just after: the SGM kernel must run exactly twice a window and every
   collective must have run. The mesh run must make the meshless run's
   keyframes, statuses, loop edges and optimisations, its poses within
   1e-4 of the meshless ones (equal is expected: one rank sums as one
   device), an ATE under 0.3 m, and map into the slab-sharded map. Then
   ``optimize_sharded`` against ``pose_graph.optimize`` on the street's
   graph and on a noisy 24-keyframe ring with loop edges (within 1e-4, two
   sharded solves identical), the sharded sparse BoW scan against
   ``get_possible_loops_sparse`` on the street's database and on a
   2048-row one (within 1e-6, masks equal), and ``ShardedGlobalMap``
   against the host ``GlobalMap`` on three clouds under its budget (voxel
   keys within 1%). Prints the four runs' frames/s, both ATEs, the
   collectives' calls and bytes, the card ms of one call of each at the
   path's shapes and the mesh run's collective time they add up to, and
   K1's launches. Then SegNet training sharded dp x tp
   (``parallel/sharded_segnet.py``): first ``cli train-segnet --mesh`` for
   50 steps at the ``train`` phase's size, width and batch as a
   subprocess, which joins a world of one alone (it must print the (1, 1)
   mesh line and its saved line, launch no SGM kernel, and write a
   ``segnet.pkl`` that ``load_checkpoint`` reads; its stderr lines, seconds
   and steps/s are printed); in the group, 3 sharded float32 steps against
   3 meshless ones from the same start on the same (4, 192, 192, 3)
   batches (TF32 off; the loss, the BatchNorm buffers and the parameters
   within the CPU tests' tolerances after each step); and the sharded
   bfloat16 step timed at (4, 192, 192, 3) and (4, 384, 480, 3) on the
   ``train`` phase's inputs (CUDA events, launches, each collective's calls
   and bytes a step, peak memory).

``python3 chip_smoke.py --phases kernels,window`` runs the named phases
only (after ``device`` and ``build``) and prints no result line: a quick
check while a kernel or a phase changes.

Then the kernels line ``{"kernels": [...]}``, the card's name and power
limit as nvidia-smi gives them, and last ``{"ok": true, "device": ...}``.
Any failure raises and the script exits non-zero without that last line.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from semantic_slam_mapping_torch import cli as cli_mod
from semantic_slam_mapping_torch import pipeline
from semantic_slam_mapping_torch.backend import looper, pnp
from semantic_slam_mapping_torch.backend import pose_graph as pg
from semantic_slam_mapping_torch.config import (CameraConfig, SegNetConfig,
                                                SlamConfig)
from semantic_slam_mapping_torch.frontend import quadmatch, tracker, vo
from semantic_slam_mapping_torch.frontend import rgbd_tracker
from semantic_slam_mapping_torch.frontend import uvdisparity as uvd
from semantic_slam_mapping_torch.geometry import se3, se3_np
from semantic_slam_mapping_torch.geometry import stereo as gstereo
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.io import png, synthetic
from semantic_slam_mapping_torch.io.gt_pose import (read_kitti_poses,
                                                    write_kitti_poses)
from semantic_slam_mapping_torch.io.kitti import KittiReader
from semantic_slam_mapping_torch.mapping import mapper, native, semantics
from semantic_slam_mapping_torch.models import segnet as segnet_mod
from semantic_slam_mapping_torch.ops import corners, klt, matching, orb, sgbm
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.ops.cuda import nvcc, sgm_cuda
from semantic_slam_mapping_torch.parallel import mesh as pmesh
from semantic_slam_mapping_torch.parallel import (sharded_bow,
                                                  sharded_frontend,
                                                  sharded_pcg,
                                                  sharded_segnet)
from semantic_slam_mapping_torch.parallel.sharded_map import ShardedGlobalMap
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils.metrics import ate_rmse

import golden_torch

T0 = time.time()
ROOT = Path(__file__).resolve().parent
H, W = 376, 1248
# KITTI 00-02's image width: the command line's frames
W_KITTI = 1241
# the cli phase: 30 frames of the street (at 20 the slam command's ATE read
# 0.70 m, median 0.16 m: finish() puts the newest frame at the last
# keyframe's pose, ROADMAP section 3), 20 of the room for rgbd; the TUM
# directory at 480x640
N_CLI, N_CLI_TUM = 30, 20
TUM_HW = (480, 640)
TUM_FR1 = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3)
# the cli phase's TUM directory: the rgbd course scaled to a room (the
# images do not change with the scale, every depth and translation is 0.2
# times as large: a loop of radius 2 m, most depths a few metres), its
# depth stored as TUM stores it, 5000 a metre, and no reading past 10 m, a
# Kinect-class sensor's reach. Unscaled, most of the course lies past any
# such range and both packages' trackers lose it (PERF.md, section 6)
TUM_DEPTH_SCALE = 5000.0
TUM_ROOM_SCALE = 0.2
TUM_MAX_RANGE_M = 10.0
PNP_ATE_BOUND_M = 1.0
# the rgbd phase: 200 frames of the loop world at radius 10 m
N_RGBD = 200
RGBD_RADIUS_M = 10.0
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
# the KLT kernel's check and times: the street window's 32 pairs, 512
# features a frame, the quad match's 4 legs; float32 operations a window
# pixel a level (template and gradient taps and sums, 20 iterations of a
# tap, a residual and two products, the final residual), and the patches a
# feature reads a level (template, two gradients and the target, 12x12
# float32 each)
KLT_B, KLT_N = 32, 512
KLT_OPS_PER_PIXEL_LEVEL = 33 + 20 * 14 + 12
KLT_BYTES_PER_FEATURE_LEVEL = 4 * 12 * 12 * 4
# the small checks: ragged lines, a single row, a pixel stride the wrapper
# pads, the widest D
SGM_SMALL = ((37, 24, 16), (24, 37, 16), (1, 7, 13), (33, 20, 13),
             (9, 40, 96))
# the train phase: the recipe of the JAX package's full-width checkpoint
# (segnet_w1.pkl's meta: 600 steps at 192 px, batch 4), the least mIoUs the
# port's run must reach (holdout, held-out world), and what the JAX recipe
# reached, read from that pickle's meta (quality numbers, not times)
TRAIN_SIZE, TRAIN_STEPS, TRAIN_BATCH = 192, 600, 4
TRAIN_MIN_MIOU = (0.85, 0.80)
JAX_W1_MIOU = (0.9532, 0.9280)
# the window phase: 33 frames as 4 windows of 8 pairs, at the cli
# phase's size
WINDOW_B = 8
N_WINDOW = 4 * WINDOW_B + 1
# the window phase's process_stream comparison: the first two windows
N_WINDOW_STREAM = 2 * WINDOW_B + 1
# the golden phase: the first 60 frames of the 500-frame golden circuit
# (0.471 m a frame), its ATE bound 2% of the 27.8 m driven in 59 steps,
# a libviso2-class odometry's drift
N_GOLDEN = 60
# cli train-segnet --mesh in the mesh phase
MESH_TRAIN_STEPS = 50
# the collectives of SlamSystem(mesh=...)
SERVING_COLLECTIVES = ("all_gather", "all_reduce_sum", "ring_exchange")
GOLDEN_ATE_BOUND_M = 0.56


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
    libs = [sgm_cuda.build(verbose=True), nvcc.build(klt.SOURCE, verbose=True)]
    nvcc_s = time.time() - t
    t = time.time()
    voxel_lib = native.build()
    emit("build", seconds=round(nvcc_s, 2),
         libraries=[lib.name for lib in libs],
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
        build = nvcc.BUILD_DIR / "variants"
        build.mkdir(parents=True, exist_ok=True)
        (build / f"{name}.cu").write_text(src.replace(old, new))
        lib = build / f"lib{name}.so"
        subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-o",
                        str(lib), str(build / f"{name}.cu")], check=True,
                       timeout=120)
        fn = ctypes.CDLL(str(lib)).sgm_aggregate_pass
        fn.argtypes = sgm_cuda._library().sgm_aggregate_pass.argtypes
        fn.restype = ctypes.c_int

        def launch(horizontal, addend, dest):
            if fn(vol.data_ptr(), addend, dest.data_ptr(), 1, H_, W_, D_,
                  D_, p1, p2, 1, horizontal, stream):
                raise RuntimeError(f"variant {name} failed to launch")

        res[name] = {
            "vertical_ms": cuda_ms(lambda: launch(0, None, vsum), batch=10),
            "horizontal_ms": cuda_ms(lambda: launch(1, vsum.data_ptr(), out),
                                     batch=10)}
    return res


def sgm_times(vol: torch.Tensor, p1: float, p2: float,
              plain_reps: int = 5) -> dict:
    """Milliseconds of the kernel, of each of its launches and of its plain
    version on a bf16 volume or batch, and the bound: the contract's bytes
    (the volume read once, the aggregate in its dtype written once) over
    the card's memory rate, or its float32 operations over the f32
    peak."""
    D = vol.shape[-1]
    vsum, out = torch.empty_like(vol), torch.empty_like(vol)
    n_bytes = 2 * vol.numel() * vol.element_size()
    n_ops = vol.numel() * SGM_OPS_PER_ELEMENT
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S
    return dict(
        shape=list(vol.shape),
        ms=cuda_ms(lambda: sgm_cuda.sgm_aggregate4(vol, p1, p2), batch=10),
        vertical_ms=cuda_ms(lambda: sgm_cuda.sgm_pass(
            vol, vsum, D, p1, p2, horizontal=False), batch=10),
        horizontal_ms=cuda_ms(lambda: sgm_cuda.sgm_pass(
            vol, out, D, p1, p2, horizontal=True, addend=vsum), batch=10),
        plain_ms=cuda_ms(lambda: sgm_cuda.sgm_aggregate4_plain(vol, p1, p2),
                         warmup=1, reps=plain_reps),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=n_bytes, ops=n_ops)


def check_sgm_batch(vol: torch.Tensor, p1: float, p2: float,
                    label: str) -> float:
    """check_sgm on a (B, H, W, D) batch, which must also make exactly 2
    launches and equal B single calls bit for bit."""
    before = sgm_cuda.sgm_aggregate4.launches
    out = sgm_cuda.sgm_aggregate4(vol, p1, p2)
    n_launches = sgm_cuda.sgm_aggregate4.launches - before
    singles = torch.stack([sgm_cuda.sgm_aggregate4(v, p1, p2) for v in vol])
    torch.cuda.synchronize()
    same = torch.equal(out, singles)
    emit("kernels", kernel="sgm_aggregate4", check=label,
         dtype=str(vol.dtype).split(".")[-1], shape=list(vol.shape),
         launches_per_call=n_launches, equals_single_calls=same)
    if n_launches != 2 or not same:
        raise AssertionError(f"sgm_aggregate4 on a batch ({label}, "
                             f"{vol.dtype}): {n_launches} launches, equal "
                             f"to {vol.shape[0]} single calls: {same}")
    return check_sgm(vol, p1, p2, label)


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
    # the command line's KITTI frames (odd-length rows), an odd height,
    # and the synthetic phases' width
    vols = {}
    for label, shape in (("kitti 376x1241", (H, W_KITTI, D)),
                         ("odd height 375x1241", (H - 1, W_KITTI, D)),
                         ("synthetic 376x1248", (H, W, D))):
        base = torch.rand(shape, generator=gen, device="cuda") * 200.0
        for dt in (torch.float32, torch.bfloat16):
            errs.append(check_sgm(base.to(dt).contiguous(), p1, p2, label))
        vols[label] = base.to(torch.bfloat16).contiguous()
        del base

    # the window's batch of 8 frames, and a ragged batch
    small = torch.rand((3, 37, 45, 13), generator=gen, device="cuda") * 200
    for dt in (torch.float32, torch.bfloat16):
        errs.append(check_sgm_batch(small.to(dt), 7.0, 50.0,
                                    "ragged batch 3x37x45x13"))
    base = torch.rand((WINDOW_B, H, W_KITTI, D), generator=gen,
                      device="cuda") * 200.0
    for dt in (torch.float32, torch.bfloat16):
        errs.append(check_sgm_batch(base.to(dt).contiguous(), p1, p2,
                                    f"batch {WINDOW_B}x376x1241"))
    batch = base.to(torch.bfloat16).contiguous()
    del base
    plans = {f"B={b} {'horizontal' if hz else 'vertical'}":
             sgm_cuda.launch_plan((b, H, W_KITTI, D), torch.bfloat16, hz)
             for b in (1, WINDOW_B) for hz in (False, True)}
    emit("kernels", kernel="sgm_aggregate4", launch_plans=plans,
         sms=torch.cuda.get_device_properties(0).multi_processor_count)

    # times on the main path's input (the command line's bf16 volume at
    # 376x1241), at the synthetic phases' 1248 and on the window's batch
    kitti = sgm_times(vols["kitti 376x1241"], p1, p2)
    synth = sgm_times(vols["synthetic 376x1248"], p1, p2)
    window = sgm_times(batch, p1, p2, plain_reps=3)
    variants = sgm_variant_ms(vols["kitti 376x1241"], p1, p2)
    row.update(max_abs_err=max(errs), ms=kitti["ms"],
               plain_ms=kitti["plain_ms"], bound_ms=kitti["bound_ms"],
               bound_by=kitti["bound_by"], shape=kitti["shape"],
               ms_w1248=synth["ms"], bound_ms_w1248=synth["bound_ms"],
               ms_batch8=window["ms"], plain_ms_batch8=window["plain_ms"],
               bound_ms_batch8=window["bound_ms"],
               shape_batch8=window["shape"])
    for t in (kitti, synth, window):
        emit("kernels", kernel="sgm_aggregate4", dtype="bfloat16", **t,
             library_ms=None)
    emit("kernels", kernel="sgm_aggregate4", shape=kitti["shape"],
         variants_ms=variants)
    return row


def klt_window(device: str = "cuda") -> dict:
    """The quad match's inputs at the street window's size: KLT_B pairs of
    the window phase's street at 376x1241, their pyramids, KLT_N GFTT
    features a frame, their stereo (SGBM) init and the first window's
    flow prior (zero: no motion yet)."""
    cfg = SlamConfig()
    lefts, rights, _, _ = render_street(cfg, KLT_B + 1, H, W_KITTI, device)
    img = {k: torch.from_numpy(v).to(device).float() for k, v in (
        ("lc", lefts[1:]), ("rc", rights[1:]), ("lp", lefts[:-1]),
        ("rp", rights[:-1]))}
    sg = sgbm.compute(img["lc"], img["rc"], cfg.sgbm)
    lc = corners.gftt(img["lc"], max_corners=KLT_N).xy
    d0 = im.bilinear_sample(torch.where(sg.valid, sg.disparity, 0.0),
                            lc).clamp(min=0.0)
    return dict(pyr={k: im.build_pyramid(v, cfg.klt.pyramid_levels, 2.0)
                     for k, v in img.items()}, lc=lc,
                stereo=torch.stack([-d0, torch.zeros_like(d0)], -1),
                flow=torch.zeros_like(lc), cfg=cfg.klt)


def klt_legs(w: dict, track) -> list:
    """The quad match's 4 legs (lc -> rc -> rp -> lp and lc -> lp) with
    ``track`` (the kernel's wrapper or the plain version)."""
    p, cfg = w["pyr"], w["cfg"]
    rc = track(p["lc"], p["rc"], w["lc"], cfg, w["stereo"])
    rp = track(p["rc"], p["rp"], rc.xy, cfg, w["flow"])
    lp = track(p["rp"], p["lp"], rp.xy, cfg)
    return [rc, rp, lp, track(p["lc"], p["lp"], w["lc"], cfg, w["flow"])]


def klt_kernel_ms(w: dict, reps: int = 10) -> float:
    """Device milliseconds of the 4 legs' kernel launches alone (the
    profiler's time of ``klt_track_kernel``, over ``reps`` quad matches);
    the wrapper's time adds the gradient images it computes in PyTorch."""
    klt_legs(w, klt.track_pyramid)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            klt_legs(w, klt.track_pyramid)
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or getattr(
        e, "cuda_time_total", 0) for e in prof.key_averages()
        if "klt_track_kernel" in e.key)
    if not us:
        raise AssertionError("the profiler saw no klt_track_kernel time")
    return us / reps / 1e3


def phase_klt() -> dict:
    """The KLT kernel against its plain version on the card at the
    window's shape (each leg from the same points and inits: positions
    within 1e-3 px where both track, status on 99.5% of the features, the
    tolerances of tests/test_torch_klt_cuda.py), then both timed over the 4
    legs, beside the bound."""
    w = klt_window()
    p, cfg = w["pyr"], w["cfg"]
    before = klt.track_pyramid.launches
    kern = klt_legs(w, klt.track_pyramid)
    launches = klt.track_pyramid.launches - before
    # each leg of the plain version from the kernel's points, so that a
    # leg's comparison starts from the same inputs
    srcs = [("lc", "rc", w["lc"], w["stereo"]),
            ("rc", "rp", kern[0].xy, w["flow"]),
            ("rp", "lp", kern[1].xy, None), ("lc", "lp", w["lc"], w["flow"])]
    legs = []
    for (a, b, pts, init), k in zip(srcs, kern):
        ref = klt.track_pyramid_plain(p[a], p[b], pts, cfg, init)
        torch.cuda.synchronize()
        both = k.status & ref.status
        leg = dict(leg=f"{a}->{b}",
                   status_agree=float((k.status == ref.status).float().mean()),
                   tracked=float(ref.status.float().mean()),
                   max_xy_err_px=float((k.xy - ref.xy).abs()[both].max()),
                   max_residual_err=float(
                       (k.error - ref.error).abs()[both].max()))
        legs.append(leg)
        emit("kernels", kernel="klt_track", check="window", **leg,
             shape=[KLT_B, KLT_N], xy_tolerance=1e-3, status_floor=0.995)
        if leg["status_agree"] < 0.995 or leg["max_xy_err_px"] > 1e-3:
            raise AssertionError(f"klt_track disagrees with its plain "
                                 f"version: {leg}")
    if launches != 4:
        raise AssertionError(f"klt_track: {launches} launches for 4 legs")

    feats = KLT_B * KLT_N * cfg.pyramid_levels * 4
    win_px = cfg.window_size ** 2
    n_bytes = feats * KLT_BYTES_PER_FEATURE_LEVEL
    n_ops = feats * win_px * KLT_OPS_PER_PIXEL_LEVEL
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S
    row = {"name": "klt_track", "route": "cuda",
           "source": "semantic_slam_mapping_torch/csrc/klt_track.cu",
           "replaces": None, "library_ms": None,
           "shape": [KLT_B, KLT_N], "legs": legs,
           "launches_per_quad_match": launches,
           "ms": klt_kernel_ms(w),
           "wrapper_ms": cuda_ms(lambda: klt_legs(w, klt.track_pyramid),
                                 batch=5),
           "plain_ms": cuda_ms(lambda: klt_legs(w, klt.track_pyramid_plain),
                               warmup=1, reps=5),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": n_bytes, "ops": n_ops}
    emit("kernels", **{k: v for k, v in row.items() if k != "legs"})
    return row


# Runs the port's command line as __main__ (what ``python -m`` does) with
# the SGM kernel's launch count zeroed first, and prints the count on
# stderr when the process exits.
CLI_BOOT = """\
import atexit, runpy, sys
from semantic_slam_mapping_torch.ops.cuda import sgm_cuda
sgm_cuda.sgm_aggregate4.launches = 0
atexit.register(lambda: print("sgm_aggregate4 launches",
                              sgm_cuda.sgm_aggregate4.launches,
                              file=sys.stderr, flush=True))
sys.argv = ["semantic_slam_mapping_torch.cli"] + sys.argv[1:]
runpy.run_module("semantic_slam_mapping_torch.cli", run_name="__main__",
                 alter_sys=True)
"""


def run_cli(args, device: str, timeout: int = 600) -> dict:
    """One command of the port's CLI in a subprocess: its exit code,
    seconds, output, the last stdout line as JSON (when it is one) and the
    SGM launches."""
    extra = [] if device == "cuda" else ["--device", device]
    t = time.time()
    res = subprocess.run([sys.executable, "-c", CLI_BOOT, *args, *extra],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    out = dict(command=args[0], rc=res.returncode,
               seconds=time.time() - t, stdout=res.stdout,
               stderr=res.stderr)
    m = re.search(r"^sgm_aggregate4 launches (\d+)$", res.stderr, re.M)
    out["sgm_launches"] = int(m.group(1)) if m else None
    lines = res.stdout.strip().splitlines()
    try:
        out["report"] = json.loads(lines[-1]) if lines else None
    except ValueError:
        out["report"] = None
    if res.returncode != 0:
        raise AssertionError(f"cli {args[0]} exited {res.returncode}:\n"
                             f"{res.stderr[-3000:]}")
    return out


def frame_ms(stderr: str):
    """Mean milliseconds of the "frame" stage in a StageTimer report."""
    m = re.search(r"^frame\s+\d+ calls\s+([\d.]+) ms/call", stderr, re.M)
    return float(m.group(1)) if m else None


def write_kitti_dir(root: Path, cfg: SlamConfig, n_frames: int, height: int,
                    width: int, device: str):
    """A KITTI-layout directory of the slice's street: image_0/1/2 and the
    renderer's labels as PNG with each row's filter chosen as libpng
    chooses it by default, poses.txt and parameters.txt. Returns the
    seconds spent writing PNGs a frame."""
    K = Intrinsics.from_config(cfg.camera)
    gen = torch.Generator(device=device).manual_seed(0)
    world = synthetic.make_world(gen, n_boxes=14, with_moving_box=True,
                                 device=device)
    poses = synthetic.straight_trajectory(n_frames, speed=0.8, device=device)
    for sub in ("image_0", "image_1", "image_2", "labels"):
        (root / sub).mkdir(parents=True)
    write_s = 0.0
    for start in range(0, n_frames, 10):
        seq = synthetic.render_sequence(K, world, poses[start:start + 10],
                                        height, width, start_index=start)
        u8 = {k: (seq[k].clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu()
              .numpy() for k in ("left", "right")}
        labels = seq["semantic"].to(torch.uint8).cpu().numpy()
        t = time.time()
        for i in range(len(labels)):
            name = f"{start + i:06d}.png"
            for sub, img in (("image_0", u8["left"][i]),
                             ("image_1", u8["right"][i]),
                             ("image_2", np.repeat(u8["left"][i][..., None],
                                                   3, -1)),
                             ("labels", labels[i])):
                png.write_png(root / sub / name, img, row_filter=None)
        write_s += time.time() - t
    write_kitti_poses(root / "poses.txt", poses.cpu().numpy())
    cam = cfg.camera
    (root / "parameters.txt").write_text(
        "# KITTI odometry 00-02\n"
        f"camera.fx={cam.fx}\ncamera.fy={cam.fy}\ncamera.cx={cam.cx}\n"
        f"camera.cy={cam.cy}\ncamera.baseline={cam.baseline}\n"
        f"start_index=0\nend_index={n_frames}\n")
    return write_s / n_frames


def tum_config(height: int, width: int) -> SlamConfig:
    """TUM fr1 intrinsics (scaled to the image size) and the keyframe
    gating of the JAX package's RGB-D golden run."""
    s = width / TUM_HW[1]
    cfg = SlamConfig()
    cam = CameraConfig(**{k: v * s for k, v in TUM_FR1.items()},
                       baseline=cfg.camera.baseline, scale=TUM_DEPTH_SCALE)
    return cfg.replace(camera=cam, pose_graph=dataclasses.replace(
        cfg.pose_graph, keyframe_min_translation=1.0,
        keyframe_min_rotation=0.4))


def render_rgbd_loop(cfg: SlamConfig, n_frames: int, height: int,
                     width: int, device: str, n_total: int = N_RGBD):
    """The first ``n_frames`` of the rgbd phase's course (``n_total``
    frames, 1.25 laps of the radius-10 loop world): host (gray, depth,
    int8 labels) frames and the ground-truth poses."""
    K = Intrinsics.from_config(cfg.camera)
    gen = torch.Generator(device=device).manual_seed(7)
    world = synthetic.make_loop_world(gen, n_boxes=48, radius=RGBD_RADIUS_M,
                                      n_moving=6, device=device)
    poses = synthetic.loop_trajectory(n_total, radius=RGBD_RADIUS_M,
                                      laps=LOOP_LAPS, pitch_amp=0.006,
                                      device=device)[:n_frames]
    frames = []
    for start in range(0, n_frames, 25):
        seq = synthetic.render_sequence(K, world, poses[start:start + 25],
                                        height, width, start_index=start)
        frames += list(zip(seq["left"].cpu().numpy(),
                           seq["depth"].cpu().numpy(),
                           seq["semantic"].to(torch.int8).cpu().numpy()))
    return frames, poses.cpu().numpy().astype(np.float64)


def depth_reading(depth: np.ndarray, depth_scale: float,
                  max_range_m: float | None = None) -> np.ndarray:
    """A depth map as a 16-bit sensor stores it: metres times
    ``depth_scale``, 0 (no reading) past ``max_range_m`` or past 16 bits."""
    d = np.round(depth.astype(np.float64) * depth_scale)
    ok = (d > 0) & (d < 65536)
    if max_range_m is not None:
        ok &= depth <= max_range_m
    return np.where(ok, d, 0).astype(np.uint16)


def room_course(frames, gt: np.ndarray, s: float = TUM_ROOM_SCALE):
    """A course of (gray, depth, labels) frames and poses scaled by ``s``:
    the same images, every depth and translation ``s`` times as large."""
    gt = gt.copy()
    gt[:, :3, 3] *= s
    return [(g, d * np.float32(s), lbl) for g, d, lbl in frames], gt


def write_tum_dir(root: Path, frames, gt: np.ndarray,
                  depth_scale: float = TUM_DEPTH_SCALE,
                  max_range_m: float | None = None) -> None:
    """A TUM-layout directory: rgb/ and 16-bit depth/ PNGs
    (``depth_reading``; each row's filter chosen as libpng chooses it),
    associate.txt and groundtruth.txt."""
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    assoc, lines = [], []
    for i, (gray, depth, _) in enumerate(frames):
        t = 1305031102.0 + i / 30.0
        g = (np.clip(gray, 0, 1) * 255 + 0.5).astype(np.uint8)
        png.write_png(root / "rgb" / f"{t:.6f}.png",
                      np.repeat(g[..., None], 3, -1), row_filter=None)
        png.write_png(root / "depth" / f"{t:.6f}.png",
                      depth_reading(depth, depth_scale, max_range_m),
                      row_filter=None)
        assoc.append(f"{t:.6f} rgb/{t:.6f}.png {t:.6f} depth/{t:.6f}.png")
        q = se3_np.rotation_to_quaternion(gt[i][:3, :3])
        x, y, z = gt[i][:3, 3]
        lines.append(f"{t:.6f} {x} {y} {z} {q[1]} {q[2]} {q[3]} {q[0]}")
    (root / "associate.txt").write_text("\n".join(assoc) + "\n")
    (root / "groundtruth.txt").write_text(
        "# timestamp tx ty tz qx qy qz qw\n" + "\n".join(lines) + "\n")


def png_filter_types(path: Path) -> np.ndarray:
    """The row filter type of each row of a PNG written by ``write_png``
    (one IDAT chunk, after IHDR and any tEXt chunks)."""
    data = path.read_bytes()
    pos, rows = 8, None
    while rows is None:
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            height = struct.unpack(">I", data[pos + 12:pos + 16])[0]
        elif kind == b"IDAT":
            raw = np.frombuffer(zlib.decompress(data[pos + 8:pos + 8 + n]),
                                np.uint8)
            rows = raw.reshape(height, -1)
        pos += 12 + n
    return rows[:, 0]


def png_decode_ms(frame: np.ndarray, tmp: Path) -> dict:
    """Host milliseconds to decode one frame written with filter 0 on
    every row, with Paeth on every row, and with each row's filter chosen
    as libpng chooses it (the directory's files), median of 5, and the
    share of each filter type in the last."""
    out = {}
    for name, f in (("none", 0), ("paeth", 4), ("adaptive", None)):
        path = tmp / f"decode_{name}.png"
        png.write_png(path, frame, row_filter=f)
        times = []
        for _ in range(5):
            t = time.perf_counter()
            img = png.read_png(path, "L")
            times.append((time.perf_counter() - t) * 1e3)
        if not np.array_equal(img, frame):
            raise AssertionError(f"PNG round trip ({name}) differs")
        out[f"{name}_ms"] = statistics.median(times)
    out.update(adaptive_filter_share=np.bincount(
        png_filter_types(path), minlength=5).tolist(),
        shape=list(frame.shape), host_cpus=os.cpu_count())
    return out


def phase_cli(card: str, device: str = "cuda", height: int = H,
              width: int = W_KITTI, n_frames: int = N_CLI,
              tum_hw=TUM_HW, tum_frames: int = N_CLI_TUM) -> dict:
    """The command line on a KITTI-layout and a TUM-layout directory."""
    # KITTI 00-02's camera, scaled for a rehearsal at another size
    cfg = SlamConfig() if width == W_KITTI else loop_camera(height, width)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        kitti = tmp / "kitti"
        write_ms = write_kitti_dir(kitti, cfg, n_frames, height, width,
                                   device) * 1e3
        reader = KittiReader(str(kitti), semantic_dir="labels")
        t = time.time()
        for i in range(5):
            reader.get(i)
        read_ms = (time.time() - t) / 5 * 1e3
        decode = png_decode_ms(png.read_png(kitti / "image_0" / "000000.png"),
                               tmp)
        emit("cli", step="kitti directory", frames=n_frames,
             shape=[height, width], png_write_ms_per_frame=write_ms,
             reader_ms_per_frame=read_ms, png_files_per_frame=4,
             png_decode_ms=decode)

        common = ["--data", str(kitti), "--gt", str(kitti / "poses.txt"),
                  "--parameters", str(kitti / "parameters.txt")]
        vocab = run_cli(["make-vocab", "--data", str(kitti), "--out",
                         str(tmp / "vocab"), "--stride", "3",
                         "--branching", "10", "--depth", "3"], device)
        slam = run_cli(["slam", *common, "--vocab",
                        str(tmp / "vocab" / "vocab.npz"),
                        "--semantic-dir", "labels", "--out",
                        str(tmp / "slam")], device)
        pnp_run = run_cli(["pnp", *common, "--out", str(tmp / "pnp")],
                          device)
        fps = re.search(r"^# (\d+) frames in ([\d.]+)s = ([\d.]+) fps$",
                        slam["stderr"], re.M)
        traj = read_kitti_poses(tmp / "slam" / "trajectory.txt")
        g2o = pipeline.load_g2o(str(tmp / "slam" / "traj.g2o"))
        pnp_traj = read_kitti_poses(tmp / "pnp" / "trajectory.txt")
        launches["cli slam"] = slam["sgm_launches"]
        launches["cli pnp"] = pnp_run["sgm_launches"]

        tum_cfg = tum_config(*tum_hw)
        frames, gt = room_course(*render_rgbd_loop(tum_cfg, tum_frames,
                                                   *tum_hw, device))
        cam = tum_cfg.camera
        tum = tmp / "tum"
        write_tum_dir(tum, frames, gt, TUM_DEPTH_SCALE, TUM_MAX_RANGE_M)
        # the command's own depth scale, TUM's 5000 a metre
        rgbd = run_cli([
            "rgbd", "--data", str(tum), "--gt", str(tum / "groundtruth.txt"),
            "--out", str(tmp / "rgbd"), "--fx", str(cam.fx), "--fy",
            str(cam.fy), "--cx", str(cam.cx), "--cy", str(cam.cy)], device)
        rgbd_traj = read_kitti_poses(tmp / "rgbd" / "trajectory.txt")

    fields = dict(
        frames=n_frames, shape=[height, width], tum_shape=list(tum_hw),
        tum_frames=tum_frames,
        seconds={r["command"]: r["seconds"] for r in (vocab, slam, pnp_run,
                                                      rgbd)},
        vocabulary=vocab["stdout"].strip(),
        slam_frames_per_s=float(fps.group(3)) if fps else None,
        slam_report=slam["report"], slam_keyframes=len(g2o["vertex_ids"]),
        slam_edges=len(g2o["edge_i"]), pnp_report=pnp_run["report"],
        pnp_frame_ms=frame_ms(pnp_run["stderr"]),
        rgbd_depth_scale=TUM_DEPTH_SCALE, rgbd_room_scale=TUM_ROOM_SCALE,
        rgbd_max_range_m=TUM_MAX_RANGE_M, rgbd_report=rgbd["report"],
        rgbd_ate_bound_m=ATE_BOUND_M * TUM_ROOM_SCALE,
        rgbd_frame_ms=frame_ms(rgbd["stderr"]),
        launches=launches,
        png_decode_ms=decode, reader_ms_per_frame=read_ms, card=card)
    emit("cli", **fields)

    tracked = n_frames - 1
    checks = [
        (fps is not None and int(fps.group(1)) == n_frames,
         "slam printed no frames/s line for every frame"),
        (traj.shape == (n_frames, 4, 4) and np.isfinite(traj).all(),
         f"slam trajectory of shape {traj.shape}"),
        (len(g2o["vertex_ids"]) >= 1, "traj.g2o holds no vertex"),
        (slam["report"] and slam["report"]["frames"] == n_frames
         and slam["report"]["ate_rmse_m"] < ATE_BOUND_M,
         f"slam ATE line {slam['report']}, bound {ATE_BOUND_M} m"),
        (pnp_traj.shape == (n_frames, 4, 4) and np.isfinite(pnp_traj).all(),
         f"pnp trajectory of shape {pnp_traj.shape}"),
        (pnp_run["report"] and pnp_run["report"]["frames"] == n_frames
         and pnp_run["report"]["ate_rmse_m"] < PNP_ATE_BOUND_M,
         f"pnp ATE line {pnp_run['report']}, bound {PNP_ATE_BOUND_M} m"),
        (rgbd_traj.shape == (tum_frames, 4, 4)
         and np.isfinite(rgbd_traj).all(),
         f"rgbd trajectory of shape {rgbd_traj.shape}"),
        (rgbd["report"] and rgbd["report"]["frames"] == tum_frames
         and rgbd["report"]["ate_rmse_m"] < ATE_BOUND_M * TUM_ROOM_SCALE,
         f"rgbd ATE line {rgbd['report']}, bound "
         f"{ATE_BOUND_M * TUM_ROOM_SCALE} m (the course's scale)"),
        (frame_ms(rgbd["stderr"]) is not None,
         "rgbd printed no frame timing"),
    ]
    if device == "cuda":
        checks += [
            (launches["cli slam"] == 2 * tracked,
             f"slam launched SGM {launches['cli slam']} times for "
             f"{tracked} tracked frames, expected 2 each"),
            (launches["cli pnp"] == 2 * n_frames,
             f"pnp launched SGM {launches['cli pnp']} times for "
             f"{n_frames} frames, expected 2 each")]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"cli: {msg}")
    return fields


def phase_rgbd(card: str, device: str = "cuda", height: int = TUM_HW[0],
               width: int = TUM_HW[1], n_frames: int = N_RGBD) -> dict:
    """The whole RGB-D system on the loop world."""
    cfg = tum_config(height, width)
    t = time.time()
    frames, gt = render_rgbd_loop(cfg, n_frames, height, width, device,
                                  n_total=n_frames)
    emit("rgbd", step="rendered", frames=n_frames, shape=[height, width],
         seconds=round(time.time() - t, 2))
    vocab = loop_vocabulary(cfg, frames, device)
    system = SlamSystem(cfg, vocab=vocab, rgbd=True, enable_mapping=True,
                        device=device)
    sgm_cuda.sgm_aggregate4.launches = 0
    t = time.time()
    system.process_stream_rgbd((g, d, None, lbl) for g, d, lbl in frames)
    if device == "cuda":
        torch.cuda.synchronize()
    globals_before_finish = system.n_global_optimizations
    traj = system.finish()
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.time() - t
    sgm_launches = sgm_cuda.sgm_aggregate4.launches
    ate = ate_rmse(traj, gt)
    _, _, lbl = system.map.as_arrays()
    excluded = int(np.isin(lbl, semantics.MAP_EXCLUDED_CLASSES).sum())

    step = {}
    if device == "cuda":
        K = Intrinsics.from_config(cfg.camera)
        state = rgbd_tracker.RgbdTrackerState.initial(
            cfg.orb.n_features, cfg.tracker.ref_frames, device)
        g0, d0 = (torch.from_numpy(x).to(device) for x in frames[0][:2])
        g1, d1 = (torch.from_numpy(x).to(device) for x in frames[1][:2])
        state, _ = rgbd_tracker.track_frame_rgbd(state, g0, d0, K, cfg)

        def one():
            return rgbd_tracker.track_frame_rgbd(state, g1, d1, K, cfg)
        step = dict(track_frame_rgbd_ms=cuda_ms(one, warmup=2, reps=10),
                    track_frame_rgbd_launches=device_launches(one))
    fields = dict(
        frames=n_frames, shape=[height, width], seconds=seconds,
        frames_per_s=n_frames / seconds, keyframes=len(system.keyframes),
        edges=system.n_edges, loop_edges=system.n_loop_edges,
        loop_edge_inliers=system.loop_edge_inliers,
        global_optimizations=system.n_global_optimizations,
        global_optimizations_before_finish=globals_before_finish,
        local_optimizations=system.n_local_optimizations,
        recoveries=system.n_recoveries, ate_rmse_m=ate,
        ate_bound_m=EPOCH_ATE_BOUND_M, map_voxels=len(system.map),
        map_label_counts=np.bincount(lbl, minlength=12).tolist(),
        excluded_class_voxels=excluded, sgm_launches=sgm_launches,
        timer={k: {"calls": v["calls"], "mean_ms": v["mean_ms"]}
               for k, v in system.timer.summary().items()},
        **step, card=card)
    emit("rgbd", **fields)
    if system.n_loop_edges < 1:
        raise AssertionError("rgbd: no loop edge was accepted")
    if globals_before_finish < 1:
        raise AssertionError("rgbd: no global optimisation before finish()")
    if not np.all(np.isfinite(traj)) or not ate < EPOCH_ATE_BOUND_M:
        raise AssertionError(f"rgbd: ATE {ate} m >= {EPOCH_ATE_BOUND_M} m")
    if not len(system.map) or excluded:
        raise AssertionError(f"rgbd: map of {len(system.map)} voxels, "
                             f"{excluded} of an excluded class")
    return fields


def render_frames(cfg: SlamConfig, device: str = "cuda"):
    K = Intrinsics.from_config(cfg.camera)
    gen = torch.Generator(device=device).manual_seed(0)
    world = synthetic.make_world(gen, n_boxes=14, with_moving_box=True,
                                 device=device)
    poses = synthetic.straight_trajectory(N_FRAMES, speed=0.8, device=device)
    seq = synthetic.render_sequence(K, world, poses, H, W)
    # frames reach the system from the host, as a dataset reader gives them
    frames = list(zip(seq["left"].cpu().numpy(), seq["right"].cpu().numpy()))
    return (frames, seq["poses"].cpu().numpy().astype(np.float64),
            seq["moving"], seq["semantic"])


def segnet_config(weights: Path) -> SlamConfig:
    """The default configuration with online SegNet: the full-width network
    the train phase trained (a pickle at ``weights``). A seeded random
    network drawn as Flax draws it is no labeller: its activations halve
    in variance at each of its 26 ReLUs, so its logits are about 2e-6 and
    their argmax is rounding noise."""
    cfg = SlamConfig()
    return cfg.replace(segnet=dataclasses.replace(
        cfg.segnet, online=True, weights=str(weights)))


def segnet_as(model: segnet_mod.SegNet, dtype: torch.dtype
              ) -> segnet_mod.SegNet:
    """The same network working in ``dtype``, on the CPU, in eval mode."""
    out = segnet_mod.SegNet(model.num_classes, dtype, model.width_mult)
    out.load_state_dict(model.state_dict())
    return out


def phase_slice(card: str, weights: Path):
    cfg = segnet_config(weights)
    t = time.time()
    frames, gt, gt_moving, _ = render_frames(cfg)
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
    kernel launch counts zeroed just before and read just after; and the
    index of the frame being fed when the first loop edge and the first
    global optimisation had been made (the stream runs up to 6 frames
    ahead of them)."""
    system = SlamSystem(cfg, vocab=vocab, enable_mapping=True,
                        device=device)
    first = {"loop_edge": None, "global": None}

    def stream():
        for i, frame in enumerate(frames):
            for key, n in (("loop_edge", system.n_loop_edges),
                           ("global", system.n_global_optimizations)):
                if n and first[key] is None:
                    first[key] = i
            yield frame

    counter = CallCounter({
        "solve_pnp_lazy": (pnp, "solve_pnp_lazy"),
        "transform_sparse": (looper, "transform_sparse"),
        "optimize": (pg, "optimize"),
        "_kf_cloud": (pipeline, "_kf_cloud")})
    with counter:
        sgm_cuda.sgm_aggregate4.launches = 0
        t = time.time()
        system.process_stream(stream(), depth=6)
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
                globals_before_finish=globals_before_finish,
                first_loop_edge_frame=first["loop_edge"],
                first_global_frame=first["global"])


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
        first_loop_edge_frame=run["first_loop_edge_frame"],
        first_global_frame=run["first_global_frame"],
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
    """The full-width SegNet (bfloat16, the slice's trained weights) alone
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


def render_street(cfg: SlamConfig, n_frames: int, height: int, width: int,
                  device: str):
    """The cli phase's street (fixed seed) at 0.6 m a frame, rendered in
    chunks on ``device``: host (n, H, W) left and right images in [0, 1]
    and labels, and the (n, 4, 4) ground truth. (At 0.8 m a frame, as in
    the cli phase, frame 32 stands 25.6 m down the street, where no pixel
    of the pair passes SGBM's checks and every tracker loses it.)"""
    K = Intrinsics.from_config(cfg.camera)
    gen = torch.Generator(device=device).manual_seed(0)
    world = synthetic.make_world(gen, n_boxes=14, with_moving_box=True,
                                 device=device)
    poses = synthetic.straight_trajectory(n_frames, speed=0.6, device=device)
    parts = {"left": [], "right": [], "semantic": []}
    for start in range(0, n_frames, 11):
        seq = synthetic.render_sequence(K, world, poses[start:start + 11],
                                        height, width, start_index=start)
        for k, v in parts.items():
            v.append(seq[k].cpu().numpy())
    return (*(np.concatenate(parts[k]) for k in ("left", "right",
                                                 "semantic")),
            poses.cpu().numpy().astype(np.float64))


def profile_window(system: SlamSystem, lefts, rights) -> dict:
    """One window's frontend (track_frames_batched on B + 1 frames) on an
    idle card: its time by CUDA events, and under the profiler its
    device-busy time and its launches, also a frame."""
    cfg = system.cfg
    L, R = system._upload_window(lefts), system._upload_window(rights)
    B = L.shape[0] - 1
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        tracker.track_frames_batched(
            tracker.TrackerState.initial(cfg, "cuda"), L, R, system.K, gen,
            cfg)

    window_ms = cuda_ms(step, warmup=1, reps=3)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.time()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return {"pairs": B, "window_ms": window_ms,
            "ms_per_frame": window_ms / B, "wall_ms_profiled": wall_ms,
            "device_busy_ms": busy_ms if dev else None,
            "device_idle_share": (1.0 - busy_ms / window_ms) if dev else None,
            "device_events": len(dev), "launches_per_frame": len(dev) / B}


def phase_golden(card: str, device: str = "cuda", height: int = H,
                 width: int = W, n_frames: int = N_GOLDEN) -> dict:
    """The first frames of golden_torch.py's stereo circuit, on the JAX
    package's world, with the renderer's labels and the map."""
    args = golden_torch.parse_args(["--gt-semantics", "--device", device])
    cfg = golden_torch.golden_config(args, width=width)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.time()
    world = golden_torch.load_world(args, device)
    poses = golden_torch.circuit_poses(args, device)
    frames = golden_torch.render_circuit(cfg, world, poses, height, width,
                                         rgbd=False, stop=n_frames)
    if device == "cuda":
        torch.cuda.synchronize()
    emit("golden", step="rendered", frames=n_frames, of=args.frames,
         shape=[height, width], world=golden_torch.world_path(
             args.seed, args.radius, args.boxes).name,
         seconds=round(time.time() - t, 2))
    t = time.time()
    vocab = golden_torch.sequence_vocabulary(cfg, frames["left"])
    emit("golden", step="vocabulary", leaves=vocab.n_leaves,
         seconds=round(time.time() - t, 2))

    sgm_cuda.sgm_aggregate4.launches = 0
    run = golden_torch.run_golden(args, cfg, vocab, frames, device,
                                  log=lambda line: emit("golden",
                                                        progress=line))
    launches = {"sgm_aggregate4": sgm_cuda.sgm_aggregate4.launches}
    gt = poses[:n_frames].cpu().numpy().astype(np.float64)
    rec = golden_torch.make_record(args, run, frames, gt, card)
    # the bound holds the frames before the newest, which finish() puts at
    # the last keyframe's pose as the JAX package does (checked here)
    ate_tracked = golden_torch.tracked_ate(run, gt)
    keys = set(json.loads((ROOT / "GOLDEN_r05.json").read_text()))
    tracked = n_frames - 1
    shown = ("frames", "resolution", "ate_rmse_m", "ate_mean_m",
             "rpe_trans_rmse_m", "rpe_rot_rmse_deg", "keyframes",
             "loop_edges", "global_optimizations", "local_optimizations",
             "recoveries", "map_voxels", "excluded_class_voxels", "fps",
             "wall_s", "peak_memory_mb", "world_file",
             "world_loaded_from_json", "stage_times")
    emit("golden", launches=launches, tracked=tracked,
         ate_rmse_tracked_m=round(ate_tracked, 4),
         ate_bound_m=GOLDEN_ATE_BOUND_M,
         keyframe_frames=rec["keyframe_frames"],
         missing_keys=sorted(keys - set(rec)),
         **{k: rec[k] for k in shown}, card=card)

    if not rec["world_loaded_from_json"]:
        raise AssertionError("the golden world was not read from its JSON")
    if device == "cuda" and launches["sgm_aggregate4"] != 2 * tracked:
        raise AssertionError(f"sgm_aggregate4 launched "
                             f"{launches['sgm_aggregate4']} times for "
                             f"{tracked} tracked frames, expected 2 each")
    if rec["recoveries"]:
        raise AssertionError(f"{rec['recoveries']} recoveries")
    if rec["excluded_class_voxels"]:
        raise AssertionError("a voxel of an excluded class is in the map")
    if not keys <= set(rec):
        raise AssertionError(f"the record lacks {sorted(keys - set(rec))}")
    if not (np.all(np.isfinite(run["traj"]))
            and ate_tracked < GOLDEN_ATE_BOUND_M):
        raise AssertionError(f"ATE of the tracked frames {ate_tracked} m "
                             f">= {GOLDEN_ATE_BOUND_M} m")
    return {"launches": launches}


def phase_window(card: str, device: str = "cuda", height: int = H,
                 width: int = W_KITTI) -> dict:
    """The throughput mode: 4 windows of 8 pairs through process_window,
    then the same frames through process_stream."""
    cfg = SlamConfig() if width == W_KITTI else loop_camera(height, width)
    D = cfg.sgbm.num_disparities
    t = time.time()
    lefts, rights, labels, gt = render_street(cfg, N_WINDOW, height, width,
                                              device)
    emit("window", step="rendered", frames=N_WINDOW, shape=[height, width],
         seconds=round(time.time() - t, 2))
    # consecutive windows share a frame: the last of one is the first of
    # the next
    wins = [slice(i, i + WINDOW_B + 1)
            for i in range(0, N_WINDOW - 1, WINDOW_B)]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    # warm-up: one window on a system of its own
    warm = SlamSystem(cfg, enable_mapping=True, device=device)
    warm.process_window(lefts[wins[0]], rights[wins[0]],
                        semantics=labels[wins[0]])
    warm.finish()
    sync()

    # every aggregate of the run, by shape and dtype
    aggs = []
    aggregate = sgbm._aggregate

    def recording_aggregate(vol, sgbm_cfg):
        agg = aggregate(vol, sgbm_cfg)
        aggs.append((list(agg.shape), str(agg.dtype).split(".")[-1]))
        return agg

    system = SlamSystem(cfg, enable_mapping=True, device=device)
    sgbm._aggregate = recording_aggregate
    try:
        sgm_cuda.sgm_aggregate4.launches = 0
        klt.track_pyramid.launches = 0
        t = time.time()
        outs = [system.process_window(lefts[w], rights[w],
                                      semantics=labels[w]) for w in wins]
        sync()
        window_s = time.time() - t
        launches = {"sgm_aggregate4": sgm_cuda.sgm_aggregate4.launches,
                    "klt_track": klt.track_pyramid.launches}
    finally:
        sgbm._aggregate = aggregate
    ate = ate_rmse(np.stack(system.trajectory), gt)
    system._drain_all()
    sync()
    log = system.frame_log
    last, kf = outs[-1], system.keyframes[-1]
    on_card = [last.pose, last.disparity, last.moving_mask, last.matches.lc,
               system.state.pose, kf.left_dev, kf.right_dev,
               kf.disparity_dev, *kf.feats_dev]

    # process_stream over the first two windows' frames, for its frames/s
    n = N_WINDOW_STREAM
    stream = SlamSystem(cfg, enable_mapping=True, device=device)
    t = time.time()
    stream.process_stream(zip(lefts[:n], rights[:n], [None] * n,
                              labels[:n]), depth=6)
    sync()
    stream_s = time.time() - t
    ate_stream = ate_rmse(np.stack(stream.trajectory), gt[:n])

    fields = dict(
        frames=N_WINDOW, windows=len(wins), pairs_per_window=WINDOW_B,
        shape=[height, width], seconds=window_s,
        frames_per_s=N_WINDOW / window_s, ate_rmse_m=ate,
        ate_bound_m=ATE_BOUND_M, stream_frames=n, stream_seconds=stream_s,
        stream_frames_per_s=n / stream_s,
        stream_ate_rmse_m=ate_stream, launches=launches,
        aggregates=aggs, keyframes=len(system.keyframes),
        stream_keyframes=len(stream.keyframes), map_voxels=len(system.map),
        n_inliers=[f.n_inliers for f in log],
        moving_px_per_frame=[f.n_moving for f in log],
        timer={k: {"calls": v["calls"], "mean_ms": v["mean_ms"],
                   "total_s": v["total_s"]}
               for k, v in system.timer.summary().items()},
        card=card)
    if device == "cuda":
        fields["profiled_window"] = profile_window(system, lefts[wins[1]],
                                                   rights[wins[1]])
    emit("window", **fields)

    pairs = N_WINDOW - 1
    checks = [
        (len(log) == pairs and all(f.vo_success for f in log),
         f"VO failed on a pair: {log}"),
        (np.all(np.isfinite(np.stack(system.trajectory))) and
         ate < ATE_BOUND_M, f"ATE {ate} m >= {ATE_BOUND_M} m"),
        (aggs == [([WINDOW_B, height, width, D], "bfloat16")] * len(wins),
         f"aggregates of the window path: {aggs}"),
        (all(x is not None and x.device.type == device for x in on_card),
         "a result of the window or keyframe data is not on the device"),
        (len(system.map) > 0, "the map is empty"),
    ]
    if device == "cuda":
        checks.append((launches["sgm_aggregate4"] == 2 * len(wins),
                       f"sgm_aggregate4 launched "
                       f"{launches['sgm_aggregate4']} times for "
                       f"{len(wins)} windows, expected 2 each"))
        checks.append((launches["klt_track"] == 4 * len(wins),
                       f"klt_track launched {launches['klt_track']} times "
                       f"for {len(wins)} windows, expected 4 each"))
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"window: {msg}")
    return {"launches": launches}


def ring_graph(device: str, n: int = 24, M: int = 64, E: int = 128):
    """A pose graph of n keyframes on a ring of radius 10 m: odometry edges
    and three loop edges with 0.01 noise, the vertices integrated from
    0.03-noisy odometry (fixed seed), in M vertex and E edge slots."""
    rng = np.random.default_rng(3)

    def pose(th):
        T = np.eye(4)
        c, s = np.cos(th), np.sin(th)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[:3, 3] = [10 - 10 * c, 0, 10 * s]
        return T

    def noisy(T, sigma):
        return se3.exp(torch.from_numpy(rng.normal(0, sigma, 6))).numpy() @ T

    gt = [pose(2 * np.pi * k / n) for k in range(n)]
    edges = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0), (n - 2, 1),
                                                  (n // 2, 0)]
    g = pg.PoseGraph(
        poses=np.tile(np.eye(4, dtype=np.float32), (M, 1, 1)),
        vertex_valid=np.arange(M) < n, edge_i=np.zeros(E, np.int64),
        edge_j=np.zeros(E, np.int64),
        edge_T=np.tile(np.eye(4, dtype=np.float32), (E, 1, 1)),
        edge_info=np.zeros(E, np.float32), edge_valid=np.zeros(E, bool),
        edge_is_loop=np.zeros(E, bool))
    for e, (i, j) in enumerate(edges):
        g.edge_i[e], g.edge_j[e] = i, j
        g.edge_T[e] = noisy(np.linalg.inv(gt[i]) @ gt[j], 0.01)
        g.edge_info[e], g.edge_valid[e] = 100.0, True
        g.edge_is_loop[e] = e >= n - 1
    acc = np.eye(4)
    for k in range(1, n):
        acc = acc @ noisy(np.linalg.inv(gt[k - 1]) @ gt[k], 0.03)
        g.poses[k] = acc
    return pg.PoseGraph(*(torch.from_numpy(a).to(device) for a in g))


def sparse_database(M: int = 2048, B: int = 64, n_words: int = 100_000):
    """A sparse BoW database of M rows (tests/test_sharded_bow.py's recipe,
    fixed seed) and a query that shares row 100's words."""
    rng = np.random.default_rng(1)
    idx = np.full((M, B), int(looper.PAD_WORD), np.int64)
    w = np.zeros((M, B), np.float32)
    for i in range(M):
        k = rng.integers(16, B)
        idx[i, :k] = np.sort(rng.choice(n_words, size=k, replace=False))
        w[i, :k] = rng.dirichlet(np.ones(k)).astype(np.float32)
    q_w = w[100] * 0.8
    return (idx[100].copy(), (q_w / q_w.sum()).astype(np.float32), idx, w,
            np.arange(M, dtype=np.int64) * 2, rng.uniform(size=M) > 0.05)


def mesh_window_run(cfg: SlamConfig, vocab, lefts, rights, labels, device,
                    mesh=None):
    """SlamSystem (with ``mesh``, or without) over the street's windows
    with the vocabulary and the map, then finish(): the system, its
    window seconds, its trajectory and graph (``final_graph``) before
    finish(), and its finished trajectory."""
    wins = [slice(i, i + WINDOW_B + 1)
            for i in range(0, N_WINDOW - 1, WINDOW_B)]
    system = SlamSystem(cfg, vocab=vocab, enable_mapping=True, device=device,
                        mesh=mesh)
    t = time.time()
    for w in wins:
        system.process_window(lefts[w], rights[w], semantics=labels[w])
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.time() - t
    traj = np.stack(system.trajectory)
    graph = final_graph(system)
    return system, seconds, traj, graph, system.finish()


def collective_ms(mesh, device: str, out: tracker.FrameResult,
                  n_vertices: int, db_rows: int, budget: int) -> dict:
    """Card ms of one call of each collective of the mesh path at the
    shapes it runs them (CUDA events, median of 25 after 3 warm-ups): the
    window's gather of its per-pair fields, one all-reduce of the PCG's
    (M, 6) vector and of its (M, 6, 6) blocks, the BoW's gather of (rows,
    2) scores and the map's ring exchange of two (budget,) key arrays."""
    group = pmesh.axis_group(mesh)
    vec = torch.zeros((n_vertices, 6), device=device)
    blocks = torch.zeros((n_vertices, 6, 6), device=device)
    scores = torch.zeros((db_rows, 2), device=device)
    keys = torch.zeros(budget, dtype=torch.int64, device=device)
    return {
        "window_gather_result": cuda_ms(lambda: sharded_frontend.
                                        gather_result(out, mesh)),
        "pcg_all_reduce_vector": cuda_ms(
            lambda: pmesh.all_reduce_sum(vec, group)),
        "pcg_all_reduce_blocks": cuda_ms(
            lambda: pmesh.all_reduce_sum(blocks, group)),
        "bow_all_gather": cuda_ms(lambda: pmesh.all_gather(scores, group)),
        "map_ring_exchange": cuda_ms(
            lambda: pmesh.ring_exchange(keys, keys, group))}


def phase_mesh(card: str, device: str = "cuda", height: int = H,
               width: int = W_KITTI, train_size: int = TRAIN_SIZE,
               train_width: float = 1.0) -> dict:
    """The mesh mode on a world of one: SlamSystem(mesh=...) against the
    meshless system on the window phase's street, then the sharded solve,
    BoW scan and map against their single-device counterparts; then
    SegNet training sharded: ``cli train-segnet --mesh``, sharded steps
    against meshless ones, and the sharded step's cost."""
    cfg = SlamConfig() if width == W_KITTI else loop_camera(height, width)
    training = {"cli": mesh_train_cli(card, device, train_size, train_width)}
    t0 = time.time()
    lefts, rights, labels, gt = render_street(cfg, N_WINDOW, height, width,
                                              device)
    vocab = loop_vocabulary(cfg, [(left,) for left in lefts], device)
    emit("mesh", step="rendered", frames=N_WINDOW, shape=[height, width],
         vocabulary_leaves=vocab.n_leaves,
         seconds=round(time.time() - t0, 2))
    with tempfile.TemporaryDirectory() as tmp:
        world = pmesh.initialize_distributed(
            f"file://{Path(tmp) / 'store'}", 1, 0, device=device)
        try:
            mesh = pmesh.make_mesh(1, dp=1, tp=1, device=device)
            row = mesh_checks(cfg, vocab, lefts, rights, labels, gt, mesh,
                              device, card)
            training["parity"] = sharded_step_parity(
                mesh, device, train_size, train_width)
            if device == "cuda":
                training["step"] = [
                    sharded_step_row(mesh, hw, TRAIN_BATCH, card)
                    for hw in ((TRAIN_SIZE, TRAIN_SIZE), SEGNET_HW)]
        finally:
            dist.destroy_process_group()
    row["world"] = world
    row["training"] = training
    return row


def mesh_train_cli(card: str, device: str, size: int, width: float,
                   batch: int = TRAIN_BATCH,
                   steps: int = MESH_TRAIN_STEPS) -> dict:
    """``cli train-segnet --mesh`` as a subprocess, which joins a world of
    one alone (no torchrun): its stderr lines, seconds and steps/s; it must
    print the (1, 1) mesh, launch no SGM kernel and write a segnet.pkl that
    ``load_checkpoint`` reads."""
    with tempfile.TemporaryDirectory() as out:
        res = run_cli(["train-segnet", "--mesh", "--size", str(size),
                       "--width", str(width), "--steps", str(steps),
                       "--batch", str(batch), "--out", out], device)
        model, meta = segnet_mod.load_checkpoint(Path(out) / "segnet.pkl")
    train_s = float(re.search(r"^trained \d+ steps in ([\d.]+) s",
                              res["stderr"], re.M).group(1))
    shape = re.search(r"^training on mesh (.*)$", res["stderr"], re.M)
    row = dict(size=size, width_mult=width, steps=steps, batch=batch,
               seconds=res["seconds"], train_seconds=train_s,
               steps_per_s=steps / train_s,
               stderr=res["stderr"].strip().splitlines(),
               stdout=res["stdout"].strip(), miou=meta["miou"],
               miou_heldout_world=meta["miou_heldout_world"],
               sgm_launches=res["sgm_launches"])
    emit("mesh", step="train-segnet --mesh", **row, card=card)
    checks = [
        (shape is not None and shape.group(1) == "{'data': 1, 'model': 1}",
         f"the mesh line: {shape and shape.group(0)}"),
        (res["stdout"].startswith("saved "), "no saved line"),
        (model.width_mult == width and meta["steps"] == steps
         and meta["train_size"] == size, f"the pickle's meta: {meta}"),
        (res["sgm_launches"] == 0,
         f"SGM launched {res['sgm_launches']} times in training")]
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"mesh: train-segnet --mesh: {msg}")
    return row


def sharded_step_parity(mesh, device: str, size: int, width: float,
                        batch: int = TRAIN_BATCH, lr: float = 3e-4,
                        steps: int = 3) -> dict:
    """``steps`` sharded float32 train steps against meshless ones from the
    same seeded start on the same ``TrainBatches`` batches, with the
    command's class weights (TF32 off: ``phase_device``). After each step:
    the loss, the BatchNorm buffers and the gathered parameters, with the
    CPU tests' tolerances (tests/test_torch_sharded_segnet.py): the first
    loss within 2e-5 (relative) and its buffers within 1e-4 of their norm,
    the later within 1e-2 and 0.1; each parameter within 2 lr per step
    taken."""
    par = Parity("mesh")
    cfg = SegNetConfig(input_height=size, input_width=size,
                       width_mult=width, dtype="float32")
    ref = segnet_mod.create(cfg, torch.Generator().manual_seed(0)).to(device)
    sharded = pmesh.shard_params(ref, mesh)
    batches = cli_mod.TrainBatches(size, batch, device)
    cw = torch.clamp(segnet_mod.median_frequency_weights(
        batches.class_weight_batches(), ref.num_classes), max=4.0).to(device)
    ref_step = segnet_mod.make_train_step(ref, segnet_mod.adam(ref, lr),
                                          class_weights=cw)
    sharded_step = sharded_segnet.make_sharded_train_step(
        sharded, mesh, lr, class_weights=cw)

    def rel(a, b):
        return float((a - b).double().norm() / b.double().norm().clamp(
            min=1e-30))

    for i in range(steps):
        x, y = batches.train(i)
        want_loss = float(ref_step(x, y))
        got_loss = float(sharded_step(x, y))
        got = pmesh.gather_params(sharded, mesh).state_dict()
        want = ref.state_dict()
        buffers = [k for k in want if k.endswith((".bn.mean", ".bn.var"))]
        loss_tol, stats_tol = (2e-5, 1e-4) if i == 0 else (1e-2, 0.1)
        par.check(f"sharded f32 step {i}: loss against meshless (relative)",
                  abs(got_loss - want_loss) / abs(want_loss), loss_tol,
                  loss=got_loss, meshless_loss=want_loss,
                  shape=[batch, size, size, 3], width_mult=width)
        par.check(f"sharded f32 step {i}: BatchNorm buffers (largest "
                  "relative to norm)",
                  max(rel(got[k], want[k]) for k in buffers), stats_tol)
        par.check(f"sharded f32 step {i}: parameters (largest abs)",
                  max(float((got[k] - want[k]).abs().max())
                      for k in want if k not in buffers),
                  2 * lr * (i + 1))
    return par.rows


def sharded_step_row(mesh, size_hw, batch: int, card: str) -> dict:
    """One full-width bfloat16 sharded train step on the mesh at (batch,
    *size_hw, 3), on the inputs of ``train_step_row``: CUDA events (median
    of 15 after 3 warm-ups), launches by the profiler, the calls and bytes
    of each collective a step, peak memory."""
    cfg = SegNetConfig(input_height=size_hw[0], input_width=size_hw[1])
    model = pmesh.shard_params(segnet_mod.create(
        cfg, torch.Generator().manual_seed(0)).cuda(), mesh)
    step = sharded_segnet.make_sharded_train_step(
        model, mesh, 3e-4,
        class_weights=torch.ones(model.num_classes, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((batch, *size_hw, 3), generator=gen, device="cuda")
    y = torch.randint(0, model.num_classes, (batch, *size_hw),
                      generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(x, y), warmup=3, reps=15)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    pmesh.reset_counts()
    launches = device_launches(lambda: step(x, y))
    row = dict(shape=[batch, *size_hw, 3], dtype="bfloat16", width_mult=1.0,
               mesh_shape=[pmesh.axis_size(mesh, pmesh.DATA_AXIS),
                           pmesh.axis_size(mesh, pmesh.MODEL_AXIS)],
               backend=dist.get_backend(), ms=ms,
               launches_per_step=launches,
               collectives_per_step=pmesh.counts(),
               peak_memory_mb=peak_mb, card=card)
    emit("mesh", step="sharded train step", **row)
    return row


def mesh_checks(cfg, vocab, lefts, rights, labels, gt, mesh, device,
                card) -> dict:
    """The body of phase_mesh, on an initialised mesh."""
    # warm-up: one window on a meshless system of its own
    warm = SlamSystem(cfg, enable_mapping=True, device=device)
    warm.process_window(lefts[:WINDOW_B + 1], rights[:WINDOW_B + 1],
                        semantics=labels[:WINDOW_B + 1])
    warm.finish()

    # in turns: meshless, mesh, mesh, meshless; the checks read the first
    # run of each, whose mesh run's counts are zeroed just before it
    ref, ref_s, ref_traj, ref_graph, ref_final = mesh_window_run(
        cfg, vocab, lefts, rights, labels, device)
    pmesh.reset_counts()
    sgm_cuda.sgm_aggregate4.launches = 0
    sys_m, mesh_s, traj, _, final = mesh_window_run(
        cfg, vocab, lefts, rights, labels, device, mesh=mesh)
    launches = {"sgm_aggregate4": sgm_cuda.sgm_aggregate4.launches}
    counts = pmesh.counts()
    mesh_s2 = mesh_window_run(cfg, vocab, lefts, rights, labels, device,
                              mesh=mesh)[1]
    ref_s2 = mesh_window_run(cfg, vocab, lefts, rights, labels, device)[1]

    same = {
        "poses_max_abs_diff": float(np.abs(traj - ref_traj).max()),
        "finished_max_abs_diff": float(np.abs(final - ref_final).max()),
        "statuses": [f.status for f in sys_m.frame_log]
        == [f.status for f in ref.frame_log],
        "keyframes": [k.frame_index for k in sys_m.keyframes]
        == [k.frame_index for k in ref.keyframes],
        "loop_edges": (sys_m.n_loop_edges, ref.n_loop_edges),
        "optimizations": (sys_m.n_optimizations, ref.n_optimizations)}

    # the sharded solve against pose_graph.optimize: the street's graph
    # before finish() and a noisy ring with loop edges
    pg_cfg = cfg.pose_graph
    solves = {}
    for name, (g, table, mask) in (
            ("street", ref_graph),
            ("ring", (lambda g: (g, None, pg.global_free_mask(g)))(
                ring_graph(device)))):
        a = pg.optimize(g, mask, pg_cfg, iters=pg_cfg.global_iters,
                        table=table).poses
        b = sharded_pcg.optimize_sharded(g, mask, mesh, pg_cfg,
                                         iters=pg_cfg.global_iters).poses
        b2 = sharded_pcg.optimize_sharded(g, mask, mesh, pg_cfg,
                                          iters=pg_cfg.global_iters).poses
        solves[name] = {"max_abs_err": float((a - b).abs().max()),
                        "repeat_identical": bool(torch.equal(b, b2)),
                        "moved": float((a - g.poses).abs().max())}

    # the sharded sparse BoW scan: the reference system's database with
    # its newest keyframe's query, and a 2048-row database
    kf = ref.keyframes[-1]
    cap = ref._db_idx.shape[0]
    ids = torch.tensor([k.frame_index for k in ref.keyframes]
                       + [0] * (cap - len(ref.keyframes)), device=device)
    valid = torch.arange(cap, device=device) < len(ref.keyframes)
    q_idx, q_w, idx, w, sids, svalid = sparse_database()
    up = lambda a: torch.from_numpy(a).to(device)      # noqa: E731
    bow = {}
    for name, args in (
            ("street", (*kf.bow_dev, ref._db_idx, ref._db_w, ids, valid,
                        kf.frame_index)),
            ("2048_rows", (up(q_idx), up(q_w), up(idx), up(w), up(sids),
                           up(svalid), 5000))):
        s1, m1 = looper.get_possible_loops_sparse(
            looper.SparseBow(args[0], args[1]), *args[2:],
            cfg.looper.min_sim_score, cfg.looper.min_interval)
        s2, m2 = sharded_bow.get_possible_loops_sparse_sharded(
            *args[:6], args[6], mesh, cfg.looper.min_sim_score,
            cfg.looper.min_interval)
        bow[name] = {"rows": int(args[2].shape[0]),
                     "max_abs_err": float((s1 - s2).abs().max()),
                     "masks_equal": bool(torch.equal(m1, m2)),
                     "candidates": int(m1.sum())}

    # ShardedGlobalMap against the host GlobalMap on clouds under the
    # budget (__graft_entry__.py:162-193)
    rng = np.random.default_rng(0)
    res = 0.2
    smap = ShardedGlobalMap(mesh, res, budget=1 << 12, x_extent=8.0,
                            pad_points=512)
    gmap = mapper.GlobalMap(dataclasses.replace(cfg.mapper, resolution=res))
    for _ in range(3):
        xyz = (rng.uniform(-6.0, 6.0, (400, 3))
               * np.array([1.0, 0.3, 0.3])).astype(np.float32)
        col = rng.uniform(0, 1, (400, 3)).astype(np.float32)
        smap.insert(xyz, col)
        gmap.insert(xyz, col)
    key = lambda xyz: set(map(tuple, np.floor(xyz / res).astype(  # noqa
        np.int64).tolist()))
    skeys, gkeys = key(smap.as_arrays()[0]), key(gmap.as_arrays()[0])
    map_row = {"host_voxels": len(gkeys), "sharded_voxels": len(skeys),
               "differing": len(skeys ^ gkeys),
               "system_map_voxels": len(sys_m.map),
               "meshless_system_map_voxels": len(ref.map)}

    # one call of each collective at the path's shapes; the window's
    # gather on a rank's own result of the first window
    L = sys_m._upload_window(lefts[:WINDOW_B + 1])
    R = sys_m._upload_window(rights[:WINDOW_B + 1])
    _, local = sharded_frontend.track_frames_sharded(
        tracker.TrackerState.initial(cfg, device), L, R, sys_m.K,
        torch.Generator(device=device).manual_seed(0), cfg, mesh)
    coll_ms = (collective_ms(mesh, device, local,
                             ref_graph[0].poses.shape[0], cap,
                             sys_m.map.budget)
               if device == "cuda" else None)
    if coll_ms is not None:
        # the mesh run's collectives at these per-call times: a window's
        # gather (12 all-gathers) a window, the other all-gathers at the
        # BoW gather's, the all-reduces at the PCG vector's
        windows = N_WINDOW // WINDOW_B
        coll_ms["mesh_run_estimate"] = (
            windows * coll_ms["window_gather_result"]
            + (counts["all_gather"]["calls"] - 12 * windows)
            * coll_ms["bow_all_gather"]
            + counts["all_reduce_sum"]["calls"]
            * coll_ms["pcg_all_reduce_vector"]
            + counts["ring_exchange"]["calls"] / 2
            * coll_ms["map_ring_exchange"])

    fields = dict(
        frames=N_WINDOW, windows=N_WINDOW // WINDOW_B,
        pairs_per_window=WINDOW_B, mesh_shape=[1, 1],
        backend=dist.get_backend(),
        seconds=[mesh_s, mesh_s2],
        frames_per_s=[N_WINDOW / mesh_s, N_WINDOW / mesh_s2],
        meshless_seconds=[ref_s, ref_s2],
        meshless_frames_per_s=[N_WINDOW / ref_s, N_WINDOW / ref_s2],
        ate_rmse_m=ate_rmse(traj, gt), meshless_ate_rmse_m=ate_rmse(
            ref_traj, gt), keyframes=len(sys_m.keyframes),
        same_as_meshless=same, launches=launches, collectives=counts,
        collective_ms=coll_ms, solves=solves, bow=bow, map=map_row,
        card=card)
    emit("mesh", **fields)

    checks = [
        (same["poses_max_abs_diff"] <= 1e-4
         and same["finished_max_abs_diff"] <= 1e-4,
         f"the mesh trajectory parts from the meshless one: {same}"),
        (same["statuses"] and same["keyframes"]
         and same["loop_edges"][0] == same["loop_edges"][1]
         and same["optimizations"][0] == same["optimizations"][1],
         f"the mesh system's decisions differ: {same}"),
        (fields["ate_rmse_m"] < ATE_BOUND_M,
         f"ATE {fields['ate_rmse_m']} m >= {ATE_BOUND_M} m"),
        (all(counts[k]["calls"] > 0 for k in SERVING_COLLECTIVES),
         f"a collective of the mesh path never ran: {counts}"),
        (all(r["max_abs_err"] <= 1e-4 and r["repeat_identical"]
             for r in solves.values()) and solves["ring"]["moved"] > 1e-2,
         f"the sharded solve: {solves}"),
        (all(r["max_abs_err"] <= 1e-6 and r["masks_equal"]
             for r in bow.values()) and bow["2048_rows"]["candidates"] > 0,
         f"the sharded BoW scan: {bow}"),
        (map_row["host_voxels"] > 100
         and map_row["differing"] <= 0.01 * map_row["host_voxels"]
         and map_row["system_map_voxels"] > 0,
         f"the sharded map: {map_row}"),
        (isinstance(sys_m.map, ShardedGlobalMap),
         "the mesh system's map is not the sharded one"),
    ]
    if device == "cuda":
        checks.append((launches["sgm_aggregate4"] == 2 * fields["windows"],
                       f"sgm_aggregate4 launched "
                       f"{launches['sgm_aggregate4']} times for "
                       f"{fields['windows']} windows, expected 2 each"))
    for ok, msg in checks:
        if not ok:
            raise AssertionError(f"mesh: {msg}")
    return {"launches": launches}


class Parity:
    """Card-against-CPU checks: each records its error and tolerance and
    raises on a miss."""

    def __init__(self, phase: str = "parity"):
        self.rows = {}
        self.phase = phase

    def check(self, name: str, error: float, tolerance: float,
              **extra) -> None:
        ok = bool(error <= tolerance)
        self.rows[name] = {"error": error, "tolerance": tolerance, "ok": ok,
                           **extra}
        emit(self.phase, check=name, error=error, tolerance=tolerance, ok=ok,
             **extra)
        if not ok:
            raise AssertionError(f"parity {name}: error {error} > "
                                 f"tolerance {tolerance}")


def sgbm_batch_parity(par: Parity, img, cfg: SlamConfig,
                      card_dev: str) -> None:
    """full_dp and batched SGBM: the 8-direction aggregate card against
    CPU exactly, full_dp SGBM card against CPU as the 4-direction check,
    and a batch of two pairs on the card against each pair alone."""
    # full_dp: the 8-direction aggregate of one volume (the CPU's) on both
    # devices, exactly; then the whole of SGBM with it, as above
    fcfg = dataclasses.replace(cfg.sgbm, full_dp=True)
    vol = sgbm._cost_volume(img["cpu"][0], img["cpu"][1], fcfg)
    agg8 = {dev: sgbm._aggregate(vol.to(dev), fcfg).cpu()
            for dev in (card_dev, "cpu")}
    par.check("sgbm full_dp aggregate (8 directions), card vs CPU",
              float((agg8[card_dev].float() - agg8["cpu"].float()).abs()
                    .max()), 0.0, dtype=str(agg8["cpu"].dtype))
    del vol, agg8
    sg8 = {dev: sgbm.compute(img[dev][0], img[dev][1], fcfg) for dev in img}
    both8 = sg8[card_dev].valid.cpu() & sg8["cpu"].valid
    par.check("sgbm.compute full_dp disparity (jointly valid px)", float(
        (sg8[card_dev].disparity.cpu() - sg8["cpu"].disparity)[both8].abs()
        .max()), 1e-3, valid_px=int(both8.sum()))
    par.check("sgbm.compute full_dp valid-mask disagreement (share of px)",
              float((sg8[card_dev].valid.cpu() != sg8["cpu"].valid).float()
                    .mean()), 1e-3)
    # a batch of two pairs on the card against each pair alone on the card
    lb = torch.stack([img[card_dev][0], img[card_dev][2]])
    rb = torch.stack([img[card_dev][1], img[card_dev][3]])
    for label, scfg in (("4 directions", cfg.sgbm), ("full_dp", fcfg)):
        sb = sgbm.compute(lb, rb, scfg)
        ones = [sgbm.compute(lb[i], rb[i], scfg) for i in range(2)]
        differ = sum(int((o.valid != sb.valid[i]).sum())
                     + int((o.disparity != sb.disparity[i]).sum())
                     for i, o in enumerate(ones))
        par.check(f"batched sgbm.compute ({label}) on the card vs per "
                  "frame: differing px", differ, 0)


def phase_parity(frames, system: SlamSystem, weights: Path,
                 card_dev: str = "cuda") -> None:
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

    sgbm_batch_parity(par, img, cfg, card_dev)

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

    segnet_parity(par, frames, card_dev, weights)


def segnet_parity(par: Parity, frames, card_dev: str,
                  weights: Path) -> None:
    """SegNet on the card and the CPU with the same full-width weights. One
    bfloat16 ConvBNRelu of the seeded network on random activations: all
    but 0.5% of the outputs equal and the rest within one bfloat16 ulp of
    the layer's largest output (float32 sums in another order round a bf16
    tie either way, and BatchNorm and ReLU carry that ulp on). The labels
    of one frame through ``_run_segnet`` with the network the train phase
    trained: at least 99% of the pixels agree with the network in float32
    (TF32 off); its bfloat16 agreement is printed, not held (bf16 one-ulp
    differences compound over the 27 layers)."""
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
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for dev in (card_dev, "cpu"):
            s = SlamSystem(segnet_config(weights), device=dev)
            s._segnet = segnet_as(s._segnet, dtype).to(dev)
            labels[name, dev] = s._run_segnet(
                s._upload_gray(frames[3][0])).cpu()
    agree = {d: float((labels[d, card_dev] == labels[d, "cpu"]).float()
                      .mean()) for d in ("float32", "bfloat16")}
    par.check("segnet labels of one frame, float32: pixels disagreeing "
              "(share)", 1.0 - agree["float32"], 0.01,
              bf16_agreement_printed_only=agree["bfloat16"],
              classes=int(labels["float32", "cpu"].unique().numel()))


def train_step_row(size_hw, batch: int, card: str) -> dict:
    """One full-width bfloat16 train step (loss, backward, Adam) at
    (batch, *size_hw, 3) on the card: CUDA events (median of 15 after 3
    warm-ups), launches by the profiler, peak memory, and the share of the
    bf16 peak counting 3 x the forward's operations as a step's work."""
    cfg = SegNetConfig(input_height=size_hw[0], input_width=size_hw[1])
    model = segnet_mod.create(cfg, torch.Generator().manual_seed(0)).cuda()
    step = segnet_mod.make_train_step(
        model, segnet_mod.adam(model, 3e-4),
        class_weights=torch.ones(model.num_classes, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((batch, *size_hw, 3), generator=gen, device="cuda")
    y = torch.randint(0, model.num_classes, (batch, *size_hw),
                      generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(x, y), warmup=3, reps=15)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    n_params = sum(p.numel() for p in model.parameters())
    ops = 3 * segnet_mod.flops(model, *size_hw) * batch
    # the least bytes: the images and labels read once; the parameters and
    # Adam's two moments read once and written once
    n_bytes = x.numel() * 4 + y.numel() * 8 + n_params * 4 * 6
    t_ops, t_bytes = ops / PEAK_BF16_S, n_bytes / PEAK_BYTES_S
    row = dict(shape=[batch, *size_hw, 3], dtype="bfloat16", width_mult=1.0,
               params=n_params, flops=ops, ms=ms,
               tflop_s=ops / (ms * 1e-3) / 1e12,
               share_of_bf16_peak=ops / (ms * 1e-3) / PEAK_BF16_S,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               launches_per_step=device_launches(lambda: step(x, y)),
               peak_memory_mb=peak_mb, library_ms=None, card=card)
    emit("train", step="train step", **row)
    return row


def train_step_parity(par: Parity, card_dev: str, size: int = 96,
                      batch: int = 2, lr: float = 3e-4) -> None:
    """One full-width train step from the same weights and batch on the
    card and on the host CPU (TF32 off), held in two parts.

    Float64: the loss and its gradients (``loss_fn`` in train mode, then
    backward) on the card equal the CPU's within 1e-10 (loss, relative)
    and 1e-8 of each gradient's norm; the new BatchNorm buffers within
    1e-10. In float64 the rounding that Flax's fast BatchNorm variance
    ``E[y^2] - E[y]^2`` amplifies is 1e-16, so this holds the card's
    forward and backward to the CPU's, op for op.

    Float32, the whole step (``make_train_step`` with Adam): the loss
    within 1e-3 (relative) and the new BatchNorm buffers within 2e-3 of
    their norm; each parameter within 2 lr of the CPU's (Adam's first step
    is about lr times the gradient's sign, which near-zero gradients take
    either way); the change the step made to the batch's loss (both
    parameter sets through the CPU's loss_fn) within 40% of the CPU's and
    of its sign; the convolution biases ahead of BatchNorm (zero in exact
    arithmetic) under 1e-5 of their kernel's gradient. Each device's
    float32 gradients are printed against the card's float64 ones, not
    held, and so are the card's with cuDNN switched off and with cuDNN's
    float32 precision set to ``ieee`` by name: the fast variance
    amplifies a convolution's rounding (one convolution against float64
    is printed for each device) into the gradients of the layers far from
    the loss."""
    cfg = SegNetConfig(dtype="float32")
    base = segnet_mod.create(cfg, torch.Generator().manual_seed(0))
    x, y = cli_mod.TrainBatches(size, batch, "cpu").train(0)
    cw = torch.clamp(segnet_mod.median_frequency_weights([y], 12), max=4.0)
    buffers = [k for k in base.state_dict()
               if k.endswith((".bn.mean", ".bn.var"))]

    def is_pre_bn_bias(k):
        return k.startswith("blocks.") and k.endswith(".conv.bias")

    def rel(a, b):
        return float((a.double() - b.double()).norm()
                     / b.double().norm().clamp(min=1e-300))

    def network(dev, dtype):
        model = segnet_mod.SegNet(dtype=dtype)
        model.load_state_dict(base.state_dict())
        return model.to(dev, dtype)

    def gradients(dev, dtype):
        model = network(dev, dtype)
        loss = segnet_mod.loss_fn(model, x.to(dev, dtype), y.to(dev),
                                  class_weights=cw.to(dev, dtype))
        loss.backward()
        return (float(loss.detach()), {n: p.grad.cpu().double()
                              for n, p in model.named_parameters()},
                {k: v.cpu().double() for k, v in model.state_dict().items()})

    def errors(a, b):
        e = {k: rel(a[k], b[k]) for k in b if not is_pre_bn_bias(k)}
        return dict(max=max(e.values()), median=statistics.median(
            e.values()), worst=max(e, key=e.get))

    # one convolution (the second layer's) against float64
    w = base.blocks[1].conv.weight.detach()
    a = torch.rand((batch, w.shape[1], size, size),
                   generator=torch.Generator().manual_seed(1))
    ref = torch.nn.functional.conv2d(a.double(), w.double(), padding=1)
    conv_err = {dev: float((torch.nn.functional.conv2d(
        a.to(dev), w.to(dev), padding=1).cpu().double() - ref).abs().max()
        / ref.abs().max()) for dev in (card_dev, "cpu")}

    f64 = {dev: gradients(dev, torch.float64) for dev in (card_dev, "cpu")}
    f32 = {dev: gradients(dev, torch.float32) for dev in (card_dev, "cpu")}
    # where the card's float32 gradients part from float64: the same step
    # with cuDNN's convolutions replaced by PyTorch's own
    with torch.backends.cudnn.flags(enabled=False):
        f32_no_cudnn = gradients(card_dev, torch.float32)
    # and with cuDNN's float32 precision asked for by name (the flag that
    # replaces allow_tf32 in newer PyTorch), where this PyTorch has it
    conv_flags = getattr(torch.backends.cudnn, "conv", None)
    precision = getattr(conv_flags, "fp32_precision", None)
    f32_ieee = None
    if precision is not None:
        conv_flags.fp32_precision = "ieee"
        try:
            f32_ieee = gradients(card_dev, torch.float32)
        finally:
            conv_flags.fp32_precision = precision
    (l64_card, g64_card, s64_card), (l64_cpu, g64_cpu, s64_cpu) = \
        f64[card_dev], f64["cpu"]

    # the whole float32 step
    out = {}
    for dev in (card_dev, "cpu"):
        model = network(dev, torch.float32)
        step = segnet_mod.make_train_step(model, segnet_mod.adam(model, lr),
                                          class_weights=cw.to(dev))
        loss = float(step(x.to(dev), y.to(dev)))
        out[dev] = (loss, {n: p.grad.cpu().double()
                           for n, p in model.named_parameters()},
                    {k: v.cpu() for k, v in model.state_dict().items()})
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = out[card_dev], \
        out["cpu"]

    def batch_loss(state):
        model = segnet_mod.SegNet(dtype=torch.float32)
        model.load_state_dict(state)
        with torch.no_grad():
            return float(segnet_mod.loss_fn(model, x, y, class_weights=cw))

    start = batch_loss(base.state_dict())
    moved_card, moved_cpu = batch_loss(s_card) - start, \
        batch_loss(s_cpu) - start
    buffer_errs = {k: rel(s_card[k], s_cpu[k]) for k in buffers}
    worst_buffer = max(buffer_errs, key=buffer_errs.get)
    bias_ratio = max(float(g_card[k].norm() / g_card[k.replace(
        ".bias", ".weight")].norm()) for k in g_card if is_pre_bn_bias(k))
    emit("train", step="train step, card against CPU",
         shape=[batch, size, size, 3], conv_f32_err_vs_float64=conv_err,
         f64_loss=dict(card=l64_card, cpu=l64_cpu),
         f64_gradients_card_vs_cpu=errors(g64_card, g64_cpu),
         f32_gradients_vs_card_f64={
             **{dev: errors(f32[dev][1], g64_card) for dev in f32},
             "card without cudnn": errors(f32_no_cudnn[1], g64_card),
             "card, cudnn fp32_precision ieee": f32_ieee and errors(
                 f32_ieee[1], g64_card)},
         f32_gradients_card_vs_cpu=errors(g_card, g_cpu),
         f32_loss=dict(card=l_card, cpu=l_cpu),
         f32_moved=dict(card=moved_card, cpu=moved_cpu),
         f32_worst_buffer=[worst_buffer, buffer_errs[worst_buffer]],
         tf32=dict(cudnn=torch.backends.cudnn.allow_tf32,
                   matmul=torch.backends.cuda.matmul.allow_tf32,
                   cudnn_conv_fp32_precision=precision))

    par.check("train step f64: loss (relative)",
              abs(l64_card - l64_cpu) / abs(l64_cpu), 1e-10)
    par.check("train step f64: gradients (largest relative)",
              errors(g64_card, g64_cpu)["max"], 1e-8)
    par.check("train step f64: BatchNorm buffers (largest relative)",
              max(rel(s64_card[k], s64_cpu[k]) for k in buffers), 1e-10)
    par.check("train step f32: loss (relative)",
              abs(l_card - l_cpu) / abs(l_cpu), 1e-3)
    par.check("train step f32: BatchNorm buffers (largest relative)",
              buffer_errs[worst_buffer], 2e-3, tensor=worst_buffer)
    par.check("train step f32: conv bias gradients ahead of BatchNorm "
              "(relative to the kernel's)", bias_ratio, 1e-5)
    par.check("train step f32: parameters (largest difference, in lr)",
              max(float((s_card[k] - s_cpu[k]).abs().max())
                  for k in g_cpu) / lr, 2.01)
    if not moved_cpu < 0:
        raise AssertionError(f"the CPU's train step raised its batch's loss "
                             f"by {moved_cpu}")
    par.check("train step f32: loss change of the step (card against CPU, "
              "share of the CPU's)", abs(moved_card - moved_cpu)
              / -moved_cpu, 0.4)


def phase_train(card: str, out: Path, device: str = "cuda",
                size: int = TRAIN_SIZE, steps: int = TRAIN_STEPS,
                batch: int = TRAIN_BATCH, width: float = 1.0,
                min_miou=TRAIN_MIN_MIOU) -> dict:
    """SegNet training through the command line (its ``segnet.pkl`` in
    ``out``, for the phases that label keyframes online), then the
    trained network's labels on the card, the train step's cost, and a
    train step held card against CPU."""
    par = Parity("train")
    res = run_cli(["train-segnet", "--size", str(size), "--width",
                   str(width), "--steps", str(steps), "--batch", str(batch),
                   "--out", str(out)], device, timeout=900)
    path = Path(out) / "segnet.pkl"
    model, meta = segnet_mod.load_checkpoint(path)
    train_s = float(re.search(r"^trained \d+ steps in ([\d.]+) s",
                              res["stderr"], re.M).group(1))
    evals = [dict(step=int(m[0]), loss=float(m[1]), holdout_miou=float(
        m[2]), heldout_world_miou=float(m[3])) for m in re.findall(
            r"^step (\d+): loss ([\d.]+) holdout mIoU ([\d.]+) "
            r"heldout-world mIoU ([\d.]+)$", res["stderr"], re.M)]
    row = dict(size=size, width_mult=width, steps=steps, batch=batch,
               seconds=res["seconds"], train_seconds=train_s,
               steps_per_s=steps / train_s, miou=meta["miou"],
               miou_heldout_world=meta["miou_heldout_world"],
               per_class_recall=meta["per_class_recall_heldout_world"],
               jax_recipe_miou=JAX_W1_MIOU, first_eval=evals[0],
               last_eval=evals[-1], sgm_launches=res["sgm_launches"])
    emit("train", step="train-segnet", stdout=res["stdout"].strip(), **row,
         card=card)
    if min_miou is not None and not (
            meta["miou"] >= min_miou[0]
            and meta["miou_heldout_world"] >= min_miou[1]):
        raise AssertionError(
            f"trained SegNet: holdout mIoU {meta['miou']}, held-out world "
            f"mIoU {meta['miou_heldout_world']}, below {min_miou}")

    # the learned labels: the held-out world batch in float32 on the card
    # and the CPU (a learned network's logits are decisive, so the two
    # agree but for pixels at a tie), then online on a KITTI-size frame of
    # the slice phase's street
    f32 = segnet_as(model, torch.float32)
    x, y = cli_mod.TrainBatches(size, batch, device).heldout_world()
    labels = {dev: segnet_mod.infer(copy.deepcopy(f32).to(dev),
                                    x.to(dev)).cpu()
              for dev in (device, "cpu")}
    miou = {dev: float(segnet_mod.miou(lab, y.cpu(), 12))
            for dev, lab in labels.items()}
    par.check("learned labels f32, held-out world batch: pixels "
              "disagreeing card against CPU (share)",
              float((labels[device] != labels["cpu"]).float().mean()),
              1e-3, miou_card=miou[device], miou_cpu=miou["cpu"])
    cfg = segnet_config(path)
    frames, _, _, semantic = render_frames(cfg, device)
    system = SlamSystem(cfg, device=device)
    online = system._run_segnet(system._upload_gray(frames[3][0]))
    row["run_segnet_miou"] = float(segnet_mod.miou(
        online, semantic[3].to(online.device), 12))
    emit("train", step="learned labels", shape=[H, W],
         run_segnet_miou=row["run_segnet_miou"],
         labels=np.bincount(online.cpu().reshape(-1).numpy(),
                            minlength=12).tolist(),
         renderer_labels=np.bincount(semantic[3].cpu().reshape(-1).numpy(),
                                     minlength=12).tolist(), card=card)

    if device == "cuda":
        row["step"] = [train_step_row(hw, TRAIN_BATCH, card)
                       for hw in ((TRAIN_SIZE, TRAIN_SIZE), SEGNET_HW)]
    train_step_parity(par, device)
    row["weights"] = path
    return row


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args:
        if len(args) != 2 or args[0] != "--phases":
            raise SystemExit("usage: chip_smoke.py [--phases a,b,...]")
        return run_phases(args[1].split(","))
    info = phase_device()
    phase_build()
    row = phase_kernels()
    klt_row = phase_klt()
    cli = phase_cli(info["card"])
    rgbd = phase_rgbd(info["card"])
    with tempfile.TemporaryDirectory() as weights_dir:
        # the network the online-SegNet phases label keyframes with
        train = phase_train(info["card"], Path(weights_dir))
        slice_launches, frames, slice_system = phase_slice(
            info["card"], train["weights"])
        epoch = phase_epoch(info["card"])
        phase_segnet(slice_system, frames, info["card"])
        phase_stages(frames)
        phase_candidates(epoch)
        window = phase_window(info["card"])
        golden = phase_golden(info["card"])
        mesh = phase_mesh(info["card"])
        phase_parity(frames, epoch["system"], train["weights"])
    # the main path is the command line's slam; each path's count was
    # zeroed just before it and read just after
    row["launches"] = cli["launches"]["cli slam"]
    row["launches_by_path"] = {
        **cli["launches"], "rgbd": rgbd["sgm_launches"],
        "slice": slice_launches[row["name"]],
        "epoch": epoch["launches"][row["name"]],
        "window": window["launches"][row["name"]],
        "golden": golden["launches"][row["name"]],
        "mesh": mesh["launches"][row["name"]],
        "train-segnet": train["sgm_launches"],
        "train-segnet --mesh": mesh["training"]["cli"]["sgm_launches"]}
    klt_row["launches_by_path"] = {"window": window["launches"]["klt_track"]}
    print(json.dumps({"kernels": [row, klt_row]}), flush=True)
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": info["device"]}), flush=True)
    return 0


def sgbm_parity_alone(frames) -> None:
    """sgbm_batch_parity on the parity phase's frame pair."""
    cfg = SlamConfig()
    upload = SlamSystem(cfg, device="cuda")._upload_gray
    (pl, pr), (cl, cr) = frames[1], frames[2]
    img = {dev: [upload(x).to(dev) for x in (cl, cr, pl, pr)]
           for dev in ("cuda", "cpu")}
    sgbm_batch_parity(Parity(), img, cfg, "cuda")


def train_alone(card: str) -> None:
    """phase_train with its pickle in a temporary directory."""
    with tempfile.TemporaryDirectory() as weights_dir:
        phase_train(card, Path(weights_dir))


def run_phases(names) -> int:
    """The named phases alone, after device and build; no result line."""
    info = phase_device()
    phase_build()
    runs = {"kernels": lambda: phase_kernels(),
            "klt": lambda: phase_klt(),
            "window": lambda: phase_window(info["card"]),
            "epoch": lambda: phase_epoch(info["card"]),
            "golden": lambda: phase_golden(info["card"]),
            "mesh": lambda: phase_mesh(info["card"]),
            "train": lambda: train_alone(info["card"]),
            "sgbm_parity": lambda: sgbm_parity_alone(
                render_frames(SlamConfig())[0])}
    for name in names:
        if name not in runs:
            raise SystemExit(f"unknown phase {name}; one of {list(runs)}")
        runs[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
