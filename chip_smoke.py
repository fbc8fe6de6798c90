#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one flushed JSON line with the seconds elapsed:

1. ``device``: the card's name, count, and name and power limit from
   nvidia-smi. Fails when there is no CUDA device.
2. ``build``: compiles the kernel source of the port's main path with
   nvcc for sm_90a into build/torch_kernels/ (``-Xptxas -v`` prints its
   registers and spills).
3. ``kernels``: holds each kernel against its plain PyTorch version on the
   card, exactly (tolerance 0) and in the volume's dtype, at the main
   path's shape in float32 and bfloat16, and at a few small and ragged
   shapes; then times the kernel and each of its two launches with CUDA
   events (median of 25 batches of 10 calls after 3 warm-ups; the 75 MB
   volume exceeds the 50 MB L2, so it runs cold), and the launches of variants built with one
   part switched off, to show what bounds it.
4. ``slice``: renders 10 KITTI-size (376x1248) stereo frames of a
   fixed-seed synthetic street on the card and runs them through
   ``SlamSystem(cfg, device="cuda").process_stream`` with the default
   configuration (80 disparities, 11x11 window, bfloat16 cost volume, 512
   features, 200 RANSAC hypotheses). Every kernel launch count is zeroed
   just before and read just after; each kernel must have been launched,
   and every SGM aggregate of the run must be bfloat16.
   Every tracked frame must have a VO success, the trajectory's ATE RMSE
   against the rendered ground truth must be below 0.3 m, and the results
   must live on the card.
5. ``stages``: times each stage of one frontend step on the card, then
   profiles one step: device-busy time, idle share, launches, top kernels.

Then the kernels line ``{"kernels": [...]}``, the card's name and power
limit as nvidia-smi gives them, and last ``{"ok": true, "device": ...}``.
Any failure raises and the script exits non-zero without that last line.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from semantic_slam_mapping_torch.config import SlamConfig
from semantic_slam_mapping_torch.frontend import quadmatch, tracker, vo
from semantic_slam_mapping_torch.frontend import uvdisparity as uvd
from semantic_slam_mapping_torch.geometry import stereo as gstereo
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.io import synthetic
from semantic_slam_mapping_torch.ops import sgbm
from semantic_slam_mapping_torch.ops.cuda import sgm_cuda
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils.metrics import ate_rmse

T0 = time.time()
H, W = 376, 1248
N_FRAMES = 10
ATE_BOUND_M = 0.3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
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
    emit("build", seconds=round(time.time() - t, 2), libraries=[lib.name])


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


def phase_slice(card: str):
    cfg = SlamConfig()
    t = time.time()
    frames, gt, gt_moving = render_frames(cfg)
    torch.cuda.synchronize()
    emit("slice", step="rendered", frames=len(frames), shape=[H, W],
         seconds=round(time.time() - t, 2))

    warm = SlamSystem(cfg, device="cuda")       # warm-up: one tracked frame
    for left, right in frames[:2]:
        warm.process_frame(left, right)
    torch.cuda.synchronize()

    # sgbm.compute looks _aggregate up at each call: record the dtype of
    # every aggregate the main path makes
    agg_dtypes = []
    aggregate = sgbm._aggregate

    def recording_aggregate(vol, sgbm_cfg):
        agg = aggregate(vol, sgbm_cfg)
        agg_dtypes.append(agg.dtype)
        return agg

    system = SlamSystem(cfg, device="cuda")
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
               last.matches.lc, system.state.pose]
    if not all(x.device.type == "cuda" for x in on_card):
        raise AssertionError("a result of the main path is not on the card")
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
         last_frame_moving_iou=iou, card=card)
    if not ate < ATE_BOUND_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_BOUND_M} m")
    return launches, frames


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


def main() -> int:
    info = phase_device()
    phase_build()
    row = phase_kernels()
    launches, frames = phase_slice(info["card"])
    phase_stages(frames)
    row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": [row]}), flush=True)
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": info["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
