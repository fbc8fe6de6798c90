#!/usr/bin/env python3
"""The golden run of the PyTorch/CUDA port: ``golden.py`` on the card.

The JAX package's acceptance run, step for step: a 500-frame loop circuit
at 376x1248 (radius 30 m, 1.25 laps, sinusoidal platform pitch, 6 moving
cars and pedestrians, a revisit of the start mid-run) through the whole
stereo system (``SlamSystem.process_stream`` and ``finish``), or with
``--rgbd`` the RGB-D system on gray and depth frames. Online SegNet labels
the keyframes when there are weights (``--weights``, e.g. the
``segnet.pkl`` of ``cli train-segnet``), else the renderer's labels do.

The world is the JAX package's own draw, ``make_loop_world(
jax.random.PRNGKey(seed), n_boxes, radius, n_moving=6)``, read from
``golden_worlds/loop_s{seed}_r{radius:g}_b{boxes}_m6.json``, which
``tools/torch_golden_world.py`` writes on a machine with JAX; the port
cannot replay ``jax.random`` and a missing file raises. The trajectory
and the texture are deterministic.

    python3 golden_torch.py --weights <dir>/segnet.pkl --round 1
    python3 golden_torch.py --rgbd --radius 10 --frames 300 --round 1 \\
        --json-out GOLDEN_torch_r01_rgbd.json

Writes the record (``GOLDEN_torch.json``, ``GOLDEN_torch_r{N:02d}.json``
with ``--round``, or ``--json-out``), the trajectory beside it
(``golden_torch_traj_r{N:02d}.npz``, or ``<record>.traj.npz`` with
``--json-out``), the map as PCD and an orthographic PNG, and a row of
``docs/GOLDEN_TORCH.md``. Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from semantic_slam_mapping_torch.backend import looper
from semantic_slam_mapping_torch.config import SlamConfig, default_config
from semantic_slam_mapping_torch.device import resolve
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.io import png, synthetic
from semantic_slam_mapping_torch.mapping import semantics
from semantic_slam_mapping_torch.ops import orb
from semantic_slam_mapping_torch.ops.cuda import sgm_cuda
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils import metrics

REPO = Path(__file__).resolve().parent

H, W = 376, 1248
RADIUS = 30.0
LAPS = 1.25
N_MOVING = 6
N_BOXES = 48
PITCH_AMP = 0.006
RENDER_CHUNK = 50
VOCAB_STRIDE = 12
WORLD_DIR = REPO / "golden_worlds"
# the checkpoint golden.py labels with, when it is there
JAX_SEGNET = REPO / "semantic_slam_mapping_tpu" / "models" / "weights" \
    / "segnet.pkl"
# the JAX package's records of the same circuits: (mode, seed, radius)
JAX_RECORDS = {("stereo", 7, 30.0): "GOLDEN_r05.json",
               ("rgbd", 7, 10.0): "GOLDEN_r05_rgbd.json",
               ("stereo", 8, 30.0): "GOLDEN_r04_seed8.json",
               ("stereo", 9, 30.0): "GOLDEN_r04_seed9.json"}
# what is printed beside the JAX values (no speed: the JAX runs were on a
# TPU)
COMPARED = ("ate_rmse_m", "rpe_trans_rmse_m", "keyframes", "loop_edges",
            "global_optimizations", "first_global_opt_frame", "map_voxels",
            "semantic_label_accuracy_vs_gt")
RUN_LOG = REPO / "docs" / "GOLDEN_TORCH.md"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--round", type=int, default=0,
                    help="round number of the GOLDEN_torch_r{N}.json "
                         "record")
    ap.add_argument("--no-mapping", action="store_true")
    ap.add_argument("--rgbd", action="store_true",
                    help="run the RGB-D system (ORB + PnP frontend, "
                         "depth-based clouds) on gray and depth frames of "
                         "the same circuit, with indoor keyframe gating "
                         "(pair with --radius 10)")
    ap.add_argument("--nearby", type=int, default=None,
                    help="override pose_graph.nearby_keyframes")
    ap.add_argument("--gt-semantics", action="store_true",
                    help="feed the renderer's labels instead of running "
                         "SegNet online")
    ap.add_argument("--seed", type=int, default=7, help="world seed")
    ap.add_argument("--radius", type=float, default=RADIUS,
                    help="loop radius in m")
    ap.add_argument("--laps", type=float, default=LAPS)
    ap.add_argument("--revisit-offset", type=float, default=0.0,
                    help="lateral lane offset (m) of the second lap")
    ap.add_argument("--boxes", type=int, default=N_BOXES)
    ap.add_argument("--label", default="",
                    help="annotation naming this run in the run log")
    ap.add_argument("--uniform-info", action="store_true",
                    help="uniform loop-edge information and a 25-inlier "
                         "floor (default: inlier-scaled, floor 12)")
    ap.add_argument("--json-out", default=None,
                    help="the record's path (default GOLDEN_torch_r{N}.json "
                         "/ GOLDEN_torch.json)")
    ap.add_argument("--weights", default=None,
                    help="SegNet pickle for online labels (default: the "
                         "JAX package's checkpoint, if it is there)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises with no card) or cpu")
    return ap.parse_args(argv)


def world_path(seed: int, radius: float, boxes: int) -> Path:
    return WORLD_DIR / f"loop_s{seed}_r{radius:g}_b{boxes}_m{N_MOVING}.json"


def load_world(args, device) -> synthetic.World:
    """The JAX package's world for these arguments, from its JSON."""
    path = world_path(args.seed, args.radius, args.boxes)
    if not path.is_file():
        raise FileNotFoundError(
            f"no world file {path}: write it on a machine with JAX with "
            f"`python tools/torch_golden_world.py --seed {args.seed} "
            f"--radius {args.radius:g} --boxes {args.boxes}`")
    return synthetic.load_world_json(path, device)


def segnet_weights(args) -> Optional[Path]:
    """The pickle online SegNet labels with; None: the renderer's labels."""
    if args.gt_semantics:
        return None
    if args.weights is not None:
        path = Path(args.weights)
        if not path.is_file():
            raise FileNotFoundError(f"no SegNet pickle {path}")
        return path
    return JAX_SEGNET if JAX_SEGNET.is_file() else None


def golden_config(args, width: int = W) -> SlamConfig:
    """``default_config()`` with golden.py's overrides, its intrinsics
    scaled to the image width (KITTI's at 1248), and online SegNet when
    there are weights."""
    cfg = default_config()
    pgc = cfg.pose_graph
    if args.nearby is not None:
        pgc = dataclasses.replace(pgc, nearby_keyframes=args.nearby)
    if args.uniform_info:
        pgc = dataclasses.replace(pgc, info_from_inliers=False,
                                  loop_min_inliers=25)
    if args.rgbd:
        # indoor keyframe gating: the KITTI 5.5 m would span many lifetimes
        # of the RGB-D frontend's reference ring
        pgc = dataclasses.replace(pgc, keyframe_min_translation=1.0,
                                  keyframe_min_rotation=0.4)
    s = width / W
    cam = dataclasses.replace(cfg.camera, fx=cfg.camera.fx * s,
                              fy=cfg.camera.fy * s, cx=cfg.camera.cx * s,
                              cy=cfg.camera.cy * s)
    cfg = cfg.replace(pose_graph=pgc, camera=cam)
    weights = segnet_weights(args)
    if weights is not None:
        cfg = cfg.replace(segnet=dataclasses.replace(
            cfg.segnet, online=True, weights=str(weights)))
    return cfg


def circuit_poses(args, device) -> torch.Tensor:
    """(frames, 4, 4) ground-truth camera-to-world poses of the circuit."""
    return synthetic.loop_trajectory(args.frames, radius=args.radius,
                                     laps=args.laps, pitch_amp=PITCH_AMP,
                                     revisit_offset=args.revisit_offset,
                                     device=device)


def render_circuit(cfg: SlamConfig, world: synthetic.World,
                   poses: torch.Tensor, height: int, width: int,
                   rgbd: bool, stop: Optional[int] = None) -> dict:
    """Frames 0..stop of the circuit, rendered in chunks on the poses'
    device and kept there: ``left`` and ``second`` (the right image, or
    the depth with ``rgbd``) as float16, ``semantic`` as int8. Each chunk
    passes its ``start_index``, the movers' time base."""
    K = Intrinsics.from_config(cfg.camera)
    stop = len(poses) if stop is None else stop
    left, second, sem = [], [], []
    for s in range(0, stop, RENDER_CHUNK):
        c = synthetic.render_sequence(K, world,
                                      poses[s:min(s + RENDER_CHUNK, stop)],
                                      height, width, start_index=s)
        left.append(c["left"].half())
        second.append((c["depth"] if rgbd else c["right"]).half())
        sem.append(c["semantic"].to(torch.int8))
    return dict(left=torch.cat(left), second=torch.cat(second),
                semantic=torch.cat(sem))


def sequence_vocabulary(cfg: SlamConfig, left: torch.Tensor
                        ) -> looper.Vocabulary:
    """The vocabulary of the sequence itself: ORB descriptors of every
    VOCAB_STRIDE-th left frame, clustered to branching 10, depth 4."""
    descs = []
    for i in range(0, len(left), VOCAB_STRIDE):
        f = orb.extract(left[i].float(), cfg.orb)
        descs.append(f.desc[f.valid].cpu().numpy())
    return looper.build_vocabulary(np.concatenate(descs), branching=10,
                                   depth=4)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_golden(args, cfg: SlamConfig, vocab, frames: dict,
               device: str | torch.device,
               log: Callable[[str], None] = print) -> dict:
    """The system over the rendered frames, each fed as a float32 tensor
    on the device (as golden.py feeds device arrays), then ``finish()``.
    Returns the system, the trajectory, the wall seconds and the first
    frame whose global optimisation had run (``mid_run_global``)."""
    device = resolve(device)
    left, second, sem = frames["left"], frames["second"], frames["semantic"]
    F = len(left)
    learned = cfg.segnet.online
    system = SlamSystem(cfg, vocab=vocab, enable_mapping=not args.no_mapping,
                        rgbd=args.rgbd, device=device)
    mid_run_global = None
    t0 = time.time()

    def frame_stream():
        # color None: the mapper colours voxels from the grey keyframe
        nonlocal mid_run_global
        for i in range(F):
            yield (left[i].float(), second[i].float(), None,
                   None if learned else sem[i])
            if system.n_global_optimizations > 0 and mid_run_global is None:
                mid_run_global = i
            if (i + 1) % 100 == 0:
                log(f"frame {i + 1}/{F}: kf={len(system.keyframes)} "
                    f"loops={system.n_loop_edges} "
                    f"opt={system.n_optimizations} "
                    f"({(i + 1) / (time.time() - t0):.2f} fps)")

    if args.rgbd:
        system.process_stream_rgbd(frame_stream())
    else:
        system.process_stream(frame_stream())
    traj = system.finish()
    _sync(device)
    wall = time.time() - t0
    return dict(system=system, traj=traj, wall=wall,
                mid_run_global=mid_run_global)


def tracked_ate(run: dict, gt: np.ndarray) -> float:
    """ATE RMSE (m) of every frame but the newest, after checking that the
    newest stands at the last keyframe's pose. ``finish()``'s forced
    global optimisation puts it there, as the JAX package's does (a
    reference behaviour, ROADMAP.md section 3), so on a short prefix that
    one frame, up to a keyframe interval away, dominates the RMSE and says
    nothing of the odometry."""
    traj, kfs = run["traj"], run["system"].keyframes
    if len(kfs) > 1:
        err = float(np.abs(traj[-1] - kfs[-1].pose).max())
        if err > 1e-5:
            raise AssertionError(f"the newest frame is {err} from the last "
                                 f"keyframe's pose")
    return float(metrics.absolute_trajectory_error(traj[:-1],
                                                   gt[:-1]).rmse)


def card_name() -> Optional[str]:
    """The first card's name and power limit as nvidia-smi prints them,
    or None where there is no nvidia-smi."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0] if lines else None


def jax_reference(args) -> Optional[dict]:
    """The JAX package's record of the same circuit, where there is one:
    its file and the compared numbers."""
    name = JAX_RECORDS.get(("rgbd" if args.rgbd else "stereo", args.seed,
                            float(args.radius)))
    if name is None or not (REPO / name).is_file():
        return None
    rec = json.loads((REPO / name).read_text())
    return {"file": name, "frames": rec.get("frames"),
            "semantics": rec.get("semantics"),
            **{k: rec.get(k) for k in COMPARED}}


def make_record(args, run: dict, frames: dict, gt: np.ndarray,
                card: Optional[str] = None) -> dict:
    """golden.py's record of this run, with the card, the world file and
    the port's own measurements."""
    system, traj = run["system"], run["traj"]
    F = len(frames["left"])
    H_, W_ = frames["left"].shape[1:]
    learned = system.cfg.segnet.online
    ate = metrics.absolute_trajectory_error(traj, gt)
    rpe_t, rpe_r = metrics.relative_pose_error(traj, gt)
    sem_acc = None
    if learned and system.keyframes:
        sem = frames["semantic"]
        accs = [float(np.mean(k.semantic.astype(np.int32)
                              == sem[k.frame_index].cpu().numpy()))
                for k in system.keyframes if k.semantic is not None]
        sem_acc = round(float(np.mean(accs)), 4) if accs else None
    mid = run["mid_run_global"]
    excluded = None
    if system.map is not None:
        lbl = system.map.as_arrays()[2]
        excluded = int(np.isin(lbl, semantics.MAP_EXCLUDED_CLASSES).sum())
    stages = system.timer.summary()
    global_s = stages.get("optimize/global", {"total_s": 0.0})["total_s"]
    dev = system.device
    rec = {
        "sequence": (("rgbd-" if args.rgbd else "")
                     + f"golden-loop r={args.radius} laps={args.laps} "
                       f"moving={N_MOVING} pitch={PITCH_AMP}"),
        "mode": "rgbd" if args.rgbd else "stereo",
        "seed": args.seed,
        "label": args.label,
        "edge_info": ("uniform+floor25" if args.uniform_info
                      else "inlier-scaled+floor12"),
        "semantics": "learned-online" if learned else "ground-truth",
        "semantic_label_accuracy_vs_gt": sem_acc,
        "frames": F,
        "resolution": [int(H_), int(W_)],
        "ate_rmse_m": round(float(ate.rmse), 4),
        "ate_mean_m": round(float(ate.mean), 4),
        "rpe_trans_rmse_m": round(float(rpe_t.rmse), 4),
        "rpe_rot_rmse_deg": round(float(np.degrees(rpe_r.rmse)), 4),
        "keyframes": len(system.keyframes),
        "loop_edges": system.n_loop_edges,
        "revisit_offset_m": args.revisit_offset,
        "loop_candidate_inliers": sorted(int(v) for v in
                                         system.loop_candidate_inliers),
        # (pnp_inliers, viso_ok, dt_m, dr_deg, dt_rev_m) per candidate
        "loop_verify_log": [[int(v[0]), bool(v[1]), round(float(v[2]), 3),
                             round(float(v[3]), 2), round(float(v[4]), 3)]
                            for v in system.loop_verify_log],
        "loop_edge_inliers": sorted(int(v) for v in
                                    system.loop_edge_inliers),
        "borderline_loop_edges": sum(
            1 for v in system.loop_edge_inliers if 12 <= v < 50),
        "global_optimizations": system.n_global_optimizations,
        "local_optimizations": system.n_local_optimizations,
        "first_global_opt_frame": mid,
        "mid_run_revisit_closed": bool(mid is not None and mid < 0.95 * F),
        "recoveries": system.n_recoveries,
        "map_voxels": len(system.map) if system.map is not None else None,
        "fps": round(F / run["wall"], 3),
        "device": dev.type,
        # the port's own fields
        "card": card,
        "keyframe_frames": [k.frame_index for k in system.keyframes],
        "torch": torch.__version__,
        "world_file": str(world_path(args.seed, args.radius, args.boxes)
                          .relative_to(REPO)),
        "world_loaded_from_json": True,
        "weights": system.cfg.segnet.weights if learned else None,
        "wall_s": round(run["wall"], 3),
        "excluded_class_voxels": excluded,
        "global_optimization_s": round(global_s, 3),
        "global_optimization_share": round(global_s / run["wall"], 4),
        "peak_memory_mb": (round(torch.cuda.max_memory_allocated(dev)
                                 / 2 ** 20, 1)
                           if dev.type == "cuda" else None),
        "stage_times": {k: {"calls": v["calls"],
                            "total_s": round(v["total_s"], 3),
                            "mean_ms": round(v["mean_ms"], 2)}
                        for k, v in sorted(stages.items())},
        "jax_reference": jax_reference(args),
    }
    return rec


def _map_view():
    """tools/map_view.py (numpy only; its save_png needs Pillow and is not
    used)."""
    spec = importlib.util.spec_from_file_location(
        "map_view", REPO / "tools" / "map_view.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_outputs(rec: dict, run: dict, gt: np.ndarray, json_path: Path,
                  traj_path: Path) -> dict:
    """The record, the trajectory and, when there is a map, its PCD and
    the PNG of its top and side projections (written with the port's
    codec). Returns the paths written."""
    json_path.write_text(json.dumps(rec, indent=2) + "\n")
    system = run["system"]
    np.savez(traj_path, est=run["traj"], gt=gt,
             keyframe_poses=np.array([k.pose for k in system.keyframes]),
             keyframe_frames=np.array([k.frame_index
                                       for k in system.keyframes]))
    out = {"record": json_path, "trajectory": traj_path}
    if system.map is not None and len(system.map):
        map_view = _map_view()
        pcd = json_path.with_suffix(".pcd")
        system.map.save_pcd(str(pcd))
        xyz, rgb = map_view.read_pcd(str(pcd))
        top, side = map_view.render(xyz, rgb, px=0.15)
        gap = 8
        canvas = np.zeros((top.shape[0] + gap + side.shape[0],
                           max(top.shape[1], side.shape[1]), 3), np.uint8)
        canvas[:top.shape[0], :top.shape[1]] = top
        canvas[top.shape[0] + gap:, :side.shape[1]] = side
        out["pcd"] = pcd
        out["png"] = json_path.with_suffix(".map.png")
        png.write_png(out["png"], canvas)
    return out


def append_run_log(rec: dict, args, md: Path = RUN_LOG,
                   commit: Optional[str] = None) -> None:
    """A row of the port's golden run log (``docs/GOLDEN_TORCH.md``);
    ``commit`` names the code that ran (default: git's HEAD, ``?`` where
    there is no repository)."""
    if not md.exists():
        md.write_text(
            "# Golden runs of the PyTorch/CUDA port\n\n"
            "golden.py's circuits through `golden_torch.py` on the card; "
            "the JAX package's runs are in `docs/GOLDEN.md`.\n\n"
            "| round | frames | ATE rmse (m) | RPE trans (m) | RPE rot "
            "(deg) | keyframes | loop edges | global opts | mid-run "
            "closure | semantics | fps | card |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    if commit is None:
        try:
            commit = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                capture_output=True, text=True, timeout=30).stdout.strip()
        except (FileNotFoundError, subprocess.TimeoutExpired):
            commit = ""
    commit = commit or "?"
    with open(md, "a") as f:
        f.write(f"| r{args.round} {args.label} ({rec['mode']}, seed "
                f"{args.seed}, r={args.radius:g}, laps={args.laps:g}, "
                f"{commit}) | {rec['frames']} | {rec['ate_rmse_m']} | "
                f"{rec['rpe_trans_rmse_m']} | {rec['rpe_rot_rmse_deg']} | "
                f"{rec['keyframes']} | {rec['loop_edges']} | "
                f"{rec['global_optimizations']} | "
                f"{rec['mid_run_revisit_closed']} | {rec['semantics']} | "
                f"{rec['fps']} | {rec['card'] or rec['device']} |\n")


def output_paths(args) -> tuple[Path, Path]:
    """(record, trajectory) paths."""
    if args.json_out:
        out = Path(args.json_out)
        return out, out.with_suffix(".traj.npz")
    name = f"GOLDEN_torch_r{args.round:02d}.json" if args.round \
        else "GOLDEN_torch.json"
    return REPO / name, REPO / f"golden_torch_traj_r{args.round:02d}.npz"


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve(args.device)
    card = card_name() if device.type == "cuda" else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cfg = golden_config(args)
    world = load_world(args, device)
    poses = circuit_poses(args, device)
    print(f"rendering {args.frames} frames at {H}x{W} on {device} "
          f"({card or device.type})", flush=True)
    t0 = time.time()
    frames = render_circuit(cfg, world, poses, H, W, args.rgbd)
    _sync(device)
    render_s = time.time() - t0
    gt = poses.cpu().numpy().astype(np.float64)
    print(f"rendered in {render_s:.1f}s", flush=True)

    t0 = time.time()
    vocab = sequence_vocabulary(cfg, frames["left"])
    vocab_s = time.time() - t0
    print(f"vocab: {vocab.n_leaves} leaves in {vocab_s:.1f}s", flush=True)
    print("semantics: " + (f"LEARNED (online SegNet, {cfg.segnet.weights})"
                           if cfg.segnet.online else "ground-truth labels"),
          flush=True)

    sgm_cuda.sgm_aggregate4.launches = 0
    run = run_golden(args, cfg, vocab, frames, device)
    sgm_launches = sgm_cuda.sgm_aggregate4.launches
    print(run["system"].timer.report(), flush=True)
    rec = make_record(args, run, frames, gt, card)
    rec.update(render_s=round(render_s, 3), vocab_s=round(vocab_s, 3),
               vocab_leaves=vocab.n_leaves, sgm_launches=sgm_launches)
    json_path, traj_path = output_paths(args)
    written = write_outputs(rec, run, gt, json_path, traj_path)
    print(json.dumps(rec), flush=True)
    ref = rec["jax_reference"]
    if ref is not None:
        print(f"port vs JAX ({ref['file']}): " + ", ".join(
            f"{k} {rec[k]} vs {ref[k]}" for k in COMPARED), flush=True)
    print("peak device memory: "
          f"{rec['peak_memory_mb']} MB; K1 launches {sgm_launches}; global "
          f"optimisations {rec['global_optimization_s']} s "
          f"({rec['global_optimization_share']} of the run); written: "
          + ", ".join(str(p) for p in written.values()), flush=True)
    append_run_log(rec, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
