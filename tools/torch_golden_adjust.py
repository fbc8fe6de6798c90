"""The PnP refinement of the frontend's re-anchoring in a golden run.

After an optimisation, ``SlamSystem._adjust_frontend`` moves the newest
dispatched frame by PnP against the optimised keyframe
(``_pnp_to_ref``). This tool runs ``golden_torch.py``'s stereo circuit
(the renderer's labels) with every such PnP recorded: its
inputs (the keyframe's and the live frame's ORB features, the initial
pose), the port's result, and how far the result lies from the initial
pose. On the card:

    python3 tools/torch_golden_adjust.py --seed 9 --out out/adjust

writes ``<out>/adjust_s9.npz`` and prints one JSON line per call. Then,
on a machine with JAX, ``--replay <out>/adjust_s9.npz`` solves each
recorded problem again with the JAX package's ``solve_pnp_lazy`` and the
port's on the CPU, and prints the three results side by side, so that a
refinement that lands far from its initial pose can be told a fault of
the port or the reference's own behaviour.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

INPUTS = ("desc_ref", "xyz_ref", "valid_ref", "desc_cur", "xy_cur",
          "valid_cur")
CAMERA = ("fx", "fy", "cx", "cy", "baseline")


def _offset(T_init: np.ndarray, T: np.ndarray) -> tuple[float, float]:
    """(metres, degrees) between two ref-to-cur transforms."""
    d = np.linalg.inv(T_init) @ T
    ang = np.arccos(np.clip(0.5 * (np.trace(d[:3, :3]) - 1.0), -1.0, 1.0))
    return float(np.linalg.norm(d[:3, 3])), float(np.degrees(ang))


def record(seed: int, out: Path, device: str, height: int, width: int,
           stop: int) -> None:
    import torch

    import golden_torch
    from semantic_slam_mapping_torch import pipeline
    from semantic_slam_mapping_torch.backend import pnp

    args = golden_torch.parse_args(["--gt-semantics", "--seed", str(seed),
                                    "--device", device])
    cfg = golden_torch.golden_config(args, width=width)
    world = golden_torch.load_world(args, device)
    poses = golden_torch.circuit_poses(args, device)
    frames = golden_torch.render_circuit(cfg, world, poses, height, width,
                                         args.rgbd, stop=stop)
    vocab = golden_torch.sequence_vocabulary(cfg, frames["left"])

    calls, inside = [], []
    to_ref, solve = pipeline.SlamSystem._pnp_to_ref, pnp.solve_pnp_lazy
    # the arguments are read by name: a renamed parameter raises here
    ref_sig, solve_sig = inspect.signature(to_ref), inspect.signature(solve)
    missing = ({"self", "ref"} - set(ref_sig.parameters)) | (
        {*INPUTS, "T_init"} - set(solve_sig.parameters))
    if missing:
        raise TypeError(f"_pnp_to_ref / solve_pnp_lazy lack {missing}")

    def pnp_to_ref(*a, **k):
        bound = ref_sig.bind(*a, **k).arguments
        inside.append((bound["ref"].kf_id, bound["self"]._dispatched))
        try:
            return to_ref(*a, **k)
        finally:
            inside.pop()

    def solve_recorded(*a, **k):
        info = solve(*a, **k)
        if inside:
            kf, frame = inside[-1]
            arg = solve_sig.bind(*a, **k).arguments
            T_init = arg["T_init"].detach().cpu().double().numpy()
            T = info.T.detach().cpu().double().numpy()
            calls.append(dict(
                kf=kf, dispatched=frame,
                **{n: arg[n].detach().cpu().numpy() for n in INPUTS},
                T_init=T_init, T=T, success=bool(info.success),
                n_matches=int(info.n_matches),
                n_inliers=int(info.n_inliers)))
            dt, dr = _offset(T_init, T)
            print(json.dumps({"kf": kf, "dispatched": frame,
                              "success": calls[-1]["success"],
                              "n_matches": calls[-1]["n_matches"],
                              "n_inliers": calls[-1]["n_inliers"],
                              "from_init_m": dt, "from_init_deg": dr}),
                  flush=True)
        return info

    pipeline.SlamSystem._pnp_to_ref = pnp_to_ref
    pnp.solve_pnp_lazy = solve_recorded
    try:
        run = golden_torch.run_golden(args, cfg, vocab, frames, device)
    finally:
        pipeline.SlamSystem._pnp_to_ref = to_ref
        pnp.solve_pnp_lazy = solve
    gt = poses[:stop].cpu().numpy().astype(np.float64)
    rec = golden_torch.make_record(args, run, frames, gt,
                                   golden_torch.card_name())
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"adjust_s{seed}.npz"
    np.savez(path, **{f"{i}_{k}": v for i, c in enumerate(calls)
                      for k, v in c.items()},
             n_calls=len(calls),
             camera=np.array([getattr(cfg.camera, k) for k in CAMERA]))
    print(json.dumps({k: rec[k] for k in (
        "seed", "ate_rmse_m", "rpe_trans_rmse_m", "keyframe_frames",
        "global_optimizations", "local_optimizations", "card")}),
        flush=True)
    print(f"wrote {path} ({len(calls)} calls, torch {torch.__version__})",
          flush=True)


def replay(path: Path) -> None:
    import jax.numpy as jnp
    import torch

    from semantic_slam_mapping_tpu import config as jcfg
    from semantic_slam_mapping_tpu.backend import pnp as jpnp
    from semantic_slam_mapping_tpu.geometry.camera import Intrinsics as JK
    from semantic_slam_mapping_torch import config as tcfg
    from semantic_slam_mapping_torch.backend import pnp as tpnp
    from semantic_slam_mapping_torch.config import OrbConfig, PnpConfig
    from semantic_slam_mapping_torch.geometry.camera import Intrinsics

    d = np.load(path)
    cam = dict(zip(CAMERA, d["camera"].tolist()))
    jk = JK.from_config(jcfg.CameraConfig(**cam))
    tk = Intrinsics.from_config(tcfg.CameraConfig(**cam))
    ratio = OrbConfig().knn_match_ratio
    for i in range(int(d["n_calls"])):
        c = {k: d[f"{i}_{k}"] for k in (*INPUTS, "T_init", "T", "success",
                                         "n_inliers", "kf", "dispatched")}
        T_init = c["T_init"].astype(np.float32)
        j = jpnp.solve_pnp_lazy(*(jnp.asarray(c[n]) for n in INPUTS), jk,
                                jnp.asarray(T_init), jcfg.PnpConfig(),
                                ratio)
        t = tpnp.solve_pnp_lazy(*(torch.from_numpy(c[n]) for n in INPUTS),
                                tk, torch.from_numpy(T_init), PnpConfig(),
                                ratio)
        row = {"kf": int(c["kf"]), "dispatched": int(c["dispatched"])}
        for name, (ok, n_in, T) in {
                "card": (bool(c["success"]), int(c["n_inliers"]), c["T"]),
                "port_cpu": (bool(t.success), int(t.n_inliers),
                             t.T.double().numpy()),
                "jax_cpu": (bool(j.success), int(j.n_inliers),
                            np.asarray(j.T, np.float64))}.items():
            dt, dr = _offset(c["T_init"], T)
            row[name] = {"success": ok, "n_inliers": n_in,
                         "from_init_m": round(dt, 4),
                         "from_init_deg": round(dr, 3)}
        row["card_vs_jax_m"] = round(_offset(
            c["T"], np.asarray(j.T, np.float64))[0], 6)
        print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--out", default="out/adjust")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--width", type=int, default=1248)
    ap.add_argument("--frames", type=int, default=500,
                    help="run the circuit's first frames only")
    ap.add_argument("--replay", default=None,
                    help="an npz this tool wrote: solve its problems with "
                         "JAX and the port on the CPU")
    args = ap.parse_args()
    if args.replay:
        replay(Path(args.replay))
    else:
        record(args.seed, Path(args.out), args.device, args.height,
               args.width, args.frames)


if __name__ == "__main__":
    main()
