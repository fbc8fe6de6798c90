"""Rank bodies of the port's multi-device tests
(``tests/test_torch_{parallel,sharded_frontend,sharded_map,
sharded_segnet,train_cli_mesh}.py``).

A test writes its inputs to ``inputs.npz`` in a temporary directory and
calls :func:`run_ranks`, which spawns n processes over gloo (a ``file://``
rendezvous in that directory, one CPU thread each; with ``init=False`` the
body joins the group itself); rank r runs one of the bodies below and
writes what it computed to ``out_r{r}.npz``, which the test then holds to
the JAX package and to the port's single-device path. The ranks import
torch and the port only: they run no ``conftest.py`` and never import JAX.
"""

from __future__ import annotations

import multiprocessing
import sys
import time
from pathlib import Path

import numpy as np
import torch

# a rank that waits in a collective for a rank that failed would hang
JOIN_TIMEOUT_S = 150


def run_ranks(body: str, n: int, tmp: Path, init: bool = True) -> list:
    """Run ``body`` on n ranks; returns each rank's outputs (dicts of
    arrays). Raises if a rank fails or does not finish in time."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(body, r, n, str(tmp), init))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.time() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(10)
    assert not hung, f"{len(hung)} of {n} ranks of {body} did not finish"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * n, f"{body} ranks exited with {codes}"
    out = []
    for r in range(n):
        with np.load(tmp / f"out_r{r}.npz") as f:
            out.append(dict(f))
    return out


def _rank(body: str, rank: int, n: int, tmp: str, init: bool) -> None:
    import torch.distributed as dist

    from semantic_slam_mapping_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    tmp = Path(tmp)
    if init:
        world = pmesh.initialize_distributed(
            f"file://{tmp / f'store_{body}_{n}'}", n, rank, device="cpu")
        assert world == n
        # a second call is a no-op
        assert pmesh.initialize_distributed(device="cpu") == n
    try:
        with np.load(tmp / "inputs.npz") as f:
            inputs = dict(f)
        out = globals()[body](inputs, rank, n)
        jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                            ("jax", "semantic_slam_mapping_tpu"))
        assert not jax_loaded, jax_loaded
        np.savez(tmp / f"out_r{rank}.npz", **out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _t(a, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# test_torch_parallel.py


def mesh_and_pcg(inputs: dict, rank: int, n: int) -> dict:
    """Mesh shapes, then the edge-sharded solve twice on a (n, 1) mesh and
    once on the graph cut to an edge count that n does not divide."""
    from semantic_slam_mapping_torch.backend import pose_graph as pg
    from semantic_slam_mapping_torch.config import PoseGraphConfig
    from semantic_slam_mapping_torch.parallel import mesh as pmesh
    from semantic_slam_mapping_torch.parallel import sharded_pcg

    shapes = []
    for dp, tp in ((None, None), (n, 1), (None, n), (1, None)):
        m = pmesh.make_mesh(n, dp=dp, tp=tp, device="cpu")
        assert m.mesh_dim_names == (pmesh.DATA_AXIS, pmesh.MODEL_AXIS)
        shapes.append([pmesh.axis_size(m, pmesh.DATA_AXIS),
                       pmesh.axis_size(m, pmesh.MODEL_AXIS)])
    try:
        pmesh.make_mesh(n, dp=n, tp=2, device="cpu")
        refused = False
    except ValueError:
        refused = True

    mesh = pmesh.make_mesh(n, dp=n, tp=1, device="cpu")
    g = pg.PoseGraph(*(_t(inputs[k]) for k in pg.PoseGraph._fields))
    cfg = PoseGraphConfig(pcg_iters=int(inputs["pcg_iters"]))
    iters = int(inputs["iters"])
    mask = pg.global_free_mask(g)
    pmesh.reset_counts()
    a = sharded_pcg.optimize_sharded(g, mask, mesh, cfg, iters=iters)
    counts = pmesh.counts()
    b = sharded_pcg.optimize_sharded(g, mask, mesh, cfg, iters=iters)
    E = int(inputs["odd_edges"])
    cut = g._replace(**{k: getattr(g, k)[:E] for k in pg.PoseGraph._fields
                        if k.startswith("edge_")})
    c = sharded_pcg.optimize_sharded(cut, mask, mesh, cfg, iters=iters)
    return {"shapes": np.array(shapes), "refused": np.array(refused),
            "poses_a": a.poses.numpy(), "poses_b": b.poses.numpy(),
            "poses_odd": c.poses.numpy(),
            "all_reduce_calls": np.array(counts["all_reduce_sum"]["calls"])}


def sharded_bow(inputs: dict, rank: int, n: int) -> dict:
    """The sparse database scan at M = 2048 and the dense one at M = 64,
    rows split over a (n, 1) mesh."""
    from semantic_slam_mapping_torch.parallel import mesh as pmesh
    from semantic_slam_mapping_torch.parallel import sharded_bow as sb

    mesh = pmesh.make_mesh(n, dp=n, tp=1, device="cpu")
    s, m = sb.get_possible_loops_sparse_sharded(
        _t(inputs["q_idx"]), _t(inputs["q_w"]), _t(inputs["db_idx"]),
        _t(inputs["db_w"]), _t(inputs["ids"]), _t(inputs["valid"]),
        int(inputs["qid"]), mesh, 0.015, 60)
    ds, dm = sb.get_possible_loops_sharded(
        _t(inputs["dense_q"]), _t(inputs["dense_db"]),
        _t(inputs["dense_ids"]), _t(inputs["dense_valid"]),
        int(inputs["dense_qid"]), mesh, 0.015, 60)
    block = sb.shard_database(_t(inputs["db_idx"]), mesh)
    return {"scores": s.numpy(), "mask": m.numpy(),
            "dense_scores": ds.numpy(), "dense_mask": dm.numpy(),
            "block_rows": np.array(block.shape[0])}


# ---------------------------------------------------------------------------
# test_torch_sharded_frontend.py


def _window_config(inputs: dict):
    import json

    from semantic_slam_mapping_torch.utils import convert

    return convert.config_from_dict(json.loads(str(inputs["cfg_json"])))


def sharded_window(inputs: dict, rank: int, n: int) -> dict:
    """track_frames_sharded on a (n, 1) mesh: with the JAX-drawn samples
    through the function form of ``picks``, then drawing from a generator
    seeded 0."""
    from semantic_slam_mapping_torch.frontend import tracker
    from semantic_slam_mapping_torch.parallel import mesh as pmesh
    from semantic_slam_mapping_torch.parallel.sharded_frontend import (
        gather_result, track_frames_sharded)
    from semantic_slam_mapping_torch.utils import convert

    cfg = _window_config(inputs)
    K = convert.intrinsics_from_numpy(*inputs["K"])
    mesh = pmesh.make_mesh(n, dp=n, tp=1, device="cpu")
    lefts, rights = _t(inputs["lefts"]), _t(inputs["rights"])
    seen = []

    def picks(n_valid):
        seen.append(n_valid.numpy())
        return _t(inputs["picks"])

    st0 = tracker.TrackerState.initial(cfg, "cpu")
    st, out = track_frames_sharded(st0, lefts, rights, K, None, cfg, mesh,
                                   picks=picks)
    local_pairs = out.disparity.shape[0]
    full = gather_result(out, mesh)
    gen = torch.Generator().manual_seed(0)
    st_g, out_g = track_frames_sharded(st0, lefts, rights, K, gen, cfg,
                                       mesh)
    return {"pose": full.pose.numpy(), "status": full.status.numpy(),
            "T_delta": full.T_delta.numpy(),
            "disparity": full.disparity.numpy(),
            "valid_px": (full.disparity > 0).numpy(),
            "n_matches": full.n_matches.numpy(),
            "n_inliers": full.n_inliers.numpy(),
            "vo_success": full.vo_success.numpy(),
            "pitch": full.pitch.numpy(),
            "moving_mask": full.moving_mask.numpy(),
            "lc": full.matches.lc.numpy(),
            "state_pose": st.pose.numpy(),
            "state_pitch_x": st.pitch_kf.x.numpy(),
            "seen_n_valid": np.stack(seen), "local_pairs":
            np.array(local_pairs), "gen_pose": out_g.pose.numpy(),
            "gen_state_pose": st_g.pose.numpy()}


def mesh_system(inputs: dict, rank: int, n: int) -> dict:
    """SlamSystem(mesh=...) over two overlapping windows with a
    vocabulary and the map, then finish()."""
    from semantic_slam_mapping_torch.backend import looper
    from semantic_slam_mapping_torch.parallel import mesh as pmesh
    from semantic_slam_mapping_torch.parallel.sharded_map import \
        ShardedGlobalMap
    from semantic_slam_mapping_torch.pipeline import SlamSystem

    cfg = _window_config(inputs)
    vocab = looper.build_vocabulary(inputs["vocab_desc"], 4, 2)
    mesh = pmesh.make_mesh(n, dp=n, tp=1, device="cpu")
    system = SlamSystem(cfg, vocab=vocab, enable_mapping=True, device="cpu",
                        mesh=mesh)
    assert isinstance(system.map, ShardedGlobalMap)
    lefts, rights, labels = inputs["lefts"], inputs["rights"], \
        inputs["labels"]
    pmesh.reset_counts()
    frame_counts = []
    for lo, hi in inputs["windows"]:
        system.process_window(lefts[lo:hi], rights[lo:hi],
                              semantics=labels[lo:hi])
        frame_counts.append(system.frame_count)
    traj = np.stack(system.trajectory)
    final = system.finish()
    counts = pmesh.counts()
    xyz, _, lbl = system.map.as_arrays()
    return {"trajectory": traj, "finish": final,
            "frame_counts": np.array(frame_counts),
            "keyframes": np.array([k.frame_index for k in system.keyframes]),
            "n_optimizations": np.array(system.n_optimizations),
            "statuses": np.array([f.status for f in system.frame_log]),
            "calls": np.array([counts[k]["calls"] for k in
                               ("all_gather", "all_reduce_sum",
                                "ring_exchange")]),
            "map_xyz": xyz, "map_label": lbl,
            "map_len": np.array(len(system.map))}


# ---------------------------------------------------------------------------
# test_torch_sharded_map.py


def fuse_scenarios(inputs: dict, rank: int, n: int) -> dict:
    """fuse_cloud on each scenario of the inputs (``s{i}_xyz`` ...), the
    states gathered to (n, budget)."""
    from semantic_slam_mapping_torch.parallel import mesh as pmesh
    from semantic_slam_mapping_torch.parallel import sharded_map as sm

    mesh = pmesh.make_mesh(n, dp=n, tp=1, device="cpu")
    budget, res, ext = (int(inputs["budget"]), float(inputs["res"]),
                        float(inputs["ext"]))
    out = {}
    for i in range(int(inputs["n_scenarios"])):
        state = sm.empty_map(mesh, budget)
        for j in range(int(inputs[f"s{i}_fusions"])):
            state = sm.fuse_cloud(
                state, _t(inputs[f"s{i}_xyz"]), _t(inputs[f"s{i}_rgb"]),
                _t(inputs[f"s{i}_valid"]), mesh, budget=budget,
                resolution=res, x_extent=ext,
                min_support=int(inputs[f"s{i}_support"]),
                label=_t(inputs[f"s{i}_label"]))
        full = sm.gather_state(state, mesh)
        for k, v in full._asdict().items():
            out[f"s{i}_{k}"] = v.numpy()
        out[f"s{i}_local_valid"] = np.array(int(state.valid.sum()))
    return out


def sharded_global_map(inputs: dict, rank: int, n: int) -> dict:
    """ShardedGlobalMap over three clouds; its PCD; and the mesh-mode
    system's map."""
    from semantic_slam_mapping_torch.parallel import mesh as pmesh
    from semantic_slam_mapping_torch.parallel.sharded_map import \
        ShardedGlobalMap
    from semantic_slam_mapping_torch.pipeline import SlamSystem
    from semantic_slam_mapping_torch.config import SlamConfig

    mesh = pmesh.make_mesh(n, dp=n, tp=1, device="cpu")
    smap = ShardedGlobalMap(mesh, float(inputs["res"]), budget=1 << 12,
                            x_extent=8.0, pad_points=512)
    for i in range(int(inputs["n_clouds"])):
        smap.insert(inputs[f"xyz{i}"], inputs[f"rgb{i}"],
                    inputs[f"label{i}"])
    xyz, rgb, lbl = smap.as_arrays()
    n_len = len(smap)
    system = SlamSystem(SlamConfig(), enable_mapping=True, device="cpu",
                        mesh=mesh)
    out = {"xyz": xyz, "rgb": rgb, "label": lbl, "len": np.array(n_len),
           "system_map_sharded": np.array(
               isinstance(system.map, ShardedGlobalMap)),
           "system_map_resolution": np.array(system.map.resolution)}
    if rank == 0:
        smap.save_pcd(str(Path(inputs["pcd_dir"].item()) / "map.pcd"))
    else:
        smap.as_arrays()       # the export gathers on every rank
    return out


# ---------------------------------------------------------------------------
# test_torch_sharded_segnet.py

# the meshes of sharded_grads by world size: ((dp, tp), batch, classes)
GRAD_CASES = {2: (((1, 2), 4, 12), ((2, 1), 4, 12), ((2, 1), 3, 12),
                  ((1, 2), 4, 11)),
              3: (((1, 3), 4, 12),),
              4: (((2, 2), 4, 12), ((1, 4), 4, 12))}


def grad_case_key(shape, batch: int, classes: int) -> str:
    return f"{shape[0]}x{shape[1]}_b{batch}_c{classes}"


def segnet_start(inputs: dict, dtype: torch.dtype, classes: int = 12):
    """The full SegNet of the inputs' start (``state.<name>`` entries,
    the JAX package's initial parameters carried across) in ``dtype``,
    its classifier cut to ``classes``."""
    from semantic_slam_mapping_torch.models import segnet

    model = segnet.SegNet(num_classes=classes, dtype=dtype,
                          width_mult=float(inputs["width"])).to(dtype)
    state = {k[len("state."):]: _t(v) for k, v in inputs.items()
             if k.startswith("state.")}
    for k in ("classifier.weight", "classifier.bias"):
        state[k] = state[k][:classes]
    model.load_state_dict(state)
    return model


def full_grads(model, mesh) -> dict:
    """The gradients of a sharded model's parameters, split ones gathered
    over the model axis."""
    from semantic_slam_mapping_torch.parallel import mesh as pmesh

    group = pmesh.axis_group(mesh, pmesh.MODEL_AXIS)
    return {name: (pmesh.all_gather(p.grad, group)
                   if model.shardings[name] is not None else p.grad)
            for name, p in model.named_parameters()}


def sharded_grads(inputs: dict, rank: int, n: int) -> dict:
    """The float64 sharded loss, gradients (gathered) and the BatchNorm
    buffers after the train-mode forward, on each mesh of
    ``GRAD_CASES[n]``; and the shardings of a full-width SegNet on the
    world's (1, n) mesh."""
    from semantic_slam_mapping_torch.models import segnet
    from semantic_slam_mapping_torch.parallel import mesh as pmesh
    from semantic_slam_mapping_torch.parallel import sharded_segnet as ss

    out = {}
    for shape, batch, classes in GRAD_CASES[n]:
        key = grad_case_key(shape, batch, classes)
        mesh = pmesh.make_mesh(n, *shape, device="cpu")
        model = pmesh.shard_params(
            segnet_start(inputs, torch.float64, classes), mesh)
        pmesh.reset_counts()
        loss = ss.loss_and_grads(
            model, _t(inputs["images"][:batch]),
            _t(inputs["labels"][:batch] % classes), mesh,
            label_valid=_t(inputs["valid"][:batch]),
            class_weights=_t(inputs["class_weights"][:classes],
                             torch.float64))
        counts = pmesh.counts()
        images = _t(inputs["images"][:batch])
        assert pmesh.replicated(mesh)(images) is images
        out[f"{key}/rows"] = pmesh.batch_sharding(mesh)(images).numpy()
        out[f"{key}/loss"] = loss.numpy()
        for k in ("all_gather", "all_reduce_sum", "reduce_scatter"):
            out[f"{key}/calls.{k}"] = np.array(counts[k]["calls"])
        for name, g in full_grads(model, mesh).items():
            out[f"{key}/grad.{name}"] = g.numpy()
        for name, b in pmesh.gather_params(model, mesh).named_buffers():
            out[f"{key}/buffer.{name}"] = b.numpy()
    wide = pmesh.param_shardings(segnet.SegNet(width_mult=1.0),
                                 pmesh.make_mesh(n, 1, n, device="cpu"))
    out["full_width_split"] = np.array(
        [name for name, dim in wide.items() if dim is not None])
    return out


def sharded_adam(inputs: dict, rank: int, n: int) -> dict:
    """Three sharded Adam steps on a (2, 2) mesh from the inputs' start:
    twice in float32, once in float64; after each step the loss and the
    gathered state (parameters and buffers)."""
    from semantic_slam_mapping_torch.parallel import mesh as pmesh
    from semantic_slam_mapping_torch.parallel import sharded_segnet as ss

    mesh = pmesh.make_mesh(n, 2, 2, device="cpu")
    out = {}
    for run, dtype in (("f32a", torch.float32), ("f32b", torch.float32),
                       ("f64", torch.float64)):
        model = pmesh.shard_params(segnet_start(inputs, dtype), mesh)
        step = ss.make_sharded_train_step(
            model, mesh, float(inputs["lr"]),
            class_weights=_t(inputs["class_weights"]).to(dtype))
        for i in range(3):
            loss = step(_t(inputs[f"x{i}"]).to(dtype), _t(inputs[f"y{i}"]))
            out[f"{run}/{i}/loss"] = loss.numpy()
            full = pmesh.gather_params(model, mesh)
            for name, v in full.state_dict().items():
                out[f"{run}/{i}/state.{name}"] = v.numpy()
            # a replicated parameter is the same on every model rank
            for name, p in model.named_parameters():
                if model.shardings[name] is None:
                    out[f"{run}/{i}/replica.{name}"] = p.detach().numpy()
    return out


# ---------------------------------------------------------------------------
# test_torch_train_cli_mesh.py


def train_cli_mesh(inputs: dict, rank: int, n: int) -> dict:
    """``cli train-segnet --mesh --device cpu`` as torchrun starts it: the
    rank's environment set, then the command with its stdout and stderr
    captured."""
    import contextlib
    import io
    import os

    from semantic_slam_mapping_torch import cli

    os.environ.update(MASTER_ADDR="localhost",
                      MASTER_PORT=str(int(inputs["port"])),
                      WORLD_SIZE=str(n), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), \
            contextlib.redirect_stderr(stderr):
        cli.main(list(inputs["argv"]) + ["--mesh"])
    return {"stdout": np.array(stdout.getvalue()),
            "stderr": np.array(stderr.getvalue())}
