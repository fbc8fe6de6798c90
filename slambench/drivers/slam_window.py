"""Offline stereo SLAM in windows: ``SlamSystem.process_window`` on windows
of B pairs of a rendered drive, back to back, then ``finish()``. When the
drive runs out inside the measured window, the system finishes and a new
one starts over the same frames; the count goes on.

Checked, once the window has closed, against the plain references:

- ``disp_bad_pct``: of a seeded sample of the frames tracked (one frame a
  window, drawn as it runs), the program's disparity against the float32
  reference SGBM on the same pair: the worst frame's share of pixels where
  they disagree (one valid and not the other, or more than 1 px apart);
- ``label_wrong_pct``: the online SegNet labels of a seeded sample of the
  last system's keyframes against the float32 reference network on the
  same image: the share of their pixels whose label's logit lies more than
  ``label_gap_spreads`` standard deviations of the logits below the best
  (see ``segnet_label.py`` for why not the widest gap);
- ``rpe_p90_pct``: each system's ``finish()`` trajectory against the
  rendered ground truth: the error of the motion over ``rpe_frames``
  frames as a share of its length, its 90th percentile over the
  trajectory, the worst system's. A state handed back unchanged breaks
  the third of the stretches that cross a window's edge, half a window
  left out all of them; a sound run's few frames gone astray (one seed in
  eighteen lost 11 m in one jump) and ``finish()``'s newest frame stay
  under the percentile. (The ATE after a rigid alignment, in the notes,
  is not compared: it sums the drift of a few hundred metres.)
- ``map_median_off_m``: a seeded sample of the last system's voxels, each
  moved into the rendered world through its nearest keyframe (its
  estimated pose, then its true one, so that drift drops out), against
  that world: the median distance to the nearest surface.
- ``map_missing_pct`` and ``map_label_mix_pct``: the last system's map
  against the clouds of the keyframes that the map's policy holds, made
  and fused as the configuration states the mapping does it, from the
  keyframes' own disparities, labels and poses (outputs that the numbers
  above check; the rendered world stands in for the frontend's moving
  mask): the share of the fused clouds' voxels that the map's count falls
  short of, and half the L1 distance between the two histograms of voxel
  labels (whole counts: the final optimisation moves the poses that the
  map took the clouds with).
"""

from __future__ import annotations

import dataclasses
import gc
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from semantic_slam_mapping_torch.config import SlamConfig
from semantic_slam_mapping_torch.frontend import tracker
from semantic_slam_mapping_torch.models import segnet
from semantic_slam_mapping_torch.pipeline import SlamSystem
from slambench.core import weights
from slambench.core.readers import STAGE
from slambench.core.result import Check, Context, Outcome
from slambench.core.window import run_window
from slambench.reference import geometry
from slambench.reference import segnet as ref_segnet
from slambench.reference import sgbm as ref_sgbm
from slambench.traffic import street


def _replace(cfg, key: str, value):
    section, name = key.split(".")
    return dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **{name: value})})


def slam_config(ctx: Context, weights_path: str) -> SlamConfig:
    """``SlamConfig()`` with the configuration's overrides and the drawn
    SegNet weights; raises where it differs from what the file states."""
    cfg = SlamConfig()
    for key, value in ctx.config("overrides").items():
        cfg = _replace(cfg, key, value)
    cfg = _replace(cfg, "segnet.weights", weights_path)
    cam, sg = ctx.config("camera"), ctx.config("sgbm")
    stated = {**{f"camera.{k}": v for k, v in cam.items()},
              **{f"sgbm.{k}": v for k, v in sg.items()},
              "sgbm.cost_dtype": ctx.config("precision")["cost_volume"],
              "segnet.dtype": ctx.config("precision")["network"],
              "gftt.max_corners": ctx.config("gftt_max_corners"),
              "vo.ransac_iters": ctx.config("ransac_hypotheses"),
              "orb.n_features": ctx.config("orb_features"),
              "pose_graph.keyframe_min_translation":
                  ctx.config("keyframe_min_translation_m"),
              "pose_graph.keyframe_min_rotation":
                  ctx.config("keyframe_min_rotation_deg"),
              "mapper.resolution": ctx.config("map_resolution_m"),
              "mapper.max_distance": ctx.config("map_max_distance_m"),
              "mapper.cloud_stride": ctx.config("map_cloud_stride"),
              "mapper.dilate_iters": ctx.config("map_dilate_iters"),
              "mapper.full_rebuild_every":
                  ctx.config("map_full_rebuild_every"),
              "mapper.full_rebuild_stride":
                  ctx.config("map_full_rebuild_stride"),
              "mapper.incremental_window":
                  ctx.config("map_incremental_window"),
              "segnet.num_classes": ctx.config("segnet_classes")}
    wrong = {}
    for key, value in stated.items():
        section, name = key.split(".")
        got = getattr(getattr(cfg, section), name)
        if (abs(got - value) > 1e-6 * max(1.0, abs(value))
                if isinstance(value, float) else got != value):
            wrong[key] = (value, got)
    pad = [-(-cfg.segnet.input_height // 32) * 32,
           -(-cfg.segnet.input_width // 32) * 32]
    if pad != [ctx.config("segnet_height"), ctx.config("segnet_width")]:
        wrong["segnet input"] = ([ctx.config("segnet_height"),
                                  ctx.config("segnet_width")], pad)
    if wrong:
        raise ValueError(f"the program's settings differ from the "
                         f"configuration file (stated, got): {wrong}")
    return cfg


@dataclasses.dataclass
class _KeyframeRecord:
    """What the check reads of a keyframe, on the host."""
    frame_index: int
    pose: np.ndarray
    disparity: np.ndarray
    semantic: np.ndarray


@dataclasses.dataclass
class _Segment:
    trajectory: np.ndarray
    lost: int


class _Drive:
    """The program under the window: a system, its place in the drive, and
    what the finished systems left."""

    def __init__(self, make, lefts, rights, B, rng):
        self.make, self.lefts, self.rights, self.B = make, lefts, rights, B
        self.rng = rng
        self.system = make()
        self.k = 0
        self.windows = (len(lefts) - 1) // B
        self.segments = []
        self.kept = []                 # (frame, program disparity)
        self.frames = self.steps = 0
        self.done_keyframes = 0
        self.done_stages = {}

    def step(self, i: int) -> int:
        if self.k == self.windows:
            self.finish()
            self.done_keyframes += len(self.system.keyframes)
            for name, s in self.system.timer.total.items():
                self.done_stages[name] = self.done_stages.get(name, 0.0) + s
            self.system = self.make()
            self.k = 0
        s, B = self.k * self.B, self.B
        out = self.system.process_window(self.lefts[s:s + B + 1],
                                         self.rights[s:s + B + 1])
        j = int(self.rng.integers(B))
        self.kept.append((s + j + 1, out.disparity[j].clone()))
        self.k += 1
        self.frames += B
        self.steps += 1
        return B

    def finish(self) -> None:
        traj = self.system.finish()
        lost = sum(f.status == tracker.LOST for f in self.system.frame_log)
        self.segments.append(_Segment(traj, lost))

    def probe(self) -> dict:
        stages = dict(self.done_stages)
        for name, s in self.system.timer.total.items():
            stages[name] = stages.get(name, 0.0) + s
        return {"frames": self.frames, "windows": self.steps,
                "keyframes": self.done_keyframes + len(self.system.keyframes),
                **{STAGE + k: v for k, v in stages.items()}}


def segnet_input(img: np.ndarray, hw, device) -> torch.Tensor:
    """(h, w, 3) network input of a grey (H, W) frame: the grey value in
    three channels, resized with the antialiased linear weights of
    ``jax.image.resize`` (the port's online-label path)."""
    x = torch.as_tensor(img, device=device).float()[None].expand(3, -1, -1)
    for axis, n_out in ((1, hw[0]), (2, hw[1])):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        inv = np.float32(1.0 / (n_out / n_in))
        scale = max(inv, np.float32(1.0))
        sf = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
            - np.float32(0.5)
        d = np.abs(sf[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
        w = np.maximum(np.float32(0.0), np.float32(1.0) - d / scale)
        tot = w.sum(axis=0, keepdims=True, dtype=np.float32)
        w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                     w / np.where(tot != 0, tot, np.float32(1.0)), 0.0)
        w = np.where(((sf >= -0.5) & (sf <= n_in - 0.5))[None, :], w, 0.0)
        wt = torch.as_tensor(w.astype(np.float32), device=device)
        x = (torch.einsum("cyx,yo->cox", x, wt) if axis == 1
             else torch.einsum("cyx,xo->cyo", x, wt))
    return x.permute(1, 2, 0)


def nearest_source(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output of a nearest resize (the port's
    ``resize_nearest``: floor((i + 0.5) n_in / n_out) in float32)."""
    return np.floor((np.arange(n_out, dtype=np.float32) + 0.5)
                    * np.float32(n_in / n_out)).astype(np.int64)


def reference_logits(ctx, layers, frame: np.ndarray, hw,
                     precision: str = "float32") -> torch.Tensor:
    """The reference network's (h, w, C) logits of a grey frame."""
    x = segnet_input(frame, hw, ctx.device)[None]
    with ref_segnet.exact_float32(), torch.no_grad():
        return ref_segnet.forward(layers, x, precision=precision)[0]


def full_size(logits: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Network-size logits at each pixel of the (H, W) frame, through the
    nearest resize that takes the labels there."""
    sy = torch.as_tensor(nearest_source(logits.shape[0], H),
                         device=logits.device)
    sx = torch.as_tensor(nearest_source(logits.shape[1], W),
                         device=logits.device)
    return logits[sy][:, sx]


def label_gaps(ctx, layers, frame: np.ndarray, labels, hw) -> torch.Tensor:
    """Per pixel, the logit gap of a keyframe's (H, W) labels against the
    reference on the same frame (with ``labels`` None, of the float8
    control's labels at the network's own size)."""
    logits = reference_logits(ctx, layers, frame, hw)
    if labels is None:
        lab = reference_logits(ctx, layers, frame, hw, "float8")
        return ref_segnet.logit_gap(logits, lab.argmax(-1))
    at = full_size(logits, *labels.shape)
    got = torch.gather(at, -1, torch.as_tensor(
        labels.astype(np.int64), device=ctx.device)[..., None])[..., 0]
    return (at.amax(-1) - got) / logits.std()


def fused_keyframes(n: int, every: int, stride: int, window: int) -> set:
    """The keyframes whose clouds the map holds after the updates of ``n``
    keyframes, by the policy that the configuration states: every
    ``every``-th update a rebuild from every ``stride``-th keyframe so far,
    else the last ``window`` keyframes not yet in."""
    held = set()
    for u in range(1, n + 1):
        if u % every == 0:
            held = set(range(0, u, stride))
        else:
            held |= set(range(max(0, u - window), u))
    return held


_B = 1 << 20


def _keys(q: np.ndarray) -> np.ndarray:
    """Integer voxel coordinates (n, 3) packed into one int64 each."""
    q = q.astype(np.int64) + _B
    return (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]


def _voxel(xyz: np.ndarray, resolution: float) -> np.ndarray:
    inv = np.float32(1.0) / np.float32(resolution)
    return np.floor(xyz.astype(np.float32) * inv).astype(np.int64)


def keyframe_cloud(ctx, cam: dict, kf, static: np.ndarray):
    """The world points of a keyframe's cloud as the configuration states
    the mapping makes it, from the keyframe's own disparity, labels and
    pose: every ``map_cloud_stride``-th pixel, depth f * b / d, kept within
    ``map_max_distance_m`` where its label is not excluded, it is outside
    the moving classes dilated ``map_dilate_iters`` times, and the rendered
    world shows a static surface there. (points (n, 3), labels (n,))"""
    st = ctx.config("map_cloud_stride")
    disp = kf.disparity.astype(np.float32)[::st, ::st]
    lab = kf.semantic.astype(np.int64)[::st, ::st]
    fx, fy, cx, cy, b = (np.float32(cam[k]) for k in
                         ("fx", "fy", "cx", "cy", "baseline"))
    valid = disp > 0.5
    depth = np.where(valid, (fx * b) / np.where(valid, disp, 1), 0)
    moving = np.isin(lab, ctx.config("map_motion_classes"))
    grow = 2 * ctx.config("map_dilate_iters") + 1
    moving = F.max_pool2d(torch.as_tensor(moving, dtype=torch.float32)
                          [None, None], grow, 1, grow // 2)[0, 0].numpy() > 0
    keep = ((depth > 1e-3) & (depth < ctx.config("map_max_distance_m"))
            & ~moving & ~np.isin(lab, ctx.config("map_excluded_classes"))
            & static[::st, ::st])
    v, u = np.nonzero(keep)
    z = depth[v, u]
    s32 = np.float32(st)
    pts = np.stack([(u - cx / s32) * z / (fx / s32),
                    (v - cy / s32) * z / (fy / s32), z], -1)
    pts = np.round(pts * 64.0) / 64.0
    return pts @ kf.pose[:3, :3].T + kf.pose[:3, 3], lab[v, u]


def map_readings(ctx, p: dict, cam: dict, world: dict, kfs,
                 xyz: np.ndarray, lbl: np.ndarray) -> dict:
    """The map (voxel means ``xyz``, majority labels ``lbl``) against the
    clouds of the keyframes ``kfs`` that the map's policy holds, made and
    fused as the configuration states: ``map_missing_pct``, the share of
    the fused clouds' voxels that the map's count falls short of; and
    ``map_label_mix_pct``, the share of voxels whose label would have to
    change for the map's mix of labels to be the fused clouds' (half the
    L1 distance of the two histograms of voxel labels). Both compare whole
    counts, so that the poses that a keyframe had when the map took its
    cloud, which the final optimisation moves, do not enter."""
    res, classes = ctx.config("map_resolution_m"), ctx.config(
        "segnet_classes")
    held = sorted(fused_keyframes(len(kfs),
                                  ctx.config("map_full_rebuild_every"),
                                  ctx.config("map_full_rebuild_stride"),
                                  ctx.config("map_incremental_window")))
    keys, labs = [], []
    for i in held:
        static = street.static_mask(cam, p, world, kfs[i].frame_index,
                                    ctx.device)
        pts, lab = keyframe_cloud(ctx, cam, kfs[i], static)
        keys.append(_keys(_voxel(pts, res)))
        labs.append(lab)
    keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    labs = np.concatenate(labs) if labs else np.zeros(0, np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    counts = np.zeros((len(uniq), classes))
    np.add.at(counts, (inv, labs), 1.0)
    expected = np.bincount(counts.argmax(1), minlength=classes) \
        if len(uniq) else np.zeros(classes)
    got = np.bincount(lbl.astype(np.int64), minlength=classes)[:classes]
    n_exp, n_got = float(expected.sum()), float(got.sum())
    if n_exp == 0:
        return {"map_missing_pct": float("nan"),
                "map_label_mix_pct": float("nan"), "map_held": len(held)}
    mix = (50.0 * float(np.abs(got / n_got - expected / n_exp).sum())
           if n_got else 100.0)
    return {"map_missing_pct": 100.0 * max(0.0, 1.0 - n_got / n_exp),
            "map_label_mix_pct": mix,
            "map_held": len(held), "map_voxels_expected": int(n_exp),
            "map_labels": got.tolist(),
            "map_labels_expected": expected.astype(int).tolist()}


def wrong_pct(gaps, spreads: float) -> float:
    """Share (%) of the pixels whose gap exceeds ``spreads``."""
    return 100.0 * float(sum(int((g > spreads).sum()) for g in gaps)
                         / sum(g.numel() for g in gaps))


def street_segnet(ctx: Context, lefts: np.ndarray, hw) -> list:
    """The SegNet weights of the drive: drawn from the seed, the
    classifier's biases then centred on the drive's first frame (see
    ``reference/segnet.centre_classes``), so that the share of pixels that
    the map leaves out by class, and with it the map's work, is alike from
    seed to seed."""
    layers = weights.segnet_layers(ctx.sub_seed("weights"),
                                   ctx.config("segnet_classes"), ctx.device)
    ref_segnet.centre_classes(layers, segnet_input(lefts[0], hw,
                                                   ctx.device)[None])
    return layers


def run(ctx: Context) -> Outcome:
    dev = ctx.device
    p = {k: ctx.traffic(k) for k in ctx.cell.traffic}
    cam = dict(ctx.config("camera"), height=ctx.config("height"),
               width=ctx.config("width"))
    B = p["window_pairs"]
    world = street.make_world(ctx.sub_seed("world"), p, dev)
    truth = street.poses(p)
    lefts, rights = street.render_street(cam, p, world, dev)
    classes = ctx.config("segnet_classes")
    hw = (ctx.config("segnet_height"), ctx.config("segnet_width"))

    with tempfile.TemporaryDirectory(prefix="slambench_") as tmp:
        path = str(Path(tmp) / "segnet.pkl")
        cfg = slam_config(ctx, path)
        layers = street_segnet(ctx, lefts, hw)
        with torch.device(dev):
            model = segnet.SegNet(num_classes=classes,
                                  width_mult=cfg.segnet.width_mult)
        model.load_state_dict(weights.port_state(layers))
        segnet.save_checkpoint(path, cfg.segnet, model)
        del model, layers
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        def make():
            return SlamSystem(cfg, vocab=None, seed=ctx.sub_seed("program"),
                              enable_mapping=True, device=dev)

        warm = make()
        warm.process_window(lefts[:B + 1], rights[:B + 1])
        warm.finish()
        del warm
        drive = _Drive(make, lefts, rights, B,
                       np.random.default_rng(ctx.sub_seed("sample")))
        res = run_window(drive.step, ctx.seconds, finish=drive.finish,
                         trace=ctx.trace, stretch_steps=p["stretch_steps"],
                         probe=drive.probe, device=dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = res.trace()

    # what is judged, to the host; then the program goes
    rng = np.random.default_rng(ctx.sub_seed("check"))
    system = drive.system
    kfs = system.keyframes
    pick = rng.choice(len(kfs), min(p["check_keyframes"], len(kfs)),
                      replace=False)
    kf_labels = [(kfs[i].frame_index, np.asarray(kfs[i].semantic))
                 for i in sorted(pick)]
    kf_frames = np.array([kf.frame_index for kf in kfs])
    kf_poses = np.stack([kf.pose for kf in kfs]).astype(np.float64)
    xyz, _, lbl = system.map.as_arrays()
    n_voxels = len(xyz)
    voxels = xyz[rng.choice(len(xyz), min(p["check_voxels"], len(xyz)),
                            replace=False)].astype(np.float64)
    kf_records = [_KeyframeRecord(kf.frame_index, kf.pose.astype(np.float64),
                                  np.asarray(kf._host("disparity")),
                                  np.asarray(kf._host("semantic")))
                  for kf in kfs]
    disps = [drive.kept[i] for i in sorted(rng.choice(
        len(drive.kept), min(p["check_frames"], len(drive.kept)),
        replace=False))]
    disps = [(f, d.cpu()) for f, d in disps]
    segments = drive.segments
    del drive, system, kfs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    nums = {}
    sg = ctx.config("sgbm")
    worst = 0.0
    for f, d in disps:
        ref = ref_sgbm.disparity(torch.as_tensor(lefts[f], device=dev),
                                 torch.as_tensor(rights[f], device=dev), sg)
        prog = torch.where(d.to(dev) > 0, d.to(dev), ref_sgbm.INVALID)
        worst = max(worst, 100.0 * ref_sgbm.bad_pixel_share(prog, ref))
    nums["disp_bad_pct"] = worst
    layers = street_segnet(ctx, lefts, hw)
    nums["label_wrong_pct"] = wrong_pct(
        [label_gaps(ctx, layers, lefts[f], lab, hw) for f, lab in kf_labels],
        p["label_gap_spreads"])
    got = map_readings(ctx, p, cam, world, kf_records, xyz, lbl)
    nums["map_missing_pct"] = got.pop("map_missing_pct")
    nums["map_label_mix_pct"] = got.pop("map_label_mix_pct")
    control = got
    del layers, xyz, lbl
    ates = [geometry.ate(s.trajectory, truth[:len(s.trajectory)])
            for s in segments]
    nums["rpe_p90_pct"] = max(
        geometry.rpe_pct(s.trajectory, truth[:len(s.trajectory)],
                         min(p["rpe_frames"], len(s.trajectory) - 1))
        for s in segments)
    dist = geometry.surface_distance(
        geometry.relocate(voxels, kf_poses, truth[kf_frames]), world,
        kf_frames)
    nums["map_median_off_m"] = float(np.median(dist))
    limits = p["limits"]
    return Outcome(
        rates={"frames_per_s": res.rate}, setup_s=res.started - ctx.t_start,
        attempted=int(res.work), failed=sum(s.lost for s in segments),
        memory_peak_bytes=peak,
        checks=[Check(k, v, limits[k] if limits[k] is not None
                      else float("nan")) for k, v in nums.items()],
        trace=trace,
        notes={"window_s": res.seconds, "windows": res.steps,
               "systems": len(segments), "keyframes": len(kf_frames),
               "voxels": n_voxels, "ates_m": [a[0] for a in ates],
               "checked_frames": [f for f, _ in disps],
               "checked_keyframes": [f for f, _ in kf_labels],
               "reference_s": time.perf_counter() - t, **control})


def control(ctx: Context) -> dict:
    """The control's readings at the cell's size on the seed's drive: the
    float8 references put in the program's place (SGBM's cost volume and
    path costs in float8_e5m2, SegNet's convolutions in float8_e4m3fn)
    against the float32 ones, on frames drawn as the check draws them."""
    dev = ctx.device
    p = {k: ctx.traffic(k) for k in ctx.cell.traffic}
    cam = dict(ctx.config("camera"), height=ctx.config("height"),
               width=ctx.config("width"))
    world = street.make_world(ctx.sub_seed("world"), p, dev)
    lefts, rights = street.render_street(cam, p, world, dev)
    rng = np.random.default_rng(ctx.sub_seed("check"))
    frames = rng.choice(np.arange(1, len(lefts)), p["check_frames"] +
                        p["check_keyframes"], replace=False)
    sg = ctx.config("sgbm")
    worst = 0.0
    for f in frames[:p["check_frames"]]:
        args = (torch.as_tensor(lefts[f], device=dev),
                torch.as_tensor(rights[f], device=dev), sg)
        worst = max(worst, 100.0 * ref_sgbm.bad_pixel_share(
            ref_sgbm.disparity(*args, precision="float8_e5m2"),
            ref_sgbm.disparity(*args)))
    hw = (ctx.config("segnet_height"), ctx.config("segnet_width"))
    layers = street_segnet(ctx, lefts, hw)
    gap = wrong_pct([label_gaps(ctx, layers, lefts[f], None, hw)
                     for f in frames[p["check_frames"]:]],
                    p["label_gap_spreads"])
    return {"disp_bad_pct": worst, "label_wrong_pct": gap}
