"""The port's tracing primitive, ``utils/timing.span``, and its ranges over
a small stereo run.

Test 1: ``span`` calls no ``torch.profiler.record_function`` while no
profiler runs (counted by patching it), and opens one range per call, under
its name, inside ``torch.profiler.profile``; ``StageTimer.stage`` opens a
range of the stage's own name around its timing, and the timer keeps host
times only (no counters, no synchronising argument).

Test 2: 13 frames of a synthetic street at 96x192 through
``SlamSystem.process_window`` (windows of 4 pairs) with the map on and the
rendered labels, then ``finish()``, all under ``torch.profiler`` on the
CPU: the leaf spans and stages appear, each nested in the range it belongs
to (the frontend's inside ``window``, the keyframe epoch's inside
``frame/host``, each ``sync/*`` inside its stage), and the stage timer has
``sync/*`` entries.
"""

import inspect

import torch

from semantic_slam_mapping_torch.config import (CameraConfig, MapperConfig,
                                                OrbConfig, PoseGraphConfig,
                                                SgbmConfig, SlamConfig,
                                                VoConfig)
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.io import synthetic
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils.timing import StageTimer, span

torch.set_num_threads(4)
H, W, B, N_FRAMES = 96, 192, 4, 13
CFG = SlamConfig(
    camera=CameraConfig(fx=150.0, fy=150.0, cx=W / 2, cy=H / 2,
                        baseline=0.54),
    sgbm=SgbmConfig(num_disparities=32, sad_window_size=5,
                    p1=8 * 25, p2=32 * 25, speckle_window_size=20),
    vo=VoConfig(ransac_iters=24, gn_iters_hypothesis=6, gn_iters_refine=10),
    orb=OrbConfig(n_features=256, n_levels=3),
    pose_graph=PoseGraphConfig(keyframe_min_translation=0.7,
                               keyframe_min_rotation=5.0, pcg_iters=10,
                               global_iters=3, max_keyframes=32),
    mapper=MapperConfig(full_rebuild_every=3))


def _sequence(n):
    gen = torch.Generator().manual_seed(11)
    world = synthetic.make_world(gen, n_boxes=14, device="cpu")
    poses = synthetic.straight_trajectory(n, speed=0.45, yaw_rate=0.01,
                                          device="cpu")
    seq = synthetic.render_sequence(Intrinsics.from_config(CFG.camera),
                                    world, poses, H, W)
    return {k: v.numpy() for k, v in seq.items()}


def test_span_opens_a_range_only_under_the_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timer = StageTimer()
    for _ in range(3):
        with span("leaf"):
            torch.ones(4).add_(1)
        with timer.stage("outer"):
            with span("inner"):
                torch.ones(4).mul_(2)
    assert opened == []
    assert timer.count["outer"] == 3 and set(timer.total) == {"outer"}

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.stage("outer"):
            with span("inner"):
                torch.ones(4).mul_(2)
        with span("leaf"):
            pass
    assert opened == ["outer", "inner", "leaf"]
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name in ("outer", "inner", "leaf")}
    assert set(ranges) == {"outer", "inner", "leaf"}
    assert ranges["outer"].start <= ranges["inner"].start
    assert ranges["inner"].end <= ranges["outer"].end
    assert ranges["leaf"].start >= ranges["outer"].end
    # a leaf span adds nothing to the timer; a stage counts once more
    assert timer.count["outer"] == 4 and set(timer.total) == {"outer"}

    assert list(inspect.signature(StageTimer.stage).parameters) == [
        "self", "name"]
    for gone in ("counters", "add"):
        assert not hasattr(StageTimer(), gone)


def _profiled_run():
    """The window run under the profiler: the system and each range's
    (start, end) by name."""
    seq = _sequence(N_FRAMES)
    system = SlamSystem(CFG, enable_mapping=True, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for s in range(0, N_FRAMES - 1, B):
            system.process_window(seq["left"][s:s + B + 1],
                                  seq["right"][s:s + B + 1],
                                  semantics=seq["semantic"][s:s + B + 1])
        system.finish()
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    return system, ranges


def _inside(ranges, child, parents):
    """Every ``child`` range lies inside a range of one of ``parents``."""
    outer = [r for p in parents for r in ranges.get(p, [])]
    return all(any(a <= s and e <= b for a, b in outer)
               for s, e in ranges[child])


def test_spans_nest_in_their_stages():
    system, ranges = _profiled_run()
    assert len(system.keyframes) >= 6
    nesting = {
        "sgbm/cost_volume": ["window"], "sgbm/aggregate": ["window"],
        "sgbm/select": ["window"], "quadmatch": ["window"],
        "klt/level": ["quadmatch"], "klt/step": ["klt/level"],
        "klt/residual": ["klt/level"],
        "vo/ransac": ["window"], "vo/gn_step": ["vo/ransac"],
        "uv/pitch": ["window"], "uv/pitch_kalman": ["window"],
        "uv/moving": ["window"], "tracker/integrate": ["window"],
        "cc/sweep": ["sgbm/select", "uv/moving", "map/cloud"],
        "sync/poses": ["frontend"],
        "kf/features": ["frame/host"], "orb/level": ["orb/extract"],
        "edges/pnp": ["kf/nearby_edges"], "pnp/lm_step": ["pnp/solve"],
        "pnp/regate": ["pnp/solve"], "pnp/inliers": ["pnp/solve"],
        "map/points": ["map/cloud"],
        "sync/edges": ["edges/readback"], "sync/map": ["map/readback"],
        "map/insert": ["map/update"],
        "pose_graph/linearize": ["pose_graph/lm"],
        "pose_graph/pcg_step": ["pose_graph/lm"],
        "pose_graph/accept": ["pose_graph/lm"],
        "pose_graph/lm": ["optimize/global", "kf/optimize"],
        "sync/optimize": ["optimize/global"],
    }
    for child, parents in nesting.items():
        assert child in ranges, child
        assert _inside(ranges, child, parents), (child, parents)
    # ORB and the PnP gate run inside these stages, and in the re-anchoring
    # after an optimisation too
    for parent, child in (("kf/features", "orb/extract"),
                          ("edges/pnp", "pnp/solve")):
        assert all(any(s <= a and b <= e for a, b in ranges[child])
                   for s, e in ranges[parent]), (parent, child)
    assert len(ranges["frame/host"]) == N_FRAMES - 1
    assert len(ranges["window"]) == len(ranges["sync/poses"]) == 3

    syncs = {k for k in system.timer.total if k.startswith("sync/")}
    assert {"sync/poses", "sync/edges", "sync/map_count", "sync/map",
            "sync/optimize", "sync/state_pose"} <= syncs
    assert all(system.timer.count[k] > 0 for k in syncs)
