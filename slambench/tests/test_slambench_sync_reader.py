"""``sync.host_ms_per_frame``: the program's ``sync/*`` stages over the
stretch's frames, and nothing from a program that has none; and the names
of the program's stages and spans against the host-time readers.

The last test reads every range name in the program's source
(``timer.stage("...")`` and ``span("...")``): each name the stage timer did
not have before the profiler ranges came is read by none of the host-time
readers of the frontend, the keyframe epoch and the backend (so their stage
sets stay as they were), and names neither the harness's own spans nor its
``window`` stage; the stages among them are ``sync/*`` stages.

The card test holds the program to what the metric assumes: on the card,
no call outside a ``sync/*`` stage blocks the host on the device.
"""

import re
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch

from slambench.core import registry
from slambench.core.readers import STAGE
from slambench.core.trace import TraceData

PROGRAM = Path(__file__).resolve().parents[2] / "semantic_slam_mapping_torch"

# the stage timer's names before the profiler ranges came
OLD_STAGES = {
    "edges/pnp", "edges/readback", "edges/revpnp", "edges/stack",
    "edges/viso", "frame", "frontend", "kf/bow", "kf/features",
    "kf/harvest", "kf/loops", "kf/map", "kf/nearby_edges", "kf/optimize",
    "kf/segnet", "kf/store", "loops/score", "loops/verify_dispatch",
    "map/cloud", "map/cloud_sync", "map/readback", "map/update",
    "optimize/global", "store/readback", "window"}
HOST_READERS = ("frontend.host_ms_per_frame", "keyframe.host_ms_per_frame",
                "backend.host_ms_per_frame")


def _trace(counts):
    return TraceData(window_s=2.0, busy_s=0.5, n_kernels=10, kernel_s={},
                     counts=counts)


def test_sync_reader_sums_only_the_sync_stages_over_frames():
    read = registry.load_metric_readers()["sync.host_ms_per_frame"]
    counts = {"frames": 64, "windows": 2, "keyframes": 9,
              STAGE + "sync/poses": 0.032, STAGE + "sync/edges": 0.016,
              STAGE + "sync/map": 0.016, STAGE + "frontend": 0.5,
              STAGE + "window": 4.0, STAGE + "kf/map": 0.25,
              STAGE + "edges/readback": 0.125, STAGE + "mysync/x": 9.0}
    assert read(_trace(counts), None) == pytest.approx(1e3 * 0.064 / 64)


def test_sync_reader_is_silent_without_frames_or_sync_stages():
    read = registry.load_metric_readers()["sync.host_ms_per_frame"]
    assert read(_trace({"frames": 0, STAGE + "sync/poses": 0.5}),
                None) is None
    assert read(_trace({STAGE + "sync/poses": 0.5}), None) is None
    # a program without sync stages (the port before it had them)
    assert read(_trace({"frames": 64, STAGE + "window": 4.0,
                        STAGE + "frontend": 0.5}), None) is None


def _range_names():
    stage = re.compile(r'timer\.stage\(\s*"([^"]+)"')
    leaf = re.compile(r'\bspan\(\s*"([^"]+)"')
    stages, leaves = set(), set()
    for path in PROGRAM.rglob("*.py"):
        text = path.read_text()
        stages |= set(stage.findall(text))
        leaves |= set(leaf.findall(text))
    return stages, leaves


def test_new_range_names_keep_the_readers_stage_sets():
    stages, leaves = _range_names()
    assert OLD_STAGES <= stages
    new = (stages | leaves) - OLD_STAGES
    # the ranges this module's docstring is about are found
    assert {"sync/poses", "sync/edges", "sync/map", "frame/host",
            "sgbm/aggregate", "pnp/solve", "pose_graph/lm", "map/insert",
            "segnet/forward", "segnet/infer"} <= new
    assert all(n.startswith("sync/") for n in stages - OLD_STAGES)

    readers = registry.load_metric_readers()
    for name in sorted(new):
        assert not name.startswith(("kf/", "edges/", "optimize/",
                                    "slambench")), name
        assert name != "window"
        trace = TraceData(window_s=1.0, busy_s=0.5, n_kernels=0,
                          kernel_s={},
                          counts={"frames": 1, STAGE + name: 1.0})
        for reader in HOST_READERS:
            assert readers[reader](trace, None) == 0.0, (reader, name)
    # and the readers still read their own stages
    for reader, name in zip(HOST_READERS, ("window", "kf/map", "edges/pnp")):
        trace = TraceData(window_s=1.0, busy_s=0.5, n_kernels=0,
                          kernel_s={},
                          counts={"frames": 2, STAGE + name: 1.0})
        assert readers[reader](trace, None) == 500.0


@pytest.mark.card
def test_the_program_waits_for_the_card_only_in_sync_stages(card):
    """13 frames of a small synthetic street through ``process_window``
    (windows of 4 pairs) with the map and online SegNet on (the second
    window comes without labels), then
    ``finish()``, under ``torch.cuda.set_sync_debug_mode("error")`` except
    inside the program's ``sync/*`` stages: a readback or a synchronising
    host-to-device copy anywhere else raises."""
    from semantic_slam_mapping_torch.config import (
        CameraConfig, MapperConfig, OrbConfig, PoseGraphConfig, SegNetConfig,
        SgbmConfig, SlamConfig, VoConfig)
    from semantic_slam_mapping_torch.geometry.camera import Intrinsics
    from semantic_slam_mapping_torch.io import synthetic
    from semantic_slam_mapping_torch.pipeline import SlamSystem
    from semantic_slam_mapping_torch.utils.timing import StageTimer

    H, W, B, n = 96, 192, 4, 13
    cfg = SlamConfig(
        camera=CameraConfig(fx=150.0, fy=150.0, cx=W / 2, cy=H / 2,
                            baseline=0.54),
        sgbm=SgbmConfig(num_disparities=32, sad_window_size=5,
                        p1=8 * 25, p2=32 * 25, speckle_window_size=20),
        vo=VoConfig(ransac_iters=24),
        orb=OrbConfig(n_features=256, n_levels=3),
        pose_graph=PoseGraphConfig(keyframe_min_translation=0.7,
                                   keyframe_min_rotation=5.0,
                                   max_keyframes=32),
        mapper=MapperConfig(full_rebuild_every=3),
        segnet=SegNetConfig(input_height=H, input_width=W, online=True,
                            width_mult=0.25))
    gen = torch.Generator().manual_seed(11)
    world = synthetic.make_world(gen, n_boxes=14, device="cpu")
    poses = synthetic.straight_trajectory(n, speed=0.45, yaw_rate=0.01,
                                          device="cpu")
    seq = synthetic.render_sequence(Intrinsics.from_config(cfg.camera),
                                    world, poses, H, W)
    lefts, rights, labels = (seq[k].numpy()
                             for k in ("left", "right", "semantic"))
    system = SlamSystem(cfg, enable_mapping=True, device=card)

    stage, waits = StageTimer.stage, []

    @contextmanager
    def guarded(timer, name):
        if not name.startswith("sync/"):
            with stage(timer, name):
                yield
            return
        waits.append(name)
        torch.cuda.set_sync_debug_mode("default")
        try:
            with stage(timer, name):
                yield
        finally:
            torch.cuda.set_sync_debug_mode("error")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StageTimer, "stage", guarded)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for s in range(0, n - 1, B):
                # the second window's keyframes are labelled by SegNet
                system.process_window(
                    lefts[s:s + B + 1], rights[s:s + B + 1],
                    semantics=None if s == B else labels[s:s + B + 1])
            system.finish()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert len(system.keyframes) >= 3
    assert {"sync/poses", "sync/edges", "sync/map"} <= set(waits)
