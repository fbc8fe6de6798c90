"""The port's log lines against the JAX package's.

Each package runs in a subprocess of its own (both configure the one
``ssm`` logger of a process), and their stderr lines are compared with
the ``HH:MM:SS`` time stripped.

Test 1: ``utils.logging.get_logger`` of each package: the same lines for
an INFO and a WARNING record of two loggers (names, level letters,
messages), no DEBUG line, one handler on ``ssm`` after a second
``get_logger``; with ``SSM_LOG_LEVEL=WARNING`` both print only the
warning.

Test 2: the cheapest scene that makes ``ssm.pipeline`` lines in both
packages: ``SlamSystem(enable_mapping=True)`` with online SegNet weights
from a pickle (the constructor's ``segnet weights`` line) on the two
96x192 frames of ``tests/torch_parity_scene.py`` with their colors and
the renderer's labels, then ``finish()`` (the first keyframe's ``map``
line). SGBM runs its exact float32 recurrence in both (``scan_block=0``,
``cost_dtype="float32"``), so the two maps hold the same voxels. The
port's ``ssm.`` lines equal JAX's.
"""

import dataclasses
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_torch.config import SegNetConfig
from semantic_slam_mapping_torch.models import segnet as tseg

from tests import torch_parity_scene as scene

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("semantic_slam_mapping_tpu", "semantic_slam_mapping_torch")
_TIME = re.compile(r"^\d\d:\d\d:\d\d ", re.M)

LOGGERS = """
import logging
from {pkg}.utils.logging import get_logger
log = get_logger("pipeline")
other = get_logger("mapper")
log.info("%d loop edge(s) -> kf %d", 2, 9)
other.warning("edge budget exhausted; dropping edge")
log.debug("not shown")
print(len(logging.getLogger("ssm").handlers))
"""

SCENE = """
import dataclasses, pickle, sys
import numpy as np
with open(sys.argv[1], "rb") as f:
    cfg_dict = pickle.load(f)
frames = np.load(sys.argv[2])
if "{pkg}" == "semantic_slam_mapping_tpu":
    import jax
    jax.config.update("jax_default_matmul_precision", "float32")
    from semantic_slam_mapping_tpu import config
    from semantic_slam_mapping_tpu.pipeline import SlamSystem
    sections = {{f.name: f.default_factory().__class__(**cfg_dict[f.name])
                for f in dataclasses.fields(config.SlamConfig)
                if f.name in cfg_dict}}
    system = SlamSystem(config.SlamConfig(**sections), enable_mapping=True)
else:
    from semantic_slam_mapping_torch.pipeline import SlamSystem
    from semantic_slam_mapping_torch.utils import convert
    system = SlamSystem(convert.config_from_dict(cfg_dict),
                        enable_mapping=True, device="cpu")
for i in range(2):
    system.process_frame(frames["left"][i], frames["right"][i],
                         frames["color"][i], frames["semantic"][i])
system.finish()
"""


def _run(code: str, pkg: str, args=(), env=None) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", code.format(pkg=pkg), *args], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", **(env or {})})


def _results(procs) -> list:
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        lines = [line for line in _TIME.sub("", stderr).splitlines()
                 if line.startswith("ssm.")]
        out.append((stdout, lines))
    return out


def test_get_logger_lines_match_jax():
    warning = "ssm.mapper W: edge budget exhausted; dropping edge"
    for level, expected in (
            ("INFO", ["ssm.pipeline I: 2 loop edge(s) -> kf 9", warning]),
            ("WARNING", [warning])):
        (jout, jlines), (tout, tlines) = _results(
            [_run(LOGGERS, pkg, env={"SSM_LOG_LEVEL": level})
             for pkg in PACKAGES])
        assert jlines == tlines == expected
        assert jout.strip() == tout.strip() == "1"


def test_slam_system_pipeline_lines_match_jax(tmp_path):
    weights = tmp_path / "segnet.pkl"
    seg_cfg = SegNetConfig(width_mult=0.125, dtype="float32")
    model = tseg.create(seg_cfg, torch.Generator().manual_seed(0))
    tseg.save_checkpoint(weights, seg_cfg, model, meta={"miou": 0.25})
    cfg = jcfg.SlamConfig(
        camera=scene.JCAM, quadmatch=scene.QCFG,
        sgbm=jcfg.SgbmConfig(scan_block=0, cost_dtype="float32"),
        segnet=jcfg.SegNetConfig(online=True, weights=str(weights),
                                 width_mult=0.125, dtype="float32"))
    frames = scene.street_frames()
    data = tmp_path / "frames.npz"
    np.savez(data, left=frames["left"], right=frames["right"],
             color=np.stack([frames["left"]] * 3, -1),
             semantic=frames["semantic"].astype(np.int32))
    cfg_file = tmp_path / "config.pkl"
    cfg_file.write_bytes(pickle.dumps(dataclasses.asdict(cfg)))
    (_, jlines), (_, tlines) = _results(
        [_run(SCENE, pkg, (str(cfg_file), str(data)),
              env={"SSM_LOG_LEVEL": "INFO"}) for pkg in PACKAGES])
    assert jlines[0] == (f"ssm.pipeline I: segnet weights {weights} "
                         "(mIoU 0.250)")
    assert any(line.startswith("ssm.pipeline I: map: ") for line in jlines)
    assert tlines == jlines
