"""The port and chip_smoke.py import neither JAX nor the JAX package
(checked in a fresh interpreter, since this test process has JAX loaded);
the walk reaches every module of the port, the map, SegNet and the
checkpoint among them."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import semantic_slam_mapping_torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import semantic_slam_mapping_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "semantic_slam_mapping_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    names = {m.name for m in pkgutil.walk_packages(
        semantic_slam_mapping_torch.__path__,
        semantic_slam_mapping_torch.__name__ + ".")}
    assert {f"semantic_slam_mapping_torch.{m}" for m in (
        "mapping.mapper", "mapping.native", "mapping.semantics",
        "models.segnet", "utils.checkpoint")} <= names
    expected = len(names)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [str(expected), "[]"], res.stdout
    assert expected >= 20


CHIP_PROBE = """
import sys
import chip_smoke
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "semantic_slam_mapping_tpu")))
"""


def test_chip_smoke_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", CHIP_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout

