"""chip_smoke.py fails, and prints no result, without a CUDA card and
when it stands alone without the package."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _run_chip_smoke(cwd):
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    res = _run_chip_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "needs a CUDA device" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_chip_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
