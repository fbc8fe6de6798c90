"""Builds a CUDA source of the port into a shared library with ``nvcc``.

Each kernel under ``csrc/`` exposes a plain C interface and is loaded with
``ctypes``. :func:`build` compiles a source for ``sm_90a`` into
``build/torch_kernels/`` at the root of the checkout, once per hash of the
source and flags, on first use; nothing is built when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build(source: Path, verbose: bool = False) -> Path:
    """Compile ``source`` into ``lib<stem>_<hash>.so`` (once per source
    hash) and return its path. ``verbose`` adds ``-Xptxas -v`` to a fresh
    build."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(source)]
    subprocess.run(cmd, check=True, timeout=120)
    os.replace(tmp, lib)
    return lib
