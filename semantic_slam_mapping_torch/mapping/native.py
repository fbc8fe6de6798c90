"""ctypes binding of the C++ voxel map (``native/voxel_map.cpp``).

The port's own binding over the shared source: it is compiled with
``g++ -O3 -std=c++17 -shared -fPIC`` into ``build/torch_kernels/`` at the
root of the checkout on first use (keyed by a hash of the source and the
flags), never when this module is imported. A failed build raises: the
port does not fall back to the numpy :class:`mapping.mapper.GlobalMap`,
which stays as the plain twin that the tests hold this map to. The C++ map
keeps float32 running means and u16 per-class counts; GlobalMap sums in
float64.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from semantic_slam_mapping_torch.mapping.mapper import _np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "voxel_map.cpp"
BUILD_DIR = _ROOT / "build" / "torch_kernels"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def build() -> Path:
    """Compile the voxel map into a shared library (once per source hash)
    and return its path; raises with the compiler's output on failure."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libvoxel_map_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.voxel_map_create.restype = ctypes.c_void_p
    lib.voxel_map_create.argtypes = [ctypes.c_float]
    lib.voxel_map_destroy.restype = None
    lib.voxel_map_destroy.argtypes = [ctypes.c_void_p]
    lib.voxel_map_clear.restype = None
    lib.voxel_map_clear.argtypes = [ctypes.c_void_p]
    lib.voxel_map_insert.restype = None
    lib.voxel_map_insert.argtypes = [ctypes.c_void_p, _F32P, _F32P, _I32P,
                                     _U8P, ctypes.c_int64]
    lib.voxel_map_size.restype = ctypes.c_int64
    lib.voxel_map_size.argtypes = [ctypes.c_void_p]
    lib.voxel_map_extract.restype = ctypes.c_int64
    lib.voxel_map_extract.argtypes = [ctypes.c_void_p, _F32P, _F32P, _I32P,
                                      ctypes.c_int64]
    lib.voxel_map_save_pcd.restype = ctypes.c_int
    lib.voxel_map_save_pcd.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
    return lib


def _ptr(a: Optional[np.ndarray], kind):
    return None if a is None else a.ctypes.data_as(kind)


class NativeVoxelMap:
    """The global voxel map in C++, with GlobalMap's API (insert,
    insert_cloud, clear, as_arrays, save_pcd, len)."""

    def __init__(self, resolution: float):
        self._lib = _library()
        self._h = self._lib.voxel_map_create(ctypes.c_float(resolution))
        self.resolution = resolution
        self.updates = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.voxel_map_destroy(self._h)
            self._h = None

    def insert(self, xyz: np.ndarray, rgb: np.ndarray,
               label: Optional[np.ndarray] = None,
               valid: Optional[np.ndarray] = None):
        xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
        rgb = np.ascontiguousarray(rgb, np.float32).reshape(-1, 3)
        n = len(xyz)
        lbl = None if label is None else np.ascontiguousarray(label,
                                                              np.int32)
        val = None if valid is None else np.ascontiguousarray(valid,
                                                              np.uint8)
        if len(rgb) != n or any(a is not None and a.shape != (n,)
                                for a in (lbl, val)):
            raise ValueError("xyz, rgb, label and valid must have one row "
                             "per point")
        self._lib.voxel_map_insert(self._h, _ptr(xyz, _F32P),
                                   _ptr(rgb, _F32P), _ptr(lbl, _I32P),
                                   _ptr(val, _U8P), n)
        self.updates += 1

    def insert_cloud(self, cloud):
        """Insert a mapping.mapper.FrameCloud."""
        self.insert(_np(cloud.xyz), _np(cloud.rgb), _np(cloud.label),
                    _np(cloud.valid))

    def clear(self):
        self._lib.voxel_map_clear(self._h)

    def __len__(self) -> int:
        return int(self._lib.voxel_map_size(self._h))

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(xyz mean, rgb mean, majority label) per voxel, in the hash
        map's order."""
        n = len(self)
        xyz = np.empty((n, 3), np.float32)
        rgb = np.empty((n, 3), np.float32)
        lbl = np.empty(n, np.int32)
        got = self._lib.voxel_map_extract(self._h, _ptr(xyz, _F32P),
                                          _ptr(rgb, _F32P), _ptr(lbl, _I32P),
                                          n)
        return xyz[:got], rgb[:got], lbl[:got]

    def save_pcd(self, path: str, binary: bool = True) -> None:
        if self._lib.voxel_map_save_pcd(self._h, str(path).encode(),
                                        1 if binary else 0) != 0:
            raise OSError(f"failed to write {path}")
