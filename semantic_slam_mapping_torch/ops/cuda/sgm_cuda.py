"""SGM path aggregation over four directions: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/sgm_aggregate.cu``) replaces the TPU kernel
``ops/pallas/sgm_pallas.py::sgm_bidir_pallas`` of the JAX package; its
source note gives the design and the bound. It is compiled on first use by
``ops/cuda/nvcc.build`` and loaded with ``ctypes``. Nothing is built when
this module is imported.

:func:`sgm_aggregate4` returns, in the volume's dtype, the Pallas kernel's
contract ``r(r(vf) + r(vb)) + r(r(hf) + r(hb))``: each directional path
(carried in float32) rounded to the volume's dtype, and each sum taken in
float32 and rounded again. It takes one (H, W, D) volume or a batch
(B, H, W, D) of them; the frames' lines are independent, so a batch gives
what each frame gives alone, to the bit. For a CUDA tensor it launches the
kernel twice whatever B is (the vertical pairs of every frame into a
scratch sum, then the horizontal pairs added to it) and counts each launch
in ``sgm_aggregate4.launches``. For a CPU tensor it runs
:func:`sgm_aggregate4_plain`, the same recurrence as a loop over the scan
axis; it never falls back to it for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F

from semantic_slam_mapping_torch.ops.cuda import nvcc

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "sgm_aggregate.cu"
MAX_DISPARITIES = 96


def build(verbose: bool = False) -> Path:
    """Compile the kernel into a shared library (once per source hash) and
    return its path. ``verbose`` adds ``-Xptxas -v`` to a fresh build."""
    return nvcc.build(SOURCE, verbose)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.sgm_aggregate_pass
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plan = lib.sgm_aggregate_plan
    plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_int
    return lib


def sgm_pass(vol: torch.Tensor, dest: torch.Tensor, D: int, p1: float,
             p2: float, horizontal: bool,
             addend: torch.Tensor | None = None) -> None:
    """One launch of the kernel on the current stream: the vertical
    (``horizontal=False``) or horizontal pairs of directions of a padded
    (H, W, Dp) volume or (B, H, W, Dp) batch into ``dest``, ``r(f + b)``
    or, with ``addend``, ``r(addend + r(f + b))``. Counts the launch in
    ``sgm_aggregate4.launches``."""
    B, H, W, Dp = (1,) * (4 - vol.dim()) + tuple(vol.shape)
    with torch.cuda.device(vol.device):
        err = _library().sgm_aggregate_pass(
            vol.data_ptr(), None if addend is None else addend.data_ptr(),
            dest.data_ptr(), B, H, W, D, Dp, float(p1), float(p2),
            int(vol.dtype == torch.bfloat16), int(horizontal),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sgm_aggregate_pass launch failed: cudaError {err}")
    sgm_aggregate4.launches += 1


def launch_plan(shape: Tuple[int, ...], dtype: torch.dtype,
                horizontal: bool) -> dict:
    """What a launch on a (B, H, W, Dp) or (H, W, Dp) padded volume on the
    current card uses: its blocks, the blocks an SM holds at once, the
    ring depth in stages and the shared memory of a block. Launches
    nothing."""
    B, H, W, Dp = (1,) * (4 - len(shape)) + tuple(shape)
    out = (ctypes.c_int * 4)()
    err = _library().sgm_aggregate_plan(
        B, H, W, Dp, int(dtype == torch.bfloat16), int(horizontal),
        torch.cuda.current_device(), out)
    if err != 0:
        raise RuntimeError(f"sgm_aggregate_plan failed: cudaError {err}")
    return dict(zip(("blocks", "blocks_per_sm", "stages", "smem_bytes"),
                    out))


def _padded(vol: torch.Tensor) -> torch.Tensor:
    """The volume with its pixel stride padded with +inf to whole 16-byte
    vectors and its storage 16-byte aligned, as the kernel reads it
    (``vol`` itself when it already is)."""
    vec = 16 // vol.element_size()
    pad = -vol.shape[-1] % vec
    if pad or vol.data_ptr() % 16:
        return F.pad(vol, (0, pad), value=float("inf"))
    return vol


def sgm_aggregate4(vol: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """The four-direction SGM aggregate of an (H, W, D) cost volume or a
    (B, H, W, D) batch of them (non-negative costs), as a tensor of the
    volume's shape and dtype."""
    if vol.device.type == "cpu":
        return sgm_aggregate4_plain(vol, p1, p2)
    if vol.device.type != "cuda":
        raise ValueError(f"sgm_aggregate4: unsupported device {vol.device}")
    if (vol.dim() not in (3, 4)
            or vol.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError("sgm_aggregate4 takes an (H, W, D) or (B, H, W, D) "
                         "float32 or bfloat16 volume, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    if not vol.is_contiguous():
        raise ValueError("sgm_aggregate4 takes a contiguous volume")
    D = vol.shape[-1]
    if not 1 <= D <= MAX_DISPARITIES:
        raise ValueError(f"sgm_aggregate4 takes 1..{MAX_DISPARITIES} "
                         f"disparities, got {D}")
    src = _padded(vol)
    vsum = torch.empty_like(src)
    out = torch.empty_like(src)
    sgm_pass(src, vsum, D, p1, p2, horizontal=False)
    sgm_pass(src, out, D, p1, p2, horizontal=True, addend=vsum)
    return out if src.shape[-1] == D else out[..., :D].contiguous()


sgm_aggregate4.launches = 0


def _sgm_paths(cost: torch.Tensor, p1: float,
               p2: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and backward path costs along axis 0 of an (S, ..., X, D)
    float32 volume (the recurrence of ``sgbm._sgm_scan_bidir``, with the
    two directions stacked in one carry)."""
    both = torch.stack([cost, cost.flip(0)], dim=1)          # (S, 2, X, D)
    paths = torch.empty_like(both)
    carry = both[0]
    paths[0] = carry
    inf = torch.full_like(carry[..., :1], float("inf"))
    for s in range(1, both.shape[0]):
        prev_min = carry.amin(dim=-1, keepdim=True)
        up = torch.cat([inf, carry[..., :-1]], dim=-1)       # L'(d - 1)
        dn = torch.cat([carry[..., 1:], inf], dim=-1)        # L'(d + 1)
        best = torch.minimum(torch.minimum(carry, prev_min + p2),
                             torch.minimum(up + p1, dn + p1))
        carry = both[s] + best - prev_min
        paths[s] = carry
    return paths[:, 0], paths.flip(0)[:, 1]


def sgm_aggregate4_plain(vol: torch.Tensor, p1: float,
                         p2: float) -> torch.Tensor:
    """The plain PyTorch version of :func:`sgm_aggregate4`: the exact
    recurrence in float32 down the columns and along the rows of each
    (H, W, D) frame, each path rounded to the volume's dtype and summed in
    it in the contract's order."""
    v = vol.float()
    vf, vb = _sgm_paths(v.movedim(-3, 0), p1, p2)
    hf, hb = _sgm_paths(v.movedim(-2, 0), p1, p2)
    dt = vol.dtype
    vert = (vf.to(dt) + vb.to(dt)).movedim(0, -3)
    horz = (hf.to(dt) + hb.to(dt)).movedim(0, -2)
    return (vert + horz).contiguous()
