"""Semi-global block matching disparity.

Counterpart of ``semantic_slam_mapping_tpu/ops/sgbm.py::compute``: an
x-Sobel prefilter and intensity cost over D shifts, box-aggregated over
the SAD window; SGM path aggregation over the four axis-aligned directions
(the CUDA kernel of ``ops/cuda/sgm_cuda.py`` on the card, its plain version
on the CPU); winner-take-all with a parabola subpixel step and the
uniqueness ratio; the left-right check from the same aggregate; and the
speckle filter by connected components. Output convention as OpenCV's:
disparity in pixels, INVALID (-1) where rejected.

The aggregate is in the volume's dtype (``cost_dtype``, bfloat16 by
default), rounded per direction as the TPU path's Pallas kernel rounds it,
so the two agree bit for bit in either dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from semantic_slam_mapping_torch.config import SgbmConfig
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.ops.components import connected_components
from semantic_slam_mapping_torch.ops.cuda.sgm_cuda import sgm_aggregate4

INVALID = -1.0

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class SgbmResult(NamedTuple):
    disparity: torch.Tensor  # (H, W) float32, subpixel, INVALID where bad
    valid: torch.Tensor      # (H, W) bool


def _prefilter(img: torch.Tensor, cap: float) -> torch.Tensor:
    """x-Sobel prefilter of the 255-scaled image, clipped to [-cap, cap]
    and shifted to [0, 2 cap]."""
    ix, _ = im.gradients(img * 255.0, smooth=True)
    return torch.clamp(ix, -cap, cap) + cap


def _cost_volume(left: torch.Tensor, right: torch.Tensor,
                 cfg: SgbmConfig) -> torch.Tensor:
    """(H, W, D) matching cost in ``cfg.cost_dtype``, box-aggregated over
    the SAD window: |lp - rp(x-d)| + 0.25 |li - ri(x-d)|, and 2 cap where
    x - d leaves the image."""
    dt = _DTYPES[cfg.cost_dtype]
    cap = cfg.pre_filter_cap
    lp = _prefilter(left, cap).to(dt)
    rp = _prefilter(right, cap).to(dt)
    li = (left * 255.0).to(dt)
    ri = (right * 255.0).to(dt)
    H, W = left.shape
    D, d0 = cfg.num_disparities, cfg.min_disparity
    dev = left.device
    # window j of the left-padded image is rp[:, x + j - D]; shift d reads
    # window D - d0 - d (clamped into range, as lax.dynamic_slice does)
    starts = torch.clamp(D - d0 - torch.arange(D, device=dev), 0, D)
    rs = F.pad(rp, (D, 0)).unfold(1, W, 1)[:, starts].transpose(0, 1)
    ris = F.pad(ri, (D, 0)).unfold(1, W, 1)[:, starts].transpose(0, 1)
    vol = torch.abs(lp - rs) + 0.25 * torch.abs(li - ris)       # (D, H, W)
    border = (torch.arange(W, device=dev)[None, None, :]
              < (torch.arange(D, device=dev) + d0)[:, None, None])
    vol = torch.where(border, torch.full_like(vol, 2.0 * cap), vol)
    vol = im.box_blur(vol, cfg.sad_window_size)
    return vol.permute(1, 2, 0).contiguous()


def _aggregate(vol: torch.Tensor, cfg: SgbmConfig) -> torch.Tensor:
    """Sum of the four axis-aligned directional path costs, in the volume's
    dtype: ``(r(vf) + r(vb)) + (r(hf) + r(hb))``, each path and each sum
    rounded to it (see ``sgm_cuda.sgm_aggregate4``)."""
    n = 8 if cfg.full_dp else cfg.num_directions
    if n == 8:
        raise NotImplementedError(
            "8-direction SGM (full_dp) is not ported yet")
    if n != 4:
        raise ValueError(f"num_directions must be 4 or 8, got {n}")
    # OpenCV's P1/P2 are in units of the window-summed cost; ours is
    # window-averaged, hence the rescale (as in the JAX package)
    return sgm_aggregate4(vol, float(cfg.p1) / 16.0, float(cfg.p2) / 16.0)


def _wta_subpixel(agg: torch.Tensor, cfg: SgbmConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-take-all + parabola subpixel + uniqueness gate."""
    D = agg.shape[-1]
    best = torch.argmin(agg, dim=-1)
    cmin = agg.amin(dim=-1).float()
    ds = torch.arange(D, device=agg.device)
    far = torch.abs(ds - best[..., None]) > 1
    big = torch.finfo(agg.dtype).max
    second = torch.where(far, agg, big).amin(dim=-1).float()
    unique_ok = second * (100 - cfg.uniqueness_ratio) >= cmin * 100

    def take(i):
        return torch.gather(agg, -1, i[..., None])[..., 0].float()

    cl = take(torch.clamp(best - 1, 0, D - 1))
    cr = take(torch.clamp(best + 1, 0, D - 1))
    denom = cl + cr - 2.0 * cmin
    delta = torch.where(torch.abs(denom) > 1e-9,
                        0.5 * (cl - cr) / torch.clamp(denom, min=1e-9),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    interior = (best > 0) & (best < D - 1)
    disp = best.float() + torch.where(interior, delta, 0.0) \
        + cfg.min_disparity
    return disp, unique_ok


def _lr_check(agg: torch.Tensor, disp_left: torch.Tensor,
              cfg: SgbmConfig) -> torch.Tensor:
    """Left-right consistency from the same aggregate: the right image's
    disparity at x is argmin_d agg(x + d, d)."""
    H, W, D = agg.shape
    dev = agg.device
    xd = (torch.arange(W, device=dev)[:, None]
          + torch.arange(D, device=dev)[None, :])                # (W, D)
    right_cost = torch.gather(
        agg, 1, torch.clamp(xd, max=W - 1).expand(H, W, D))
    right_cost = torch.where((xd < W).expand(H, W, D), right_cost,
                             float("inf"))
    d_right = torch.argmin(right_cost, dim=-1).float()          # (H, W)
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    xl = torch.clamp((xs - disp_left).long(), 0, W - 1)
    d_r_at = torch.gather(d_right, 1, xl)
    return torch.abs(disp_left - d_r_at) <= cfg.disp12_max_diff + 0.5


def _speckle_filter(disp: torch.Tensor, valid: torch.Tensor,
                    cfg: SgbmConfig) -> torch.Tensor:
    """Invalidate components (neighbours within speckle_range / 16 px of
    disparity) smaller than speckle_window_size pixels."""
    rng = cfg.speckle_range / 16.0

    def conn(dim, sh):
        nd = torch.roll(disp, sh, dim)
        nv = torch.roll(valid, sh, dim)
        return nv & (torch.abs(disp - nd) <= rng)

    same = (conn(0, 1), conn(0, -1), conn(1, 1), conn(1, -1))
    lbl = connected_components(valid, same, sweeps=cfg.speckle_cc_sweeps,
                               jumps=cfg.speckle_cc_jumps).reshape(-1)
    sizes = torch.zeros(lbl.numel(), dtype=torch.int32, device=disp.device)
    sizes.index_add_(0, lbl, valid.reshape(-1).int())
    comp_size = sizes[lbl].reshape(disp.shape)
    return valid & (comp_size >= cfg.speckle_window_size)


def compute(left: torch.Tensor, right: torch.Tensor,
            cfg: SgbmConfig = SgbmConfig()) -> SgbmResult:
    """Full SGBM disparity for a rectified pair of (H, W) images in [0, 1]."""
    vol = _cost_volume(left, right, cfg)
    agg = _aggregate(vol, cfg)
    disp, unique_ok = _wta_subpixel(agg, cfg)
    lr_ok = _lr_check(agg, disp, cfg)
    valid = unique_ok & lr_ok & (disp > cfg.min_disparity)
    valid = _speckle_filter(disp, valid, cfg)
    return SgbmResult(disparity=torch.where(valid, disp, INVALID),
                      valid=valid)
