"""Semi-global block matching disparity.

Counterpart of ``semantic_slam_mapping_tpu/ops/sgbm.py::compute``: an
x-Sobel prefilter and intensity cost over D shifts, box-aggregated over
the SAD window; SGM path aggregation over the four axis-aligned directions
(the CUDA kernel of ``ops/cuda/sgm_cuda.py`` on the card, its plain version
on the CPU), plus the four diagonal ones with ``full_dp``; winner-take-all
with a parabola subpixel step and the uniqueness ratio; the left-right
check from the same aggregate; and the speckle filter by connected
components. Output convention as OpenCV's:
disparity in pixels, INVALID (-1) where rejected. Every function takes a
pair of (H, W) images or a batch (B, H, W) of pairs, and a batch gives
what each pair gives alone, to the bit.

The aggregate is in the volume's dtype (``cost_dtype``, bfloat16 by
default), rounded per direction as the TPU path's Pallas kernel rounds it,
so the two agree bit for bit in either dtype. The port always runs the
exact recurrence of that path; the JAX package's blocked-halo scan
(``scan_block``), an approximation for hosts without the Pallas kernel,
is not ported, and ``scan_block`` is ignored.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from semantic_slam_mapping_torch.config import SgbmConfig
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.ops.components import connected_components
from semantic_slam_mapping_torch.ops.cuda.sgm_cuda import sgm_aggregate4
from semantic_slam_mapping_torch.utils.timing import span

INVALID = -1.0

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class SgbmResult(NamedTuple):
    disparity: torch.Tensor  # (..., H, W) float32, subpixel, INVALID if bad
    valid: torch.Tensor      # (..., H, W) bool


def _prefilter(img: torch.Tensor, cap: float) -> torch.Tensor:
    """x-Sobel prefilter of the 255-scaled image, clipped to [-cap, cap]
    and shifted to [0, 2 cap]."""
    ix, _ = im.gradients(img * 255.0, smooth=True)
    return torch.clamp(ix, -cap, cap) + cap


def _cost_volume(left: torch.Tensor, right: torch.Tensor,
                 cfg: SgbmConfig) -> torch.Tensor:
    """(..., H, W, D) matching cost in ``cfg.cost_dtype``, box-aggregated
    over the SAD window: |lp - rp(x-d)| + 0.25 |li - ri(x-d)|, and 2 cap
    where x - d leaves the image."""
    dt = _DTYPES[cfg.cost_dtype]
    cap = cfg.pre_filter_cap
    lp = _prefilter(left, cap).to(dt)
    rp = _prefilter(right, cap).to(dt)
    li = (left * 255.0).to(dt)
    ri = (right * 255.0).to(dt)
    W = left.shape[-1]
    D, d0 = cfg.num_disparities, cfg.min_disparity
    dev = left.device
    # window j of the left-padded image is rp[..., x + j - D]; shift d
    # reads window D - d0 - d (clamped into range, as lax.dynamic_slice
    # does)
    starts = torch.clamp(D - d0 - torch.arange(D, device=dev), 0, D)

    def shifted(img):                                       # (..., D, H, W)
        return F.pad(img, (D, 0)).unfold(-1, W, 1)[..., starts, :] \
            .transpose(-3, -2)

    vol = (torch.abs(lp[..., None, :, :] - shifted(rp))
           + 0.25 * torch.abs(li[..., None, :, :] - shifted(ri)))
    border = (torch.arange(W, device=dev)[None, None, :]
              < (torch.arange(D, device=dev) + d0)[:, None, None])
    vol = torch.where(border, torch.full_like(vol, 2.0 * cap), vol)
    vol = im.box_blur(vol, cfg.sad_window_size)
    return vol.movedim(-3, -1).contiguous()


def _sgm_step(carry: torch.Tensor, c: torch.Tensor, p1: float, p2: float,
              shift: int = 0) -> torch.Tensor:
    """One SGM step on a (..., X, D) carry in its own dtype, every op
    rounded to it (``sgbm._sgm_step`` of the JAX package). ``shift`` = +1
    / -1 moves the carry one pixel along X first, which turns the path
    into a diagonal one; the pixel entering at the edge gets a zero carry
    (a fresh start)."""
    if shift:
        z = torch.zeros_like(carry[..., :1, :])
        carry = (torch.cat([z, carry[..., :-1, :]], dim=-2) if shift > 0
                 else torch.cat([carry[..., 1:, :], z], dim=-2))
    big = torch.full((), 1e9, dtype=carry.dtype, device=carry.device)
    prev_min = carry.amin(dim=-1, keepdim=True)
    up = torch.cat([carry[..., :1] + big, carry[..., :-1]], dim=-1)
    dn = torch.cat([carry[..., 1:], carry[..., -1:] + big], dim=-1)
    best = torch.minimum(torch.minimum(carry, prev_min + p2),
                         torch.minimum(up + p1, dn + p1))
    return c + best - prev_min


def _diag_paths_full(vol: torch.Tensor, p1: float,
                     p2: float) -> torch.Tensor:
    """The sum of the four diagonal path costs of (..., S, W, D) volumes,
    in the volume's dtype: one walk down the rows and one up them, each
    with a carry shifted by +1 and by -1 along W, summed as
    ``(pp_down + pp_up) + (pm_down + pm_up)`` (``sgbm._diag_paths_full``
    of the JAX package, to the bit)."""
    v = vol.movedim(-3, 0)                                   # (S, ..., W, D)
    both = torch.stack([v, v.flip(0)], dim=1)             # (S, 2, ..., W, D)
    pp = torch.empty_like(both)
    pm = torch.empty_like(both)
    pp[0] = pm[0] = both[0]
    for s in range(1, both.shape[0]):
        pp[s] = _sgm_step(pp[s - 1], both[s], p1, p2, shift=1)
        pm[s] = _sgm_step(pm[s - 1], both[s], p1, p2, shift=-1)
    out = ((pp[:, 0] + pp.flip(0)[:, 1]) + (pm[:, 0] + pm.flip(0)[:, 1]))
    return out.movedim(0, -3)


def _aggregate(vol: torch.Tensor, cfg: SgbmConfig) -> torch.Tensor:
    """Sum of the directional path costs of (..., H, W, D) volumes, in the
    volume's dtype: ``(r(vf) + r(vb)) + (r(hf) + r(hb))``, each path and
    each sum rounded to it (see ``sgm_cuda.sgm_aggregate4``); with
    ``full_dp`` the four diagonal paths of :func:`_diag_paths_full` are
    added to that, as the TPU path of the JAX package adds them."""
    n = 8 if cfg.full_dp else cfg.num_directions
    if n not in (4, 8):
        raise ValueError(f"num_directions must be 4 or 8, got {n}")
    # OpenCV's P1/P2 are in units of the window-summed cost; ours is
    # window-averaged, hence the rescale (as in the JAX package)
    p1, p2 = float(cfg.p1) / 16.0, float(cfg.p2) / 16.0
    agg = sgm_aggregate4(vol, p1, p2)
    if n == 8:
        agg = agg + _diag_paths_full(vol, p1, p2)
    return agg


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
    W, D = agg.shape[-2:]
    dev = agg.device
    xd = (torch.arange(W, device=dev)[:, None]
          + torch.arange(D, device=dev)[None, :])                # (W, D)
    right_cost = torch.gather(
        agg, -2, torch.clamp(xd, max=W - 1).expand(agg.shape))
    right_cost = torch.where(xd < W, right_cost, float("inf"))
    d_right = torch.argmin(right_cost, dim=-1).float()      # (..., H, W)
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    xl = torch.clamp((xs - disp_left).long(), 0, W - 1)
    d_r_at = torch.gather(d_right, -1, xl)
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

    same = (conn(-2, 1), conn(-2, -1), conn(-1, 1), conn(-1, -1))
    lbl = connected_components(valid, same, sweeps=cfg.speckle_cc_sweeps,
                               jumps=cfg.speckle_cc_jumps)
    # labels are flat indices of their own frame: count each frame apart
    lbl = lbl.reshape(lbl.shape[:-2] + (-1,))
    sizes = torch.zeros_like(lbl, dtype=torch.int32).scatter_add_(
        -1, lbl, valid.reshape(lbl.shape).int())
    comp_size = torch.gather(sizes, -1, lbl).reshape(disp.shape)
    return valid & (comp_size >= cfg.speckle_window_size)


def compute(left: torch.Tensor, right: torch.Tensor,
            cfg: SgbmConfig = SgbmConfig()) -> SgbmResult:
    """Full SGBM disparity for a rectified pair of (H, W) images in [0, 1],
    or for a batch (B, H, W) of pairs."""
    with span("sgbm/cost_volume"):
        vol = _cost_volume(left, right, cfg)
    with span("sgbm/aggregate"):
        agg = _aggregate(vol, cfg)
    with span("sgbm/select"):
        disp, unique_ok = _wta_subpixel(agg, cfg)
        lr_ok = _lr_check(agg, disp, cfg)
        valid = unique_ok & lr_ok & (disp > cfg.min_disparity)
        valid = _speckle_filter(disp, valid, cfg)
        return SgbmResult(disparity=torch.where(valid, disp, INVALID),
                          valid=valid)
