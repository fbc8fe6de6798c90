"""Plain SGBM disparity: the reference that the program's disparity is held
to, and its lower-precision control.

A frozen copy of the arithmetic of the port's ``ops/sgbm.compute`` with the
four-path SGM aggregation as a plain loop over the scan axis (the
recurrence that the CUDA kernel K1 implements), the speckle filter's
connected components with the same fixed schedule, and OpenCV's
conventions: disparity in pixels, -1 where rejected. ``precision`` names
the type the cost volume and every SGM step are rounded to: ``float32``
for the reference, ``float8_e5m2`` for the control (the type below the
configuration's bfloat16 whose range holds a summed path cost).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

INVALID = -1.0
_SCHARR_D = np.array([-1.0, 0.0, 1.0], np.float32) * 0.5
_SOBEL_S = np.array([1.0, 2.0, 1.0], np.float32) / 4.0


def _sep_filter(img: torch.Tensor, kx: np.ndarray,
                ky: np.ndarray) -> torch.Tensor:
    """Separable filter of (..., H, W) with reflect padding, the taps
    summed in order in float32."""
    shape = img.shape[:-2]
    H, W = img.shape[-2:]
    x = img.reshape((-1, 1, H, W)).float()
    ry, rx = len(ky) // 2, len(kx) // 2
    xp = F.pad(x, (0, 0, ry, ry), mode="reflect")
    acc = float(ky[0]) * xp[:, :, 0:H, :]
    for k in range(1, len(ky)):
        acc = acc + float(ky[k]) * xp[:, :, k:k + H, :]
    xp = F.pad(acc, (rx, rx, 0, 0), mode="reflect")
    out = float(kx[0]) * xp[:, :, :, 0:W]
    for k in range(1, len(kx)):
        out = out + float(kx[k]) * xp[:, :, :, k:k + W]
    return out.reshape(shape + (H, W))


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).float()


def cost_volume(left, right, p, dtype) -> torch.Tensor:
    """(H, W, D) cost: |lp - rp(x-d)| + 0.25 |li - ri(x-d)| of the x-Sobel
    prefiltered (clipped to the cap) and raw 255-scaled images, 2 cap where
    x - d leaves the image, box-averaged over the SAD window."""
    cap = float(p["pre_filter_cap"])
    D, d0, win = p["num_disparities"], p["min_disparity"], p["sad_window_size"]

    def pre(img):
        ix = _sep_filter(img * 255.0, _SCHARR_D, _SOBEL_S)
        return _round(torch.clamp(ix, -cap, cap) + cap, dtype)

    lp, rp = pre(left), pre(right)
    li, ri = _round(left * 255.0, dtype), _round(right * 255.0, dtype)
    H, W = left.shape
    vol = torch.empty((D, H, W), dtype=torch.float32, device=left.device)
    for d in range(D):
        s = d + d0
        c = torch.full((H, W), 2.0 * cap, device=left.device)
        if s < W:
            c[:, s:] = (torch.abs(lp[:, s:] - rp[:, :W - s])
                        + 0.25 * torch.abs(li[:, s:] - ri[:, :W - s]))
        vol[d] = _round(c, dtype)
    k = np.full((win,), 1.0 / win, np.float32)
    vol = _round(_sep_filter(vol, k, k), dtype)
    return vol.permute(1, 2, 0).contiguous()


def _paths(cost: torch.Tensor, p1: float, p2: float, dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and backward SGM path costs along axis 0 of (S, X, D)."""
    both = torch.stack([cost, cost.flip(0)], dim=1)
    out = torch.empty_like(both)
    carry = both[0]
    out[0] = carry
    inf = torch.full_like(carry[..., :1], float("inf"))
    for s in range(1, both.shape[0]):
        prev_min = carry.amin(dim=-1, keepdim=True)
        up = torch.cat([inf, carry[..., :-1]], dim=-1)
        dn = torch.cat([carry[..., 1:], inf], dim=-1)
        best = torch.minimum(torch.minimum(carry, prev_min + p2),
                             torch.minimum(up + p1, dn + p1))
        carry = _round(both[s] + best - prev_min, dtype)
        out[s] = carry
    return out[:, 0], out.flip(0)[:, 1]


def aggregate(vol: torch.Tensor, p1: float, p2: float, dtype) -> torch.Tensor:
    """Sum of the four axis-aligned path costs of an (H, W, D) volume."""
    vf, vb = _paths(vol, p1, p2, dtype)
    hf, hb = _paths(vol.transpose(0, 1), p1, p2, dtype)
    vert = _round(vf + vb, dtype)
    horz = _round(hf + hb, dtype).transpose(0, 1)
    return _round(vert + horz, dtype)


def _wta(agg: torch.Tensor, p) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-take-all, parabola subpixel step, uniqueness gate."""
    D = agg.shape[-1]
    best = torch.argmin(agg, dim=-1)
    cmin = agg.amin(dim=-1)
    ds = torch.arange(D, device=agg.device)
    far = torch.abs(ds - best[..., None]) > 1
    second = torch.where(far, agg, float("inf")).amin(dim=-1)
    unique_ok = second * (100 - p["uniqueness_ratio"]) >= cmin * 100

    def take(i):
        i = torch.clamp(i, 0, D - 1)[..., None]
        return torch.gather(agg, -1, i)[..., 0]

    cl, cr = take(best - 1), take(best + 1)
    denom = cl + cr - 2.0 * cmin
    delta = torch.where(torch.abs(denom) > 1e-9,
                        0.5 * (cl - cr) / torch.clamp(denom, min=1e-9),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    interior = (best > 0) & (best < D - 1)
    disp = (best.float() + torch.where(interior, delta, 0.0)
            + p["min_disparity"])
    return disp, unique_ok


def _lr_ok(agg: torch.Tensor, disp: torch.Tensor, p) -> torch.Tensor:
    """Left-right check from the same aggregate: the right image's
    disparity at x is argmin_d agg(x + d, d)."""
    W, D = agg.shape[-2:]
    dev = agg.device
    xd = torch.arange(W, device=dev)[:, None] + torch.arange(D, device=dev)
    right = torch.gather(agg, -2, torch.clamp(xd, max=W - 1).expand(agg.shape))
    right = torch.where(xd < W, right, float("inf"))
    d_right = torch.argmin(right, dim=-1).float()
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    xl = torch.clamp((xs - disp).long(), 0, W - 1)
    return torch.abs(disp - torch.gather(d_right, -1, xl)) \
        <= p["disp12_max_diff"] + 0.5


def _scan_min(v, start, dim):
    """Inclusive segmented min-scan along ``dim``; ``start`` cuts before."""
    L = v.shape[dim]
    off = 1
    while off < L:
        pv, ps = v.narrow(dim, 0, L - off), start.narrow(dim, 0, L - off)
        cv, cs = v.narrow(dim, off, L - off), start.narrow(dim, off, L - off)
        v = torch.cat([v.narrow(dim, 0, off),
                       torch.where(cs, cv, torch.minimum(pv, cv))], dim=dim)
        start = torch.cat([start.narrow(dim, 0, off), cs | ps], dim=dim)
        off *= 2
    return v


def _run_min(lbl, fwd, bwd, dim):
    back = _scan_min(lbl.flip(dim), bwd.flip(dim), dim).flip(dim)
    return torch.minimum(_scan_min(lbl, fwd, dim), back)


def _components(valid, same, sweeps, jumps):
    """Labels by the port's fixed schedule: ``sweeps`` rounds of run-min
    along rows and columns, each followed by ``jumps`` pointer jumps."""
    H, W = valid.shape
    dev = valid.device
    up, dn, lf, rt = same
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    up, dn = up & (row > 0) & valid, dn & (row < H - 1) & valid
    lf, rt = lf & (col > 0) & valid, rt & (col < W - 1) & valid
    lbl = torch.arange(H * W, device=dev).reshape(H, W)
    for _ in range(sweeps):
        lbl = _run_min(lbl, ~lf, ~rt, -1)
        lbl = _run_min(lbl, ~up, ~dn, -2)
        flat = lbl.reshape(-1)
        for _ in range(jumps):
            flat = flat[flat]
        lbl = flat.reshape(H, W)
    return lbl


def _speckle_ok(disp, valid, p):
    rng = p["speckle_range"] / 16.0

    def conn(dim, sh):
        return torch.roll(valid, sh, dim) & (
            torch.abs(disp - torch.roll(disp, sh, dim)) <= rng)

    lbl = _components(valid, (conn(-2, 1), conn(-2, -1), conn(-1, 1),
                              conn(-1, -1)),
                      p["speckle_cc_sweeps"], p["speckle_cc_jumps"])
    flat = lbl.reshape(-1)
    sizes = torch.zeros_like(flat).scatter_add_(0, flat,
                                                valid.reshape(-1).long())
    size = sizes[flat].reshape(disp.shape)
    return valid & (size >= p["speckle_window_size"])


@torch.no_grad()
def disparity(left: torch.Tensor, right: torch.Tensor, p: dict,
              precision: str = "float32") -> torch.Tensor:
    """(H, W) disparity of a rectified pair of (H, W) float images in
    [0, 1]; ``p`` holds the SGBM settings by the port's ``SgbmConfig``
    names."""
    dtype = getattr(torch, precision)
    vol = cost_volume(left.float(), right.float(), p, dtype)
    p1, p2 = float(p["p1"]) / 16.0, float(p["p2"]) / 16.0
    agg = aggregate(vol, p1, p2, dtype)
    disp, unique_ok = _wta(agg, p)
    valid = unique_ok & _lr_ok(agg, disp, p) & (disp > p["min_disparity"])
    valid = _speckle_ok(disp, valid, p)
    return torch.where(valid, disp, INVALID)


def bad_pixel_share(disp: torch.Tensor, ref: torch.Tensor,
                    tol_px: float = 1.0) -> float:
    """Share of pixels where two disparity maps disagree: one valid and the
    other not, or both valid and more than ``tol_px`` apart."""
    a, b = disp >= 0, ref >= 0
    bad = (a != b) | (a & b & (torch.abs(disp - ref) > tol_px))
    return float(bad.float().mean())
