"""Connected-component labelling on grids (SGBM speckle filter and the
U-disparity segmentation).

Counterpart of ``semantic_slam_mapping_tpu/ops/components.py``: the same
fixed schedule of ``sweeps`` run-min hooks, each followed by ``jumps``
pointer jumps, and the same contract (label = minimum flat index of the
component). The segmented run-min that JAX writes with
``lax.associative_scan`` is a log-step (Hillis-Steele) doubling loop here.
"""

from __future__ import annotations

import torch

from semantic_slam_mapping_torch.utils.timing import span


def _segmented_scan_min(v: torch.Tensor, start: torch.Tensor,
                        dim: int) -> torch.Tensor:
    """Inclusive segmented min-scan along ``dim``: ``start[i]`` cuts the
    segment before i. Hillis-Steele doubling over the associative operator
    (va, sa) . (vb, sb) = (sb ? vb : min(va, vb), sa | sb)."""
    L = v.shape[dim]
    off = 1
    while off < L:
        pv = v.narrow(dim, 0, L - off)
        ps = start.narrow(dim, 0, L - off)
        cv = v.narrow(dim, off, L - off)
        cs = start.narrow(dim, off, L - off)
        nv = torch.where(cs, cv, torch.minimum(pv, cv))
        v = torch.cat([v.narrow(dim, 0, off), nv], dim=dim)
        start = torch.cat([start.narrow(dim, 0, off), cs | ps], dim=dim)
        off *= 2
    return v


def _segmented_run_min(lbl: torch.Tensor, start_fwd: torch.Tensor,
                       start_bwd: torch.Tensor, dim: int) -> torch.Tensor:
    """Min label over each maximal connected run along ``dim``."""
    fwd = _segmented_scan_min(lbl, start_fwd, dim)
    bwd = _segmented_scan_min(lbl.flip(dim), start_bwd.flip(dim),
                              dim).flip(dim)
    return torch.minimum(fwd, bwd)


def connected_components(valid: torch.Tensor, same, sweeps: int = 16,
                         jumps: int = 1) -> torch.Tensor:
    """4-connected labelling of (..., H, W) grids, each frame on its own.
    ``same`` = (up, down, left, right): whether each pixel is connected to
    that neighbour. Returns (..., H, W) int64 labels equal to the minimum
    flat pixel index of each component within its frame; invalid pixels
    keep their own index."""
    H, W = valid.shape[-2:]
    dev = valid.device
    idx = torch.arange(H * W, device=dev).reshape(H, W).expand(valid.shape)
    up_ok, dn_ok, lf_ok, rt_ok = same
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    up_ok = up_ok & (row > 0) & valid
    dn_ok = dn_ok & (row < H - 1) & valid
    lf_ok = lf_ok & (col > 0) & valid
    rt_ok = rt_ok & (col < W - 1) & valid

    lbl = idx
    for _ in range(sweeps):
        with span("cc/sweep"):
            lbl = _segmented_run_min(lbl, ~lf_ok, ~rt_ok, dim=-1)
            lbl = _segmented_run_min(lbl, ~up_ok, ~dn_ok, dim=-2)
            # pointer jumps within each frame: a label is a flat index of
            # its own frame
            flat = lbl.reshape(-1, H * W)
            for _ in range(jumps):
                flat = torch.gather(flat, 1, flat)
            lbl = flat.reshape(valid.shape)
    return lbl
