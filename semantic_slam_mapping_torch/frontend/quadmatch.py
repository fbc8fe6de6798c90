"""Circular (quad) feature matching across the stereo pair and two frames.

Counterpart of ``semantic_slam_mapping_tpu/frontend/quadmatch.py``: GFTT
in the current left image, then the KLT chain lc -> rc -> rp -> lp and the
direct lc -> lp track, kept only where the chain closes on the direct
track and the reference's geometric gates pass.
"""

from __future__ import annotations

from typing import Optional

import torch

from semantic_slam_mapping_torch.config import (GfttConfig, KltConfig,
                                                QuadMatchConfig)
from semantic_slam_mapping_torch.frontend.vo import QuadMatches
from semantic_slam_mapping_torch.ops import corners, klt
from semantic_slam_mapping_torch.ops import image as im


def quad_match(cur_left: torch.Tensor, cur_right: torch.Tensor,
               prev_left: torch.Tensor, prev_right: torch.Tensor,
               qcfg: QuadMatchConfig = QuadMatchConfig(),
               gcfg: GfttConfig = GfttConfig(),
               kcfg: KltConfig = KltConfig(),
               cur_disparity: Optional[torch.Tensor] = None,
               flow_prior: Optional[torch.Tensor] = None) -> QuadMatches:
    """Detect in the current left image and track the circle
    lc -> rc -> rp -> lp, plus the direct lc -> lp check.

    Frames are (H, W) or a batch (B, H, W) of independent pairs.
    cur_disparity: optional (..., H, W) disparity seeding the stereo leg.
    flow_prior: optional (2,) or, for a batch, (B, 2) image-flow prior
    seeding the temporal legs.
    """
    kp = corners.gftt(cur_left, max_corners=qcfg.max_features,
                      quality_level=gcfg.quality_level,
                      min_distance=gcfg.min_distance,
                      block_size=gcfg.block_size)
    lc = kp.xy
    pyr = {name: im.build_pyramid(img, kcfg.pyramid_levels, 2.0)
           for name, img in (("lc", cur_left), ("rc", cur_right),
                             ("lp", prev_left), ("rp", prev_right))}

    stereo_init = None
    if cur_disparity is not None:
        d0 = torch.clamp(im.bilinear_sample(cur_disparity, lc), min=0.0)
        stereo_init = torch.stack([-d0, torch.zeros_like(d0)], dim=-1)
    # contiguous: the KLT kernel reads the init as a dense (..., N, 2)
    t_init = (flow_prior[..., None, :].expand_as(lc).contiguous()
              if flow_prior is not None else None)

    leg_rc = klt.track_pyramid(pyr["lc"], pyr["rc"], lc, kcfg, stereo_init)
    leg_rp = klt.track_pyramid(pyr["rc"], pyr["rp"], leg_rc.xy, kcfg, t_init)
    leg_lp = klt.track_pyramid(pyr["rp"], pyr["lp"], leg_rp.xy, kcfg)
    direct_lp = klt.track_pyramid(pyr["lc"], pyr["lp"], lc, kcfg, t_init)

    rc, rp, lp, lp2 = leg_rc.xy, leg_rp.xy, leg_lp.xy, direct_lp.xy
    tracked = (kp.valid & leg_rc.status & leg_rp.status
               & leg_lp.status & direct_lp.status)
    closure = torch.linalg.norm(lp - lp2, dim=-1)
    valid = (tracked
             & (torch.abs(lc[..., 1] - rc[..., 1]) < qcfg.max_dy_stereo)
             & (torch.abs(lp[..., 1] - rp[..., 1]) < qcfg.max_dy_stereo)
             & (torch.abs(lc[..., 1] - lp[..., 1]) < qcfg.max_dy_temporal)
             & (torch.abs(rc[..., 1] - rp[..., 1]) < qcfg.max_dy_temporal)
             & (torch.abs(lc[..., 0] - lp[..., 0]) < qcfg.max_dx_temporal)
             & (torch.abs(rc[..., 0] - rp[..., 0]) < qcfg.max_dx_temporal)
             & (lc[..., 0] - rc[..., 0] > qcfg.min_disparity)
             & (lp[..., 0] - rp[..., 0] > qcfg.min_disparity)
             & (closure < qcfg.loop_consistency_px))
    return QuadMatches(lp=lp, rp=rp, lc=lc, rc=rc, valid=valid)
