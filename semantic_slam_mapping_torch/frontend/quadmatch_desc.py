"""Descriptor-mode quad matching: ORB in all four images, then window-
constrained nearest neighbours lc -> rc -> rp -> lp -> lc, and only the
chains that close on their starting feature.

Counterpart of ``semantic_slam_mapping_tpu/frontend/quadmatch_desc.py``:
four ORB extractions, four windowed Hamming-argmin passes
(``ops/matching.windowed_match``: the stereo legs in a wide, flat epipolar
window, the temporal legs in a square of the largest flow), index chaining
by gathers, and the quad matcher's geometric gates.
"""

from __future__ import annotations

import torch

from semantic_slam_mapping_torch.config import OrbConfig, QuadMatchConfig
from semantic_slam_mapping_torch.frontend.vo import QuadMatches
from semantic_slam_mapping_torch.ops import matching, orb


def quad_match_desc(cur_left: torch.Tensor, cur_right: torch.Tensor,
                    prev_left: torch.Tensor, prev_right: torch.Tensor,
                    qcfg: QuadMatchConfig = QuadMatchConfig(),
                    ocfg: OrbConfig = OrbConfig()) -> QuadMatches:
    """ORB-descriptor circular matching across the four views."""
    f_lc = orb.extract(cur_left, ocfg)
    f_rc = orb.extract(cur_right, ocfg)
    f_rp = orb.extract(prev_right, ocfg)
    f_lp = orb.extract(prev_left, ocfg)

    flow = qcfg.max_dx_temporal
    stereo_dv = qcfg.max_dy_stereo + 1.0
    m1 = matching.windowed_match(f_lc.desc, f_lc.xy, f_rc.desc, f_rc.xy,
                                 f_lc.valid, f_rc.valid, du=256.0,
                                 dv=stereo_dv)
    m2 = matching.windowed_match(f_rc.desc, f_rc.xy, f_rp.desc, f_rp.xy,
                                 f_rc.valid, f_rp.valid, du=flow, dv=flow)
    m3 = matching.windowed_match(f_rp.desc, f_rp.xy, f_lp.desc, f_lp.xy,
                                 f_rp.valid, f_lp.valid, du=256.0,
                                 dv=stereo_dv)
    m4 = matching.windowed_match(f_lp.desc, f_lp.xy, f_lc.desc, f_lc.xy,
                                 f_lp.valid, f_lc.valid, du=flow, dv=flow)

    n = f_lc.xy.shape[0]
    i_rc = torch.clamp(m1.idx, 0, n - 1)
    i_rp = torch.clamp(m2.idx[i_rc], 0, n - 1)
    i_lp = torch.clamp(m3.idx[i_rp], 0, n - 1)
    chain_ok = (m1.valid & m2.valid[i_rc] & m3.valid[i_rp]
                & m4.valid[i_lp])
    # the chain must return to the feature it started from
    closed = chain_ok & (m4.idx[i_lp] == torch.arange(n, device=i_rc.device))

    lc, rc, rp, lp = f_lc.xy, f_rc.xy[i_rc], f_rp.xy[i_rp], f_lp.xy[i_lp]
    valid = (closed & f_lc.valid
             & (torch.abs(lc[:, 1] - rc[:, 1]) < qcfg.max_dy_stereo)
             & (torch.abs(lp[:, 1] - rp[:, 1]) < qcfg.max_dy_stereo)
             & (lc[:, 0] - rc[:, 0] > qcfg.min_disparity)
             & (lp[:, 0] - rp[:, 0] > qcfg.min_disparity)
             & (torch.abs(lc[:, 1] - lp[:, 1]) < qcfg.max_dy_temporal)
             & (torch.abs(lc[:, 0] - lp[:, 0]) < qcfg.max_dx_temporal))
    return QuadMatches(lp=lp, rp=rp, lc=lc, rc=rc, valid=valid)
