"""Stereo visual odometry: RANSAC + Gauss-Newton over quad matches.

Counterpart of ``semantic_slam_mapping_tpu/frontend/vo.py``. The
hypotheses are a leading batch dimension: every one runs
``gn_iters_hypothesis`` Gauss-Newton steps on its 3-point sample with a
batched 6x6 solve, then scores every match; the best is refined on all its
inliers. The Jacobian of the 4-D stereo residual is written out
analytically (the JAX package takes it from ``jax.jacfwd``).

Random samples come from a ``torch.Generator``; PyTorch cannot replay
``jax.random``, so :func:`estimate_motion` also takes the samples as
``picks`` (indices into the valid-first order of the matches).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from semantic_slam_mapping_torch.config import VoConfig
from semantic_slam_mapping_torch.geometry import se3
from semantic_slam_mapping_torch.geometry.camera import (Intrinsics,
                                                         project_stereo,
                                                         triangulate_stereo)


class QuadMatches(NamedTuple):
    """Fixed-budget 4-view correspondences, (N, 2) pixel coords [u, v]."""

    lp: torch.Tensor   # left previous
    rp: torch.Tensor   # right previous
    lc: torch.Tensor   # left current
    rc: torch.Tensor   # right current
    valid: torch.Tensor  # (N,)


class VoResult(NamedTuple):
    T_delta: torch.Tensor     # (4, 4) previous-cam -> current-cam motion
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor   # int64 scalar
    success: torch.Tensor     # bool scalar
    mean_residual: torch.Tensor


def _residuals(T: torch.Tensor, X: torch.Tensor, obs: torch.Tensor,
               K: Intrinsics) -> torch.Tensor:
    """(…, N, 4) stereo reprojection residuals obs - proj(T X)."""
    return obs - project_stereo(K, se3.transform_points(T, X))


def _sq_err(T, X, obs, K) -> torch.Tensor:
    r = _residuals(T, X, obs, K)
    return torch.sum(r * r, dim=-1)


def _jacobian(P: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """d residual / d delta at delta = 0 for the update exp(delta) T, given
    the transformed points P = T X (…, N, 3): (…, N, 4, 6). With
    exp(delta) P ~ P + v + w x P, dP/d[v, w] = [I, -[P]x]."""
    x, y, z = P.unbind(-1)
    small = torch.abs(z) < 1e-9
    iz = 1.0 / torch.where(small, torch.full_like(z, 1e-9), z)
    iz2 = torch.where(small, torch.zeros_like(z), iz * iz)
    zero = torch.zeros_like(z)
    # rows: d[u_l, v_l, u_r, v_r] / d[x, y, z]
    du_l = torch.stack([K.fx * iz, zero, -K.fx * x * iz2], dim=-1)
    dv = torch.stack([zero, K.fy * iz, -K.fy * y * iz2], dim=-1)
    du_r = torch.stack([K.fx * iz, zero, -K.fx * (x - K.baseline) * iz2],
                       dim=-1)
    dproj = torch.stack([du_l, dv, du_r, dv], dim=-2)          # (…, 4, 3)
    eye = torch.eye(3, dtype=P.dtype, device=P.device).expand(
        P.shape[:-1] + (3, 3))
    dP = torch.cat([eye, -se3.hat(P)], dim=-1)                 # (…, 3, 6)
    return -(dproj @ dP)


def _gn_refine(T0: torch.Tensor, X: torch.Tensor, obs: torch.Tensor,
               w: torch.Tensor, K: Intrinsics, iters: int,
               damping: float = 1e-6, step_tol: float = 0.0) -> torch.Tensor:
    """Weighted Gauss-Newton on SE(3), T <- exp(delta) T, batched over the
    leading dim B of T0 (B, 4, 4) and w (B, N). A fixed number of steps;
    each problem freezes once |delta| < step_tol."""
    T = T0
    done = torch.zeros(T.shape[0], dtype=torch.bool, device=T.device)
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(iters):
        P = se3.transform_points(T, X)                          # (B, N, 3)
        r = obs - project_stereo(K, P)                          # (B, N, 4)
        J = _jacobian(P, K)                                     # (B, N, 4, 6)
        Jw = J * w[:, :, None, None]
        H = torch.einsum("bnri,bnrj->bij", Jw, J) + damping * eye6
        g = torch.einsum("bnri,bnr->bi", Jw, r)
        delta = -torch.linalg.solve_ex(H, g)[0]
        ok = torch.all(torch.isfinite(delta), dim=-1) & ~done
        T = se3.exp(torch.where(ok[:, None], delta, 0.0)) @ T
        done = done | (torch.linalg.norm(delta, dim=-1) < step_tol)
    return T


def _distinct3(gen: Optional[torch.Generator], n: torch.Tensor,
               count: int) -> torch.Tensor:
    """(count, 3) triples of distinct indices in [0, n) (n >= 3)."""
    n = torch.clamp(n, min=3)
    hi = torch.stack([n, n - 1, n - 2])
    u = torch.rand((count, 3), generator=gen, device=n.device)
    r = torch.minimum(torch.floor(u * hi).long(), hi - 1)
    i0 = r[:, 0]
    i1 = r[:, 1] + (r[:, 1] >= i0).long()
    a, b = torch.minimum(i0, i1), torch.maximum(i0, i1)
    i2 = r[:, 2] + (r[:, 2] >= a).long()
    i2 = i2 + (i2 >= b).long()
    return torch.stack([i0, i1, i2], dim=-1)


def estimate_motion(matches: QuadMatches, K: Intrinsics,
                    generator: Optional[torch.Generator] = None,
                    cfg: VoConfig = VoConfig(),
                    picks: Optional[torch.Tensor] = None) -> VoResult:
    """RANSAC + GN motion from quad matches: T maps previous-camera to
    current-camera coordinates.

    picks: optional (ransac_iters, 3) int tensor of sample indices into the
      valid-first order of the matches; drawn from ``generator`` if None.
    """
    valid = matches.valid
    N = valid.shape[0]
    dev = valid.device
    disp = torch.clamp(matches.lp[:, 0] - matches.rp[:, 0], min=0.1)
    X = triangulate_stereo(K, matches.lp, disp)
    obs = torch.cat([matches.lc, matches.rc], dim=-1)
    if cfg.reweighting:
        w_geom = 1.0 / (torch.abs(matches.lc[:, 0] - K.cx) / abs(K.cx)
                        + cfg.match_radius_reweight)
    else:
        w_geom = torch.ones(N, device=dev)
    w_valid = valid.float()
    thr2 = cfg.inlier_threshold ** 2

    # ---- hypotheses: 3 valid matches each (valid first, stable order) ----
    order = torch.argsort((~valid).int(), stable=True)
    if picks is None:
        picks = _distinct3(generator, valid.sum(), cfg.ransac_iters)
    idx = order[picks.to(dev).long()]                           # (R, 3)
    R = idx.shape[0]
    w = torch.zeros(R, N, device=dev).scatter_(1, idx, 1.0) * w_valid
    T0 = se3.identity(device=dev).expand(R, 4, 4)
    Ts = _gn_refine(T0, X, obs, w, K, cfg.gn_iters_hypothesis,
                    step_tol=cfg.gn_step_tol)
    scores = ((_sq_err(Ts, X, obs, K) < thr2) & valid).sum(dim=-1)
    T_best = Ts[torch.argmax(scores)]

    # ---- final refinement on all inliers of the best hypothesis ----
    inl = (_sq_err(T_best, X, obs, K) < thr2) & valid
    T_final = _gn_refine(T_best[None], X, obs, (inl.float() * w_geom)[None],
                         K, cfg.gn_iters_refine,
                         step_tol=cfg.gn_step_tol)[0]
    err_f = _sq_err(T_final, X, obs, K)
    inl_f = (err_f < thr2) & valid
    n_inl = inl_f.sum()
    success = (n_inl >= 6) & torch.all(torch.isfinite(T_final))
    mean_res = torch.sqrt(torch.sum(torch.where(inl_f, err_f, 0.0))
                          / torch.clamp(n_inl, min=1))
    return VoResult(T_delta=T_final, inliers=inl_f, n_inliers=n_inl,
                    success=success, mean_residual=mean_res)
