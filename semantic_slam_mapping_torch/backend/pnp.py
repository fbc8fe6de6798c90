"""Motion-only bundle adjustment (PnP) with robust re-weighting, and the
descriptor-matched PnP gate of the pose-graph edges.

Counterpart of ``semantic_slam_mapping_tpu/backend/pnp.py``: 4 rounds of
10 Levenberg steps on the 6x6 normal equations with Huber weights, and a
chi^2 > 5.991 re-gate of the observations between rounds. The JAX package
takes the Jacobian of ``project(exp(d) T X)`` from ``jax.jacfwd``; here it
is written out (dP/d[v, w] = [I, -[P]x] at d = 0, as in
``frontend/vo.py``).

Every function takes a leading batch dimension over problems (the epoch
solves one PnP per candidate keyframe in one call); inputs without it
broadcast against those with it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from semantic_slam_mapping_torch.config import PnpConfig
from semantic_slam_mapping_torch.geometry import se3
from semantic_slam_mapping_torch.geometry.camera import Intrinsics, project
from semantic_slam_mapping_torch.ops import matching
from semantic_slam_mapping_torch.utils.timing import span


class PnpResult(NamedTuple):
    T: torch.Tensor           # (..., 4, 4) ref-cam -> cur-cam
    inliers: torch.Tensor     # (..., N) bool
    n_inliers: torch.Tensor
    success: torch.Tensor
    chi2: torch.Tensor        # robust total chi^2 over the inliers


class PnpInformation(NamedTuple):
    """The edge gate's record: matches, inliers, pose and verdict."""

    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    T: torch.Tensor
    success: torch.Tensor


def _residuals(T: torch.Tensor, X: torch.Tensor, uv: torch.Tensor,
               K: Intrinsics) -> torch.Tensor:
    return uv - project(K, se3.transform_points(T, X))


def _jacobian(P: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """d residual / d delta of the update exp(delta) T at delta = 0, given
    P = T X (..., N, 3): (..., N, 2, 6)."""
    x, y, z = P.unbind(-1)
    small = torch.abs(z) < 1e-9
    iz = 1.0 / torch.where(small, torch.full_like(z, 1e-9), z)
    iz2 = torch.where(small, torch.zeros_like(z), iz * iz)
    zero = torch.zeros_like(z)
    du = torch.stack([K.fx * iz, zero, -K.fx * x * iz2], dim=-1)
    dv = torch.stack([zero, K.fy * iz, -K.fy * y * iz2], dim=-1)
    dproj = torch.stack([du, dv], dim=-2)                       # (..., 2, 3)
    eye = torch.eye(3, dtype=P.dtype, device=P.device).expand(
        P.shape[:-1] + (3, 3))
    return -(dproj @ torch.cat([eye, -se3.hat(P)], dim=-1))


def solve_pnp(X: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
              K: Intrinsics, T_init: torch.Tensor,
              cfg: PnpConfig = PnpConfig()) -> PnpResult:
    """Robust motion-only BA. X (..., N, 3) points in the reference camera,
    uv (..., N, 2) their observations in the current image, T_init
    (..., 4, 4) the initial ref -> cur pose."""
    delta, chi2_th = cfg.huber_delta, cfg.chi2_threshold
    batch = torch.broadcast_shapes(X.shape[:-2], uv.shape[:-2],
                                   valid.shape[:-1], T_init.shape[:-2])
    T = T_init.expand(batch + (4, 4))
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    valid_f = valid.float()
    active = torch.ones(batch + valid.shape[-1:], dtype=torch.bool,
                        device=valid.device)
    for _ in range(cfg.rounds):
        w_act = active.float() * valid_f
        for _ in range(cfg.iters_per_round):
            with span("pnp/lm_step"):
                P = se3.transform_points(T, X)
                r = uv - project(K, P)                  # (..., N, 2)
                J = _jacobian(P, K)                     # (..., N, 2, 6)
                rn = torch.linalg.norm(r, dim=-1)
                w = w_act * torch.clamp(delta / torch.clamp(rn, min=1e-9),
                                        max=1.0)
                Jw = J * w[..., None, None]
                H = torch.einsum("...nri,...nrj->...ij", Jw, J) + 1e-6 * eye6
                g = torch.einsum("...nri,...nr->...i", Jw, r)
                d = -torch.linalg.solve_ex(H, g)[0]
                ok = torch.all(torch.isfinite(d), dim=-1, keepdim=True)
                T = se3.exp(torch.where(ok, d, 0.0)) @ T
        # re-gate between rounds: edges over the chi^2 threshold drop out,
        # and come back once they are under it again
        with span("pnp/regate"):
            r = _residuals(T, X, uv, K)
            active = torch.sum(r * r, dim=-1) <= chi2_th

    with span("pnp/inliers"):
        r = _residuals(T, X, uv, K)
        chi2_i = torch.sum(r * r, dim=-1)
        inl = valid & (chi2_i <= chi2_th)
        n_inl = torch.sum(inl, dim=-1)
        rho = torch.where(chi2_i <= delta ** 2, chi2_i,
                          2.0 * delta * torch.sqrt(chi2_i) - delta ** 2)
        total = torch.sum(torch.where(inl, rho, 0.0), dim=-1)
        finite = torch.all(torch.isfinite(T).flatten(-2), dim=-1)
    return PnpResult(T=T, inliers=inl, n_inliers=n_inl,
                     success=(n_inl >= cfg.min_inliers) & finite, chi2=total)


def solve_pnp_lazy(desc_ref: torch.Tensor, xyz_ref: torch.Tensor,
                   valid_ref: torch.Tensor,
                   desc_cur: torch.Tensor, xy_cur: torch.Tensor,
                   valid_cur: torch.Tensor,
                   K: Intrinsics, T_init: torch.Tensor,
                   cfg: PnpConfig = PnpConfig(),
                   knn_ratio: float = 0.8) -> PnpInformation:
    """ORB-match two frames, then PnP: the pose-graph edge gate. xyz_ref
    are the reference features' 3D points in the reference camera (no
    depth: valid_ref False)."""
    with span("pnp/solve"):
        m = matching.match_descriptors(desc_ref, desc_cur, valid_ref,
                                       valid_cur, ratio=knn_ratio)
        idx = torch.clamp(m.idx, 0, xy_cur.shape[-2] - 1)
        batch = m.idx.shape[:-1]
        uv = torch.gather(xy_cur.expand(batch + xy_cur.shape[-2:]), -2,
                          idx[..., None].expand(idx.shape + (2,)))
        pair_valid = m.valid & valid_ref
        n_matches = torch.sum(pair_valid, dim=-1)
        res = solve_pnp(xyz_ref, uv, pair_valid, K, T_init, cfg)
        return PnpInformation(
            n_matches=n_matches, n_inliers=res.n_inliers, T=res.T,
            success=res.success & (n_matches >= cfg.min_matches))
