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
    """Fixed-budget 4-view correspondences, (..., N, 2) pixel coords [u, v]
    (a leading batch dim holds independent frame pairs)."""

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
               damping: float = 1e-6, step_tol: float = 0.0,
               groups: int = 1) -> torch.Tensor:
    """Weighted Gauss-Newton on SE(3), T <- exp(delta) T, batched over the
    leading dims of T0 (..., 4, 4) and w (..., N); X (N, 3) and obs (N, 4)
    are shared, or carry the same leading dims. A fixed number of steps;
    each problem freezes once |delta| < step_tol.

    ``groups`` > 1 cuts the flattened problems into that many equal groups
    (one a frame pair) and runs the Jacobian, the normal equations and the
    update of each group in calls of its own. cuBLAS picks its kernel by
    the batch count, so on the card a product over several pairs' problems
    rounds otherwise than over one pair's (the normal equations of a batch
    of 3 refines moved by 1.7e-4 against 3 single ones); per group, each
    pair gets the bits of its own unbatched call."""
    lead = T0.shape[:-2]
    N = w.shape[-1]
    T = T0.reshape(-1, 4, 4)
    w = w.reshape(-1, N)
    if X.dim() > 2:
        X = X.expand(lead + X.shape[-2:]).reshape(-1, N, 3)
        obs = obs.expand(lead + obs.shape[-2:]).reshape(-1, N, 4)
    done = torch.zeros(T.shape[0], dtype=torch.bool, device=T.device)
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)

    def per_group(fn, *xs):
        if groups == 1:
            return fn(*xs)
        return torch.cat([fn(*part) for part in
                          zip(*(x.chunk(groups) for x in xs))])

    for _ in range(iters):
        P = se3.transform_points(T, X)                          # (B, N, 3)
        r = obs - project_stereo(K, P)                          # (B, N, 4)
        J = per_group(lambda p: _jacobian(p, K), P)             # (B, N, 4, 6)
        Jw = J * w[:, :, None, None]
        H = per_group(lambda a, b: torch.einsum("bnri,bnrj->bij", a, b),
                      Jw, J) + damping * eye6
        g = per_group(lambda a, b: torch.einsum("bnri,bnr->bi", a, b),
                      Jw, r)
        delta = -torch.linalg.solve_ex(H, g)[0]
        ok = torch.all(torch.isfinite(delta), dim=-1) & ~done
        T = per_group(lambda d, t: se3.exp(d) @ t,
                      torch.where(ok[:, None], delta, 0.0), T)
        done = done | (torch.linalg.norm(delta, dim=-1) < step_tol)
    return T.reshape(lead + (4, 4))


def _distinct3(gen: Optional[torch.Generator], n: torch.Tensor,
               count: int) -> torch.Tensor:
    """(..., count, 3) triples of distinct indices in [0, n) (n >= 3), for
    counts n of any batch shape."""
    u = torch.rand(n.shape + (count, 3), generator=gen, device=n.device)
    return distinct3_from_uniform(u, n)


def distinct3_from_uniform(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The triples of :func:`_distinct3` from its uniform draws u
    (n.shape + (count, 3)): a caller that draws a whole batch's u and keeps
    a block of rows gets that block's triples of the whole draw."""
    n = torch.clamp(n, min=3)
    hi = torch.stack([n, n - 1, n - 2], dim=-1)[..., None, :]
    r = torch.minimum(torch.floor(u * hi).long(), hi - 1)
    i0 = r[..., 0]
    i1 = r[..., 1] + (r[..., 1] >= i0).long()
    a, b = torch.minimum(i0, i1), torch.maximum(i0, i1)
    i2 = r[..., 2] + (r[..., 2] >= a).long()
    i2 = i2 + (i2 >= b).long()
    return torch.stack([i0, i1, i2], dim=-1)


def estimate_motion(matches: QuadMatches, K: Intrinsics,
                    generator: Optional[torch.Generator] = None,
                    cfg: VoConfig = VoConfig(),
                    picks: Optional[torch.Tensor] = None,
                    pairwise: bool = False) -> VoResult:
    """RANSAC + GN motion from quad matches: T maps previous-camera to
    current-camera coordinates. Matches are (N,) or a batch (B, N) of
    independent frame pairs, each solved on its own.

    picks: optional (..., ransac_iters, 3) int tensor of sample indices
      into each pair's valid-first order of its matches; drawn from
      ``generator`` if None, per pair.
    pairwise: for a batch, solve each pair's normal equations in calls of
      its own (see ``_gn_refine``), so that each pair's result equals its
      unbatched call to the bit; otherwise a batch agrees with its single
      calls to rounding (1.2e-6 in T on the card), in fewer launches.
    """
    valid = matches.valid
    lead = valid.shape[:-1]
    N = valid.shape[-1]
    dev = valid.device
    disp = torch.clamp(matches.lp[..., 0] - matches.rp[..., 0], min=0.1)
    X = triangulate_stereo(K, matches.lp, disp)
    obs = torch.cat([matches.lc, matches.rc], dim=-1)
    if cfg.reweighting:
        w_geom = 1.0 / (torch.abs(matches.lc[..., 0] - K.cx) / abs(K.cx)
                        + cfg.match_radius_reweight)
    else:
        w_geom = torch.ones(lead + (N,), device=dev)
    w_valid = valid.float()
    thr2 = cfg.inlier_threshold ** 2
    # a pair's hypotheses share its points: (..., 1, N, ·) beside (..., R)
    X_h = X[..., None, :, :] if lead else X
    obs_h = obs[..., None, :, :] if lead else obs

    # ---- hypotheses: 3 valid matches each (valid first, stable order) ----
    order = torch.argsort((~valid).int(), dim=-1, stable=True)
    if picks is None:
        picks = _distinct3(generator, valid.sum(dim=-1), cfg.ransac_iters)
    picks = picks.to(dev).long().expand(lead + picks.shape[-2:])
    R = picks.shape[-2]
    idx = torch.gather(order[..., None, :].expand(lead + (R, N)), -1,
                       picks)                                   # (..., R, 3)
    w = (torch.zeros(lead + (R, N), device=dev).scatter_(-1, idx, 1.0)
         * w_valid[..., None, :])
    T0 = se3.identity(device=dev).expand(lead + (R, 4, 4))
    groups = lead.numel() if pairwise else 1
    Ts = _gn_refine(T0, X_h, obs_h, w, K, cfg.gn_iters_hypothesis,
                    step_tol=cfg.gn_step_tol, groups=groups)
    scores = ((_sq_err(Ts, X_h, obs_h, K) < thr2)
              & valid[..., None, :]).sum(dim=-1)
    best = torch.argmax(scores, dim=-1)
    T_best = torch.take_along_dim(Ts, best[..., None, None, None],
                                  dim=-3)[..., 0, :, :]

    # ---- final refinement on all inliers of the best hypothesis ----
    inl = (_sq_err(T_best, X, obs, K) < thr2) & valid
    T_final = _gn_refine(T_best[..., None, :, :], X_h, obs_h,
                         (inl.float() * w_geom)[..., None, :], K,
                         cfg.gn_iters_refine, step_tol=cfg.gn_step_tol,
                         groups=groups)[..., 0, :, :]
    err_f = _sq_err(T_final, X, obs, K)
    inl_f = (err_f < thr2) & valid
    n_inl = inl_f.sum(dim=-1)
    success = (n_inl >= 6) & torch.all(torch.isfinite(T_final),
                                        dim=-1).all(dim=-1)
    mean_res = torch.sqrt(torch.sum(torch.where(inl_f, err_f, 0.0), dim=-1)
                          / torch.clamp(n_inl, min=1))
    return VoResult(T_delta=T_final, inliers=inl_f, n_inliers=n_inl,
                    success=success, mean_residual=mean_res)
