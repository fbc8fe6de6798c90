"""Parity of the port's PnP with the JAX package. ``solve_pnp`` on noisy
projections with 20% gross outliers: pose within 1e-4, inlier masks and
verdicts equal. ``solve_pnp_lazy`` batched over five reference keyframes,
one of them a different scene: the same, and the match counts exact. (The
port's Jacobian is analytic, JAX's from ``jax.jacfwd``; both run the same
float32 Levenberg steps.)"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.backend import pnp as jpnp
from semantic_slam_mapping_tpu.geometry import se3 as jse3
from semantic_slam_mapping_torch import config as tcfg
from semantic_slam_mapping_torch.backend import pnp as tpnp
from torch_parity_scene import JK_, TK, to_np

torch.set_num_threads(2)


def _scene(rng, n, T):
    """n points in front of the reference camera and their projections in
    the current one (T: ref -> cur), with 0.5 px noise."""
    X = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 30, n)], -1).astype(np.float32)
    P = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([TK.fx * P[:, 0] / P[:, 2] + TK.cx,
                   TK.fy * P[:, 1] / P[:, 2] + TK.cy], -1)
    return X, (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)


def _pose(xi):
    return np.asarray(jse3.exp(jnp.asarray(xi, jnp.float32)), np.float32)


def _check(j, t):
    ok = to_np(j.success)
    np.testing.assert_array_equal(to_np(t.success), ok)
    np.testing.assert_allclose(to_np(t.T)[ok], to_np(j.T)[ok], atol=1e-4)
    np.testing.assert_array_equal(to_np(t.n_inliers), to_np(j.n_inliers))


def test_solve_pnp_matches_jax():
    rng = np.random.default_rng(1)
    T = _pose([0.1, -0.05, 0.4, 0.02, -0.03, 0.01])
    X, uv = _scene(rng, 150, T)
    out = rng.random(150) < 0.2
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2)).astype(np.float32)
    valid = rng.random(150) < 0.95
    T0 = np.eye(4, dtype=np.float32)
    j = jpnp.solve_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                       JK_, jnp.asarray(T0), jcfg.PnpConfig())
    t = tpnp.solve_pnp(torch.from_numpy(X), torch.from_numpy(uv),
                       torch.from_numpy(valid), TK, torch.from_numpy(T0),
                       tcfg.PnpConfig())
    assert bool(j.success)
    _check(j, t)
    np.testing.assert_array_equal(to_np(t.inliers), to_np(j.inliers))
    np.testing.assert_allclose(float(t.chi2), float(j.chi2), rtol=1e-4)
    np.testing.assert_allclose(to_np(t.T), T, atol=0.05)


def test_solve_pnp_lazy_batched_matches_jax():
    rng = np.random.default_rng(2)
    n = 200
    T = _pose([0.3, 0.0, 1.2, 0.0, 0.05, 0.0])
    X, uv = _scene(rng, n, T)
    desc = (rng.random((n, 256)) < 0.5).astype(np.uint8)
    # the current frame: the same points in another order, a few bits
    # flipped, 15% of them lost and replaced by unrelated descriptors
    perm = rng.permutation(n)
    desc_cur = desc[perm] ^ (rng.random((n, 256)) < 0.03).astype(np.uint8)
    lost = rng.random(n) < 0.15
    desc_cur[lost] = (rng.random((lost.sum(), 256)) < 0.5).astype(np.uint8)
    xy_cur, valid_cur = uv[perm], rng.random(n) < 0.97
    # five references: the true one under four initial poses, and a
    # different scene (unrelated descriptors and points)
    X_o, _ = _scene(rng, n, T)
    desc_o = (rng.random((n, 256)) < 0.5).astype(np.uint8)
    refs = [(desc, X)] * 4 + [(desc_o, X_o)]
    valid_ref = np.stack([rng.random(n) < 0.9 for _ in refs])
    T_init = np.stack([np.eye(4, dtype=np.float32), _pose([0.2] * 6),
                       _pose([-0.3, 0.1, 0.5, 0.0, 0.02, 0.0]), T,
                       np.eye(4, dtype=np.float32)])
    args = [np.stack([r[0] for r in refs]), np.stack([r[1] for r in refs]),
            valid_ref]
    cfg = jcfg.PnpConfig()
    j = jax.vmap(lambda d, x, v, Ti: jpnp.solve_pnp_lazy(
        d, x, v, jnp.asarray(desc_cur), jnp.asarray(xy_cur),
        jnp.asarray(valid_cur), JK_, Ti, cfg, 0.8))(
        *map(jnp.asarray, args), jnp.asarray(T_init))
    t = tpnp.solve_pnp_lazy(*map(torch.from_numpy, args),
                            torch.from_numpy(desc_cur),
                            torch.from_numpy(xy_cur),
                            torch.from_numpy(valid_cur), TK,
                            torch.from_numpy(T_init), tcfg.PnpConfig(), 0.8)
    np.testing.assert_array_equal(to_np(t.n_matches), to_np(j.n_matches))
    assert to_np(j.success).tolist() == [True] * 4 + [False]
    _check(j, t)
    # a problem's result does not depend on the others in its batch
    one = tpnp.solve_pnp_lazy(*(torch.from_numpy(a[1]) for a in args),
                              torch.from_numpy(desc_cur),
                              torch.from_numpy(xy_cur),
                              torch.from_numpy(valid_cur), TK,
                              torch.from_numpy(T_init[1]), tcfg.PnpConfig(),
                              0.8)
    np.testing.assert_allclose(to_np(one.T), to_np(t.T)[1], atol=1e-4)
