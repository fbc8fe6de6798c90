"""Parity of the port's RANSAC + Gauss-Newton stereo VO with the JAX
package. PyTorch cannot replay ``jax.random``, so the port is given the
samples JAX draws (``picks``). Tolerances: rotation 1e-4 and translation
1e-3 m (the same GN steps in float32, the Jacobian analytic in the port
and from ``jax.jacfwd`` in JAX); inlier sets must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.frontend import vo as jvo
from semantic_slam_mapping_torch.frontend import vo as tvo
from semantic_slam_mapping_torch.geometry import se3 as tse3
from torch_parity_scene import JK_, TCFG, TK, to_np

torch.set_num_threads(2)


def _synthetic_matches(n, n_out, seed):
    """Stereo matches of random points under a known motion, with pixel
    noise and n_out gross outliers."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                  rng.uniform(5, 30, n)], -1).astype(np.float32)
    T = tse3.exp(torch.tensor([0.05, -0.02, 0.6, 0.01, 0.03, -0.005]))
    Xc = tse3.transform_points(T, torch.from_numpy(X)).numpy()

    def stereo(P):
        u = TK.fx * P[:, 0] / P[:, 2] + TK.cx
        v = TK.fy * P[:, 1] / P[:, 2] + TK.cy
        ur = TK.fx * (P[:, 0] - TK.baseline) / P[:, 2] + TK.cx
        return np.stack([u, v], -1), np.stack([ur, v], -1)

    lp, rp = stereo(X)
    lc, rc = stereo(Xc)
    lc = lc + rng.normal(0, 0.2, lc.shape)
    lc[:n_out] += rng.uniform(10, 30, (n_out, 2))
    valid = np.ones(n, bool)
    valid[-3:] = False
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return (f32(lp), f32(rp), f32(lc), f32(rc), valid), T.numpy()


def test_estimate_motion_with_jax_picks_matches_jax():
    vcfg = jcfg.VoConfig(ransac_iters=16)
    for n_out in (0, 12):
        fields, T_true = _synthetic_matches(48, n_out, seed=n_out)
        jm = jvo.QuadMatches(*map(jnp.asarray, fields))
        key = jax.random.PRNGKey(7)
        a = jvo.estimate_motion(jm, JK_, key, vcfg)
        # the samples estimate_motion draws from this key
        keys = jax.random.split(key, vcfg.ransac_iters)
        picks = jax.vmap(jvo._distinct3, in_axes=(0, None))(
            keys, jnp.sum(jm.valid))
        tm = tvo.QuadMatches(*map(torch.from_numpy, fields))
        b = tvo.estimate_motion(tm, TK, None,
                                TCFG.vo.__class__(ransac_iters=16),
                                picks=torch.from_numpy(np.array(picks)))
        np.testing.assert_allclose(to_np(b.T_delta)[:3, :3],
                                   to_np(a.T_delta)[:3, :3], atol=1e-4)
        np.testing.assert_allclose(to_np(b.T_delta)[:3, 3],
                                   to_np(a.T_delta)[:3, 3], atol=1e-3)
        np.testing.assert_array_equal(to_np(a.inliers), to_np(b.inliers))
        assert int(a.n_inliers) == int(b.n_inliers), n_out
        assert bool(a.success) and bool(b.success), n_out
        np.testing.assert_allclose(to_np(b.T_delta), T_true, atol=2e-2)


def test_estimate_motion_draws_from_generator():
    fields, T_true = _synthetic_matches(48, 6, seed=3)
    tm = tvo.QuadMatches(*map(torch.from_numpy, fields))
    gen = torch.Generator().manual_seed(0)
    res = tvo.estimate_motion(tm, TK, gen, TCFG.vo.__class__(ransac_iters=16))
    assert bool(res.success)
    np.testing.assert_allclose(to_np(res.T_delta), T_true, atol=2e-2)
    picks = tvo._distinct3(gen, torch.tensor(5), 500)
    assert int(picks.max()) < 5
    assert (picks[:, 0] != picks[:, 1]).all()
    assert (picks[:, 1] != picks[:, 2]).all()
    assert (picks[:, 0] != picks[:, 2]).all()
