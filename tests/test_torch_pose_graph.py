"""Parity of the port's pose-graph optimiser with the JAX package on a
12-vertex noisy ring with two loop edges: global (LM + PCG) poses within
1e-4, ``edge_chi2`` within 1e-5 relative (to the largest), the local
window's mask equal and its solve within 1e-4, and ``edge_residuals`` and
``_edge_jacobians`` within 1e-5 (the port differentiates in float64 by
central differences, JAX by ``jax.jacfwd`` in float32)."""

import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.backend import pose_graph as jpg
from semantic_slam_mapping_tpu.geometry import se3 as jse3
from semantic_slam_mapping_torch import config as tcfg
from semantic_slam_mapping_torch.backend import pose_graph as tpg
from torch_parity_scene import to_np

torch.set_num_threads(2)
M, N_RING, E = 16, 12, 32


def _ring(seed=3):
    """(JAX graph, port graph): a ring of radius 10 m, odometry and two
    loop edges with 0.01 noise, vertices from 0.03-noisy odometry."""
    rng = np.random.default_rng(seed)

    def pose(th):
        c, s = np.cos(th), np.sin(th)
        T = np.eye(4)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[:3, 3] = [10 - 10 * c, 0, 10 * s]
        return T

    def noisy(T, sigma):
        d = jnp.asarray(rng.normal(0, sigma, 6), jnp.float32)
        return np.asarray(jse3.exp(d), np.float64) @ T

    gt = [pose(2 * np.pi * k / N_RING) for k in range(N_RING)]
    edges = [(k, k + 1) for k in range(N_RING - 1)] + [(N_RING - 1, 0),
                                                       (N_RING - 2, 1)]
    ei, ej = np.zeros(E, np.int64), np.zeros(E, np.int64)
    eT = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    info = np.zeros(E, np.float32)
    ev, el = np.zeros(E, bool), np.zeros(E, bool)
    for e, (i, j) in enumerate(edges):
        ei[e], ej[e] = i, j
        eT[e] = noisy(np.linalg.inv(gt[i]) @ gt[j], 0.01)
        info[e], ev[e], el[e] = 100.0, True, e >= N_RING - 1
    poses = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    acc = np.eye(4)
    for k in range(N_RING):
        if k:
            acc = acc @ noisy(np.linalg.inv(gt[k - 1]) @ gt[k], 0.03)
        poses[k] = acc
    fields = (poses, np.arange(M) < N_RING, ei, ej, eT, info, ev, el)
    return (jpg.PoseGraph(*map(jnp.asarray, fields)),
            tpg.PoseGraph(*map(torch.from_numpy, fields)))


def test_global_optimize_matches_jax():
    jg, tg = _ring()
    a = jpg.optimize(jg, jpg.global_free_mask(jg), jcfg.PoseGraphConfig(),
                     iters=10)
    b = tpg.optimize(tg, tpg.global_free_mask(tg), tcfg.PoseGraphConfig(),
                     iters=10)
    np.testing.assert_array_equal(to_np(tpg.global_free_mask(tg)),
                                  to_np(jpg.global_free_mask(jg)))
    np.testing.assert_allclose(to_np(b.poses), to_np(a.poses), atol=1e-4)
    assert np.abs(to_np(a.poses) - to_np(jg.poses)).max() > 0.1  # it moved
    # edge_chi2 of the optimised graph, the same poses in both
    c_j = to_np(jpg.edge_chi2(a))
    c_t = to_np(tpg.edge_chi2(tg._replace(
        poses=torch.from_numpy(to_np(a.poses).copy()))))
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=1e-5 * c_j.max())
    assert c_j.sum() < to_np(jpg.edge_chi2(jg)).sum()
    # the same poses from two runs
    b2 = tpg.optimize(tg, tpg.global_free_mask(tg), tcfg.PoseGraphConfig(),
                      iters=10)
    assert torch.equal(b.poses, b2.poses)


def test_local_mask_residuals_and_jacobians_match_jax():
    jg, tg = _ring(seed=4)
    for n, window in ((N_RING, 5), (4, 5), (N_RING, 20)):
        np.testing.assert_array_equal(
            to_np(tpg.local_free_mask(tg, n, window)),
            to_np(jpg.local_free_mask(jg, jnp.int32(n), window)))
    jm, tm = jpg.local_free_mask(jg, jnp.int32(N_RING), 5), \
        tpg.local_free_mask(tg, N_RING, 5)
    a = jpg.optimize(jg, jm, jcfg.PoseGraphConfig(), iters=5)
    b = tpg.optimize(tg, tm, tcfg.PoseGraphConfig(), iters=5)
    np.testing.assert_allclose(to_np(b.poses), to_np(a.poses), atol=1e-4)
    # the fixed vertices move only by the final re-orthonormalisation
    np.testing.assert_allclose(to_np(b.poses)[:N_RING - 5],
                               to_np(tg.poses)[:N_RING - 5], atol=1e-6)
    np.testing.assert_allclose(to_np(tpg.edge_residuals(tg)),
                               to_np(jpg.edge_residuals(jg)), atol=1e-5)
    for x, y in zip(jpg._edge_jacobians(jg), tpg._edge_jacobians(tg)):
        np.testing.assert_allclose(to_np(y), to_np(x), atol=1e-5,
                                   rtol=1e-5)
