"""Parity of the port's descriptor matching with the JAX package, exactly:
the Hamming matrix is integer-valued, and ties (duplicated descriptors)
go to the lowest index in both, as ``lax.top_k`` and ``argmin`` do."""

import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.ops import matching as jm
from semantic_slam_mapping_torch.ops import matching as tm
from torch_parity_scene import to_np

torch.set_num_threads(2)


def _descriptors(seed):
    """Two descriptor sets with exact duplicates, near duplicates and
    invalid slots."""
    rng = np.random.default_rng(seed)
    a = (rng.random((60, 256)) < 0.5).astype(np.uint8)
    b = (rng.random((70, 256)) < 0.5).astype(np.uint8)
    b[10:20] = a[:10]          # each of a[:10] matches twice: a tie
    b[20:30] = a[:10]
    a[40:45] = a[0]            # duplicated queries
    b[30] = b[31]
    b[40:50] = a[20:30]        # near matches at 3 and 3 bits
    b[40:50, :3] ^= 1
    b[50:60] = a[20:30]
    b[50:60, 5:8] ^= 1
    b[60:70] = a[30:40]        # unique matches at 2 bits
    b[60:70, 9:11] ^= 1
    va = rng.random(60) < 0.9
    vb = rng.random(70) < 0.9
    xa = (rng.random((60, 2)) * 100).astype(np.float32)
    xb = (rng.random((70, 2)) * 100).astype(np.float32)
    return a, b, va, vb, xa, xb


def _equal(jres, tres):
    for x, y in zip(jres, tres):
        np.testing.assert_array_equal(to_np(y), to_np(x))


def test_hamming_knn2_mutual_exact():
    a, b, va, vb, _, _ = _descriptors(0)
    jd = jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                           jnp.asarray(vb))
    td = tm.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(va), torch.from_numpy(vb))
    np.testing.assert_array_equal(to_np(td), to_np(jd))
    assert (to_np(jd)[va][:, vb] == 0).sum() >= 20      # ties present
    for ratio in (0.8, 1.01):
        jk, tk = jm.knn2_ratio(jd, ratio), tm.knn2_ratio(td, ratio)
        _equal(jk, tk)
        _equal(jm.mutual_filter(jk, jd), tm.mutual_filter(tk, td))
    # a batch of query sets against one train set
    tb = tm.hamming_matrix(torch.from_numpy(np.stack([a, a[::-1]])),
                           torch.from_numpy(b))
    np.testing.assert_array_equal(
        to_np(tb[1]), to_np(jm.hamming_matrix(jnp.asarray(a[::-1]),
                                              jnp.asarray(b))))


def test_match_descriptors_and_windowed_match_exact():
    a, b, va, vb, xa, xb = _descriptors(1)
    for cross_check in (True, False):
        j = jm.match_descriptors(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(va), jnp.asarray(vb), 0.8,
                                 cross_check)
        t = tm.match_descriptors(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(va), torch.from_numpy(vb),
                                 0.8, cross_check)
        _equal(j, t)
        assert to_np(j.valid).sum() >= 5
    for du, dv, max_dist in ((30.0, 20.0, 140.0), (100.0, 100.0, 80.0)):
        j = jm.windowed_match(jnp.asarray(a), jnp.asarray(xa),
                              jnp.asarray(b), jnp.asarray(xb),
                              jnp.asarray(va), jnp.asarray(vb), du, dv,
                              max_dist)
        t = tm.windowed_match(torch.from_numpy(a), torch.from_numpy(xa),
                              torch.from_numpy(b), torch.from_numpy(xb),
                              torch.from_numpy(va), torch.from_numpy(vb),
                              du, dv, max_dist)
        _equal(j, t)
