"""Parity of the port's BoW loop detection with the JAX package: the
vocabulary is built bit-identically from the same descriptors (the same
numpy code and ``default_rng`` draws), a vocabulary saved by JAX loads in
the port and one saved by the port loads in JAX; ``transform_sparse`` word
ids are exact and weights within 1e-6; database scores within 1e-6 and
candidate masks exact."""

import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.backend import looper as jlp
from semantic_slam_mapping_torch.backend import looper as tlp
from torch_parity_scene import to_np

torch.set_num_threads(2)


def _corpus(seed=0, n=600):
    """Descriptors clustered around 40 prototypes with 5% bit noise."""
    rng = np.random.default_rng(seed)
    base = (rng.random((40, 256)) < 0.5).astype(np.uint8)
    desc = base[rng.integers(0, 40, n)]
    return (desc ^ (rng.random(desc.shape) < 0.05)).astype(np.uint8)


def _same_vocab(a, b):
    assert len(a.centers) == len(b.centers)
    for x, y in zip(a.centers + a.idf_levels, b.centers + b.idf_levels):
        np.testing.assert_array_equal(to_np(x), to_np(y))


def test_build_vocabulary_and_files_match_jax(tmp_path):
    desc = _corpus()
    for branching, depth, seed in ((6, 3, 0), (4, 4, 5)):
        jv = jlp.build_vocabulary(desc, branching=branching, depth=depth,
                                  seed=seed)
        tv = tlp.build_vocabulary(desc, branching=branching, depth=depth,
                                  seed=seed)
        _same_vocab(jv, tv)
    jlp.save_vocabulary(str(tmp_path / "jax.npz"), jv)
    _same_vocab(jv, tlp.load_vocabulary(str(tmp_path / "jax.npz")))
    tlp.save_vocabulary(str(tmp_path / "port.npz"), tv)
    _same_vocab(jlp.load_vocabulary(str(tmp_path / "port.npz")), tv)


def test_transform_sparse_and_loop_scores_match_jax():
    desc = _corpus(1)
    jv = jlp.build_vocabulary(desc, branching=6, depth=3)
    tv = tlp.build_vocabulary(desc, branching=6, depth=3)
    rng = np.random.default_rng(2)
    valid = rng.random(100) < 0.9
    for level, budget in ((2, 0), (3, 0), (3, 16), (5, 0)):
        a = jlp.transform_sparse(jv, jnp.asarray(desc[:100]),
                                 jnp.asarray(valid), level, budget)
        b = tlp.transform_sparse(tv, torch.from_numpy(desc[:100]),
                                 torch.from_numpy(valid), level, budget)
        np.testing.assert_array_equal(to_np(b.idx), to_np(a.idx))
        np.testing.assert_allclose(to_np(b.w), to_np(a.w), atol=1e-6)
    # the dense form and its scan
    dense_j = [jlp.transform(jv, jnp.asarray(desc[i:i + 100]),
                             jnp.asarray(valid)) for i in (0, 100, 300)]
    dense_t = [tlp.transform(tv, torch.from_numpy(desc[i:i + 100]),
                             torch.from_numpy(valid)) for i in (0, 100, 300)]
    for a, b in zip(dense_j, dense_t):
        np.testing.assert_allclose(to_np(b), to_np(a), atol=1e-6)
    js, jm = jlp.get_possible_loops(dense_j[0], jnp.stack(dense_j),
                                    jnp.asarray([0, 50, 90]),
                                    jnp.asarray([True, True, True]),
                                    jnp.int32(95), 0.1, 20)
    ts, tm = tlp.get_possible_loops(dense_t[0], torch.stack(dense_t),
                                    torch.tensor([0, 50, 90]),
                                    torch.tensor([True, True, True]),
                                    95, 0.1, 20)
    np.testing.assert_allclose(to_np(ts), to_np(js), atol=1e-6)
    np.testing.assert_array_equal(to_np(tm), to_np(jm))

    # a database of 8 keyframes (one padding row), queried by keyframe 0
    rows = [(desc[i * 50:(i + 1) * 50], np.ones(50, bool)) for i in range(8)]
    jdb = [jlp.transform_sparse(jv, jnp.asarray(d), jnp.asarray(v), 3)
           for d, v in rows]
    tdb = [tlp.transform_sparse(tv, torch.from_numpy(d), torch.from_numpy(v),
                                3) for d, v in rows]
    ids, db_valid = np.arange(8) * 10, np.arange(8) < 7
    for query_id, min_interval in ((75, 20), (5, 0)):
        js, jm = jlp.get_possible_loops_sparse(
            jdb[0], jnp.stack([r.idx for r in jdb]),
            jnp.stack([r.w for r in jdb]), jnp.asarray(ids),
            jnp.asarray(db_valid), jnp.int32(query_id), 0.3, min_interval)
        ts, tm = tlp.get_possible_loops_sparse(
            tdb[0], torch.stack([r.idx for r in tdb]),
            torch.stack([r.w for r in tdb]), torch.from_numpy(ids),
            torch.from_numpy(db_valid), query_id, 0.3, min_interval)
        np.testing.assert_allclose(to_np(ts), to_np(js), atol=1e-6)
        np.testing.assert_array_equal(to_np(tm), to_np(jm))
        assert 0 < to_np(jm).sum() < 7
