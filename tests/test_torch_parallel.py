"""The port's mesh, edge-sharded pose-graph solve and sharded BoW scoring
against the JAX package, over gloo with 2 and 4 ranks on the CPU (the rank
bodies are in ``torch_mesh_ranks.py``).

Test 1: ``mesh_shape`` equals JAX's ``make_mesh`` (dp, tp) defaults for 1
to 8 devices; on the ranks, ``make_mesh`` gives the same shapes, names its
axes (data, model), and refuses a shape that is not the world's.
``optimize_sharded`` on ``tests/test_pose_graph.build_chain``'s 16-vertex
loop chain (2 LM steps of 16 PCG iterations, as tests/test_parallel.py)
on a (n, 1) mesh: within 1e-4 of the port's ``pose_graph.optimize`` and
of JAX's ``optimize_sharded`` on the conftest mesh's first n devices
(the all-reduce may add the shards' sums in another order than one
gather table adds a vertex's edge terms: float32 rounding); the same
poses on every rank; two runs identical to the bit; an edge count that n
does not divide (padded with invalid edges) within 1e-4 of the single
solve.

Test 2: the sparse BoW scan at M = 2048 (tests/test_sharded_bow.py's
database) and the dense one at M = 64, with the rows split over n ranks:
scores and masks equal to the port's single-device scan (each row scores
alone), within 1e-6 of JAX's sharded scan with equal masks, and the
planted revisit found.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.backend import looper as jlooper
from semantic_slam_mapping_tpu.backend import pose_graph as jpg
from semantic_slam_mapping_tpu.config import PoseGraphConfig as JCfg
from semantic_slam_mapping_tpu.parallel import mesh as jmesh
from semantic_slam_mapping_tpu.parallel import sharded_bow as jbow
from semantic_slam_mapping_tpu.parallel import sharded_pcg as jpcg
from semantic_slam_mapping_torch.backend import looper as tlooper
from semantic_slam_mapping_torch.backend import pose_graph as tpg
from semantic_slam_mapping_torch.config import PoseGraphConfig as TCfg
from semantic_slam_mapping_torch.parallel import mesh as tmesh

from tests.test_pose_graph import build_chain
from torch_mesh_ranks import run_ranks

torch.set_num_threads(2)
PCG_ITERS, ITERS = 16, 2
# build_chain's graph has 16 valid edges in 128 slots; cut to 127 slots,
# which neither 2 nor 4 divides
ODD_EDGES = 127


def test_mesh_and_sharded_pcg(tmp_path):
    for m in range(1, 9):
        for dp, tp in ((None, None), (m, 1), (None, 1), (1, None)):
            jm = jmesh.make_mesh(m, dp=dp, tp=tp)
            assert tmesh.mesh_shape(m, dp, tp) == (
                jm.shape[jmesh.DATA_AXIS], jm.shape[jmesh.MODEL_AXIS])

    g, _, nv = build_chain(jax.random.PRNGKey(1), 16, drift=0.03, loop=True)
    fields = {k: np.array(getattr(g, k)) for k in jpg.PoseGraph._fields}
    fields["edge_i"] = fields["edge_i"].astype(np.int64)
    fields["edge_j"] = fields["edge_j"].astype(np.int64)
    np.savez(tmp_path / "inputs.npz", pcg_iters=PCG_ITERS, iters=ITERS,
             odd_edges=ODD_EDGES, **fields)
    tg = tpg.PoseGraph(*(torch.from_numpy(fields[k])
                         for k in tpg.PoseGraph._fields))
    single = tpg.optimize(tg, tpg.global_free_mask(tg),
                          TCfg(pcg_iters=PCG_ITERS), iters=ITERS).poses.numpy()
    moved = np.abs(single[:nv] - fields["poses"][:nv]).max()
    assert moved > 1e-2, moved
    for n in (2, 4):
        _check_mesh_and_pcg(g, single, n, run_ranks("mesh_and_pcg", n,
                                                     tmp_path))


def _check_mesh_and_pcg(g, single, n, ranks):
    want_shapes = [[jm.shape[jmesh.DATA_AXIS], jm.shape[jmesh.MODEL_AXIS]]
                   for jm in (jmesh.make_mesh(n),
                              jmesh.make_mesh(n, dp=n, tp=1),
                              jmesh.make_mesh(n, tp=n),
                              jmesh.make_mesh(n, dp=1))]
    jsharded = np.asarray(jpcg.optimize_sharded(
        g, jpg.global_free_mask(g), jmesh.make_mesh(n, dp=n, tp=1),
        JCfg(pcg_iters=PCG_ITERS), iters=ITERS).poses)
    for out in ranks:
        assert out["shapes"].tolist() == want_shapes
        assert bool(out["refused"])
        # per LM step: the blocks, the gradient, the PCG's matvecs and the
        # two costs of the accept test
        assert out["all_reduce_calls"] == ITERS * (PCG_ITERS + 5)
        np.testing.assert_array_equal(out["poses_a"], out["poses_b"])
        np.testing.assert_array_equal(out["poses_a"], ranks[0]["poses_a"])
        np.testing.assert_allclose(out["poses_a"], single, atol=1e-4)
        np.testing.assert_allclose(out["poses_a"], jsharded, atol=1e-4)
        np.testing.assert_allclose(out["poses_odd"], single, atol=1e-4)


def _sparse_db():
    """tests/test_sharded_bow.py's 2048-row sparse database, its query
    (row 100's words), ids and valid rows."""
    rng = np.random.default_rng(1)
    M, B, n_words = 2048, 64, 100_000
    pad = int(jlooper.PAD_WORD)
    db_idx = np.full((M, B), pad, np.int64)
    db_w = np.zeros((M, B), np.float32)
    for i in range(M):
        k = rng.integers(16, B)
        db_idx[i, :k] = np.sort(rng.choice(n_words, size=k, replace=False))
        db_w[i, :k] = rng.dirichlet(np.ones(k)).astype(np.float32)
    q_idx = db_idx[100].copy()
    q_w = db_w[100] * 0.8
    q_w = (q_w / max(q_w.sum(), 1e-9)).astype(np.float32)
    ids = np.arange(M, dtype=np.int64) * 2
    valid = rng.uniform(size=M) > 0.05
    return q_idx, q_w, db_idx, db_w, ids, valid, 5000


def _dense_db():
    """tests/test_sharded_bow.py's 64-row dense database and query."""
    rng = np.random.default_rng(0)
    M, L = 64, 128
    db = rng.dirichlet(np.ones(L) * 0.1, size=M).astype(np.float32)
    q = db[7] * 0.7 + db[12] * 0.3
    q = (q / np.abs(q).sum()).astype(np.float32)
    return q, db, np.arange(M, dtype=np.int64) * 3, np.ones(M, bool), 500


def test_sharded_bow_matches_single_device(tmp_path):
    q_idx, q_w, db_idx, db_w, ids, valid, qid = _sparse_db()
    dq, ddb, dids, dvalid, dqid = _dense_db()
    np.savez(tmp_path / "inputs.npz", q_idx=q_idx, q_w=q_w, db_idx=db_idx,
             db_w=db_w, ids=ids, valid=valid, qid=qid, dense_q=dq,
             dense_db=ddb, dense_ids=dids, dense_valid=dvalid,
             dense_qid=dqid)

    t = torch.from_numpy
    s_ref, m_ref = tlooper.get_possible_loops_sparse(
        tlooper.SparseBow(t(q_idx), t(q_w)), t(db_idx), t(db_w), t(ids),
        t(valid), qid, 0.015, 60)
    ds_ref, dm_ref = tlooper.get_possible_loops(
        t(dq), t(ddb), t(dids), t(dvalid), dqid, 0.015, 60)
    for n in (2, 4):
        ranks = run_ranks("sharded_bow", n, tmp_path)
        jm = jmesh.make_mesh(n, dp=n, tp=1)
        js, jmask = jbow.get_possible_loops_sparse_sharded(
            jnp.asarray(q_idx, jnp.int32), jnp.asarray(q_w),
            jnp.asarray(db_idx, jnp.int32), jnp.asarray(db_w),
            jnp.asarray(ids, jnp.int32), jnp.asarray(valid),
            jnp.int32(qid), jm, 0.015, 60)
        jds, jdm = jbow.get_possible_loops_sharded(
            jnp.asarray(dq), jnp.asarray(ddb), jnp.asarray(dids, jnp.int32),
            jnp.asarray(dvalid), jnp.int32(dqid), jm, 0.015, 60)
        for out in ranks:
            assert out["block_rows"] == 2048 // n
            np.testing.assert_array_equal(out["scores"], s_ref.numpy())
            np.testing.assert_array_equal(out["mask"], m_ref.numpy())
            np.testing.assert_array_equal(out["dense_scores"],
                                          ds_ref.numpy())
            np.testing.assert_array_equal(out["dense_mask"], dm_ref.numpy())
            np.testing.assert_allclose(out["scores"], np.asarray(js),
                                       atol=1e-6)
            np.testing.assert_array_equal(out["mask"], np.asarray(jmask))
            np.testing.assert_allclose(out["dense_scores"], np.asarray(jds),
                                       atol=1e-6)
            np.testing.assert_array_equal(out["dense_mask"], np.asarray(jdm))
            assert out["mask"][100]
