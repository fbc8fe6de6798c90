"""Keyframe-sharded BoW loop-candidate scoring.

Counterpart of ``semantic_slam_mapping_tpu/parallel/sharded_bow.py``. The
loop search scores the query against every stored keyframe; here the
database's rows are split over the mesh's data axis, each rank scores its
block of rows with the single-device scorer, and one all-gather returns
the (M,) scores and candidate mask to every rank. The query is
replicated; the database stays where it is.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from semantic_slam_mapping_torch.backend import looper
from semantic_slam_mapping_torch.parallel import mesh as pmesh


def shard_database(rows: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the database's rows (M must be a multiple of
    the data axis's size: pad with empty rows)."""
    n = pmesh.axis_size(mesh)
    M = rows.shape[0]
    if M % n:
        raise ValueError(f"{M} database rows do not split over {n} ranks")
    r = pmesh.axis_index(mesh)
    return rows[r * (M // n):(r + 1) * (M // n)]


def _gather_scores(scores: torch.Tensor, mask: torch.Tensor,
                   mesh: DeviceMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank's (M/n,) scores and mask to the whole (M,), in one
    all-gather (the mask travels as 0.0/1.0 beside the scores)."""
    both = pmesh.all_gather(torch.stack([scores, mask.to(scores.dtype)],
                                        dim=1), pmesh.axis_group(mesh))
    return both[:, 0], both[:, 1] > 0


def get_possible_loops_sharded(bow: torch.Tensor, db_bows: torch.Tensor,
                               db_ids: torch.Tensor, db_valid: torch.Tensor,
                               query_id, mesh: DeviceMesh, min_score: float,
                               min_interval: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`looper.get_possible_loops` over the database's rows split
    across the mesh's data axis."""
    s, m = looper.get_possible_loops(
        bow, shard_database(db_bows, mesh), shard_database(db_ids, mesh),
        shard_database(db_valid, mesh), query_id, min_score, min_interval)
    return _gather_scores(s, m, mesh)


def get_possible_loops_sparse_sharded(
        q_idx: torch.Tensor, q_w: torch.Tensor,
        db_idx: torch.Tensor, db_w: torch.Tensor,
        db_ids: torch.Tensor, db_valid: torch.Tensor,
        query_id, mesh: DeviceMesh, min_score: float, min_interval: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`looper.get_possible_loops_sparse` over the sparse database's
    (M, B) rows split across the mesh's data axis: each rank scores its
    rows by the intersection of sorted word ids
    (``looper.sparse_l1_scores``), O(budget) memory a row whatever the
    vocabulary's size."""
    s, m = looper.get_possible_loops_sparse(
        looper.SparseBow(q_idx, q_w), shard_database(db_idx, mesh),
        shard_database(db_w, mesh), shard_database(db_ids, mesh),
        shard_database(db_valid, mesh), query_id, min_score, min_interval)
    return _gather_scores(s, m, mesh)
