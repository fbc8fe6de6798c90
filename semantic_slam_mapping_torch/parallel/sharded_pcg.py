"""Edge-sharded pose-graph LM + PCG.

Counterpart of ``semantic_slam_mapping_tpu/parallel/sharded_pcg.py``. The
normal equations of ``backend/pose_graph.py`` are sums over edges: each
rank of the mesh's data axis takes a contiguous block of the edges, builds
the gather table of its block (``pose_graph.vertex_edge_table``) and sums
its edge terms into the vertices in that table's fixed order; an
all-reduce over the data axis then adds the ranks' sums. The vertex state
(M, 6) is small and replicated: one all-reduce of M*6 floats a PCG step,
one of the (M, 6, 6) blocks and one of the gradient an LM step, and the
two costs of the accept test.

It runs the single-device optimiser's body (``pose_graph._lm_optimize``)
with that all-reduce as its ``reduce_sum``, so both paths keep the same
damping and accept rule. The all-reduce adds the shards in another order
than one gather table adds all edges, so the two solves agree to float32
rounding, not to the bit; two sharded solves on one world are identical.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from semantic_slam_mapping_torch.backend import pose_graph as pg
from semantic_slam_mapping_torch.config import PoseGraphConfig
from semantic_slam_mapping_torch.parallel import mesh as pmesh


def _pad_edges(graph: pg.PoseGraph, n: int) -> pg.PoseGraph:
    """Append invalid edges (0 -> 0, identity, no information) up to a
    multiple of n."""
    pad = -graph.edge_T.shape[0] % n
    if not pad:
        return graph
    dev = graph.poses.device

    def more(x, fill):
        return torch.cat([x, fill.to(dev, x.dtype).expand(
            (pad,) + x.shape[1:])])

    zero = torch.zeros(())
    return graph._replace(
        edge_i=more(graph.edge_i, zero), edge_j=more(graph.edge_j, zero),
        edge_T=more(graph.edge_T, torch.eye(4)),
        edge_info=more(graph.edge_info, zero),
        edge_valid=more(graph.edge_valid, zero),
        edge_is_loop=more(graph.edge_is_loop, zero))


def optimize_sharded(graph: pg.PoseGraph, free_mask: torch.Tensor,
                     mesh: DeviceMesh,
                     cfg: PoseGraphConfig = PoseGraphConfig(),
                     iters: int = 10) -> pg.PoseGraph:
    """:func:`pose_graph.optimize` with the edges split over the mesh's
    data axis: rank r of n takes edges [r E/n, (r+1) E/n) of the graph
    padded with invalid edges to a multiple of n. Every rank passes the
    whole graph and gets the same poses back."""
    group = pmesh.axis_group(mesh)
    n = pmesh.axis_size(mesh)
    r = pmesh.axis_index(mesh)
    padded = _pad_edges(graph, n)
    E = padded.edge_T.shape[0] // n
    part = slice(r * E, (r + 1) * E)
    local = padded._replace(**{k: getattr(padded, k)[part]
                               for k in pg.PoseGraph._fields
                               if k.startswith("edge_")})
    M = graph.poses.shape[0]
    table = pg.vertex_edge_table(local.edge_i, local.edge_j,
                                 local.edge_valid, M)
    free = (free_mask & graph.vertex_valid).float()[:, None]
    poses = pg._lm_optimize(
        local, free, cfg, iters, table.to(graph.poses.device),
        lambda x: pmesh.all_reduce_sum(x, group))
    return graph._replace(poses=poses)
