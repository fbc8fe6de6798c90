"""SE(3) pose-graph optimisation: Levenberg-Marquardt with Huber weights
and a matrix-free, block-Jacobi-preconditioned conjugate-gradient solve.

Counterpart of ``semantic_slam_mapping_tpu/backend/pose_graph.py``. Edge
residuals are r = log(T_meas^-1 T_i^-1 T_j). The JAX package takes their
Jacobians with respect to left perturbations of T_i and T_j from
``jax.jacfwd``; here they are central differences of the same function
in float64, one batched evaluation for all edges and all 24 perturbed
arguments, rounded to float32 (the float64 step error, about 1e-10, is
far below float32 rounding). Fixed vertices are masked out (g2o's
``setFixed``).

The block diagonal, the PCG matvec and the gradient sum edge terms into
vertices. ``index_add_`` on CUDA adds with atomics, in an order that varies
from run to run, and LM keeps or rejects a whole step on a comparison of
two costs, so one rounding difference could flip a step. Here each vertex
sums its incident edge terms through a fixed gather table (edge terms in
edge order, i-sides first, as the JAX scatter adds them) and a reduction
over the table's rows: the same graph gives the same poses on every run.

``_lm_optimize`` is the one optimiser body of the single-device and the
edge-sharded solve (``parallel/sharded_pcg.py``): its ``reduce_sum`` sums
the vertex sums and the cost over the edge shards, the identity here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from semantic_slam_mapping_torch.config import PoseGraphConfig
from semantic_slam_mapping_torch.geometry import se3


class PoseGraph(NamedTuple):
    """Fixed-budget pose graph (M vertex slots, E edge slots)."""

    poses: torch.Tensor         # (M, 4, 4) T_w_c per keyframe
    vertex_valid: torch.Tensor  # (M,) bool
    edge_i: torch.Tensor        # (E,) int64 source vertex
    edge_j: torch.Tensor        # (E,) int64 target vertex
    edge_T: torch.Tensor        # (E, 4, 4) measured T_i^-1 T_j
    edge_info: torch.Tensor     # (E,) information weight
    edge_valid: torch.Tensor    # (E,) bool
    edge_is_loop: torch.Tensor  # (E,) bool


def edge_residuals(graph: PoseGraph) -> torch.Tensor:
    """(E, 6) residuals r_e = log(T_meas^-1 T_i^-1 T_j)."""
    Ti = graph.poses[graph.edge_i]
    Tj = graph.poses[graph.edge_j]
    rel = se3.inverse(Ti) @ Tj
    return se3.log(se3.inverse(graph.edge_T) @ rel)


def edge_chi2(graph: PoseGraph) -> torch.Tensor:
    """(E,) information-weighted squared residual per edge."""
    r = edge_residuals(graph)
    return graph.edge_info * torch.sum(r * r, dim=-1)


# central-difference step of the float64 edge Jacobians
_FD_STEP = 1e-6


def _edge_jacobians(graph: PoseGraph
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residuals and Jacobians wrt left perturbations of T_i and T_j of
    r(d_i, d_j) = log(T_meas^-1 (exp(d_i) T_i)^-1 exp(d_j) T_j).
    Returns (r (E, 6), J_i (E, 6, 6), J_j (E, 6, 6))."""
    Ti = graph.poses[graph.edge_i].double()
    Tj = graph.poses[graph.edge_j].double()
    inv_Tm = se3.inverse(graph.edge_T.double())
    # 25 arguments per edge: (d_i, d_j) = 0, then +-h along each of the 12
    steps = torch.zeros(25, 12, dtype=torch.float64, device=Ti.device)
    k = torch.arange(12, device=Ti.device)
    steps[1 + 2 * k, k] = _FD_STEP
    steps[2 + 2 * k, k] = -_FD_STEP
    A = se3.exp(steps[:, :6]) @ Ti[:, None]                  # (E, 25, 4, 4)
    B = se3.exp(steps[:, 6:]) @ Tj[:, None]
    r = se3.log(inv_Tm[:, None] @ (se3.inverse(A) @ B))      # (E, 25, 6)
    J = (r[:, 1::2] - r[:, 2::2]) / (2.0 * _FD_STEP)         # (E, 12, 6)
    J = J.transpose(1, 2).float()
    return r[:, 0].float(), J[..., :6], J[..., 6:]


def _robust_weights(r: torch.Tensor, info: torch.Tensor,
                    delta: float) -> torch.Tensor:
    """Huber IRLS weight per edge (multiplies the information)."""
    rn = torch.sqrt(torch.sum(r * r, dim=-1) * info + 1e-12)
    return info * torch.clamp(delta / torch.clamp(rn, min=1e-9), max=1.0)


def vertex_edge_table(edge_i, edge_j, edge_valid,
                      n_vertices: int) -> torch.Tensor:
    """(M, D) int64 gather table of the edge terms each vertex sums: rows
    [0, E) are the i-sides of the edges, [E, 2E) their j-sides and 2E a
    zero row that pads every vertex to the largest degree D. Built on the
    host from the edge lists (numpy arrays or tensors)."""
    ei, ej, ev = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                  for x in (edge_i, edge_j, edge_valid))
    E = ei.shape[0]
    keys = np.concatenate([np.where(ev, ei, -1), np.where(ev, ej, -1)])
    rows = [np.nonzero(keys == v)[0] for v in range(n_vertices)]
    D = max(1, max(len(r) for r in rows))
    table = np.full((n_vertices, D), 2 * E, np.int64)
    for v, r in enumerate(rows):
        table[v, :len(r)] = r
    return torch.from_numpy(table)


def _vertex_sum(table: torch.Tensor, at_i: torch.Tensor,
                at_j: torch.Tensor) -> torch.Tensor:
    """Sum edge terms (E, ...) at their i- and j-vertices -> (M, ...), in
    the table's fixed order."""
    pad = torch.zeros((1,) + at_i.shape[1:], dtype=at_i.dtype,
                      device=at_i.device)
    return torch.cat([at_i, at_j, pad])[table].sum(dim=1)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _lm_optimize(graph: PoseGraph, free: torch.Tensor,
                 cfg: PoseGraphConfig, iters: int, table: torch.Tensor,
                 reduce_sum: Callable = _identity
                 ) -> torch.Tensor:
    """LM + PCG over the free vertices; returns the (M, 4, 4) poses.
    ``reduce_sum`` sums what the edges scatter into the vertices (the
    block diagonal, the matvec, the gradient) and the cost across edge
    shards, where the JAX body applies it: the identity on one device, an
    all-reduce over the mesh's data axis for a shard of the edges."""
    dev = graph.poses.device
    M = graph.poses.shape[0]
    ei, ej = graph.edge_i, graph.edge_j
    eye6 = torch.eye(6, device=dev)
    valid_f = graph.edge_valid.float()

    def robust_cost(poses):
        r = edge_residuals(graph._replace(poses=poses))
        rn2 = graph.edge_info * torch.sum(r * r, dim=-1)
        rn = torch.sqrt(rn2 + 1e-12)
        d = cfg.huber_delta
        c = torch.where(rn <= d, rn2, 2.0 * d * rn - d * d)
        return reduce_sum(torch.sum(torch.where(graph.edge_valid, c, 0.0)))

    poses = graph.poses
    lam = torch.tensor(1e-2, device=dev)
    for _ in range(iters):
        r, J_i, J_j = _edge_jacobians(graph._replace(poses=poses))
        w = _robust_weights(r, graph.edge_info, cfg.huber_delta) * valid_f

        # block-Jacobi diagonal (also the LM damping metric)
        Hi = torch.einsum("eri,erj->eij", J_i, J_i * w[:, None, None])
        Hj = torch.einsum("eri,erj->eij", J_j, J_j * w[:, None, None])
        blocks = reduce_sum(_vertex_sum(table, Hi, Hj))
        diag = torch.diagonal(blocks, dim1=-2, dim2=-1)          # (M, 6)

        def matvec(x, lam=lam, w=w, J_i=J_i, J_j=J_j, diag=diag):
            """(J^T W J + lam diag) x over the free vertices."""
            xf = x * free
            y = (torch.einsum("erk,ek->er", J_i, xf[ei])
                 + torch.einsum("erk,ek->er", J_j, xf[ej])) * w[:, None]
            out = reduce_sum(_vertex_sum(
                table, torch.einsum("erk,er->ek", J_i, y),
                torch.einsum("erk,er->ek", J_j, y)))
            damp = lam * (diag + 1e-6) * xf
            return (out + damp + 1e-6 * x) * free

        # gradient b = -J^T W r
        wr = r * w[:, None]
        b = -reduce_sum(_vertex_sum(
            table, torch.einsum("erk,er->ek", J_i, wr),
            torch.einsum("erk,er->ek", J_j, wr))) * free

        pre_blocks = (blocks + (lam * (diag + 1e-6))[:, :, None] * eye6
                      + 1e-5 * eye6)
        pre = torch.linalg.inv_ex(pre_blocks)[0]

        def apply_pre(v, pre=pre):
            return torch.einsum("mij,mj->mi", pre, v) * free

        # ---- PCG ----
        x = torch.zeros((M, 6), device=dev)
        rr = b - matvec(x)
        z = apply_pre(rr)
        p = z
        for _ in range(cfg.pcg_iters):
            Ap = matvec(p)
            rz = torch.sum(rr * z)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-12)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z_new = apply_pre(rr)
            beta = torch.sum(rr * z_new) / torch.clamp(rz, min=1e-12)
            p = z_new + beta * p
            z = z_new

        dx = torch.clamp(x, -1.0, 1.0)     # trust region on the se3 step
        cand = se3.exp(dx) @ poses
        cand = torch.where((free > 0)[..., None], cand, poses)
        # accept/reject: only cost-decreasing steps are kept
        accept = robust_cost(cand) < robust_cost(poses)
        poses = torch.where(accept, cand, poses)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-6),
                          torch.clamp(lam * 8.0, max=1e4))
    return se3.orthonormalize(poses)


def optimize(graph: PoseGraph, free_mask: torch.Tensor,
             cfg: PoseGraphConfig = PoseGraphConfig(), iters: int = 10,
             table: Optional[torch.Tensor] = None) -> PoseGraph:
    """LM + PCG pose-graph solve. free_mask (M,): the vertices allowed to
    move. ``table`` is :func:`vertex_edge_table` of the graph; given None
    it is built from the graph's edge lists, which reads them back to the
    host (a callers that keeps its graph on the host passes it)."""
    if table is None:
        table = vertex_edge_table(graph.edge_i, graph.edge_j,
                                  graph.edge_valid, graph.poses.shape[0])
    free = (free_mask & graph.vertex_valid).float()[:, None]
    poses = _lm_optimize(graph, free, cfg, iters,
                         table.to(graph.poses.device))
    return graph._replace(poses=poses)


def local_free_mask(graph: PoseGraph, n_vertices: int,
                    window: int) -> torch.Tensor:
    """Free only the last ``window`` valid vertices; vertex 0 stays fixed
    even when the window covers the whole graph (the gauge)."""
    idx = torch.arange(graph.poses.shape[0], device=graph.poses.device)
    return (idx >= max(int(n_vertices) - window, 1)) & (idx < int(n_vertices))


def global_free_mask(graph: PoseGraph) -> torch.Tensor:
    """All valid vertices free except vertex 0."""
    idx = torch.arange(graph.poses.shape[0], device=graph.poses.device)
    return graph.vertex_valid & (idx != 0)
