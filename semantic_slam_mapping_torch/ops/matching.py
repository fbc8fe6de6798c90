"""Descriptor matching: Hamming distances as a matmul, the two-nearest
ratio test, the mutual check and the window-constrained nearest neighbour.

Counterpart of ``semantic_slam_mapping_tpu/ops/matching.py``. For bit
vectors a, b in {0,1}^256, hamming(a, b) = |a| + |b| - 2 a.b, so one
matmul gives the whole distance matrix. Its entries are integers up to 256,
exact in float16 (on the card, where the tensor cores take it) and float32
(on the CPU) alike. Every function takes optional leading batch dimensions,
which broadcast between the two descriptor sets.

Ties go to the lowest index, as ``lax.top_k`` and ``argmin`` do in the JAX
package: the best match is the first minimum and the second distance is
the minimum of the row without that entry.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

BIG = 1 << 14  # sentinel distance for invalid entries (> any Hamming dist)


class Matches(NamedTuple):
    """For each query i: index into the train set (or -1), its distance,
    and whether it passed the gates."""

    idx: torch.Tensor     # (..., N) int64
    dist: torch.Tensor    # (..., N) float32
    valid: torch.Tensor   # (..., N) bool


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor,
                   valid_a: Optional[torch.Tensor] = None,
                   valid_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., N, B) x (..., M, B) {0,1} descriptors -> (..., N, M) float32
    Hamming distances; invalid rows and columns get BIG."""
    mm = torch.float16 if desc_a.device.type == "cuda" else torch.float32
    dot = torch.matmul(desc_a.to(mm), desc_b.to(mm).transpose(-1, -2))
    sa = desc_a.sum(dim=-1, dtype=torch.int32).float()
    sb = desc_b.sum(dim=-1, dtype=torch.int32).float()
    d = sa[..., :, None] + sb[..., None, :] - 2.0 * dot.float()
    if valid_a is not None:
        d = torch.where(valid_a[..., :, None], d, float(BIG))
    if valid_b is not None:
        d = torch.where(valid_b[..., None, :], d, float(BIG))
    return d


def knn2_ratio(dist: torch.Tensor, ratio: float = 0.8,
               max_dist: float = 256.0) -> Matches:
    """Best and second-best per row with Lowe's ratio test: accept iff
    d1 < ratio * d2."""
    d1, best = torch.min(dist, dim=-1)
    d2 = torch.min(dist.scatter(-1, best[..., None], float("inf")), dim=-1)[0]
    ok = (d1 < ratio * d2) & (d1 < max_dist)
    return Matches(idx=torch.where(ok, best, -1), dist=d1, valid=ok)


def mutual_filter(fwd: Matches, dist: torch.Tensor) -> Matches:
    """Keep only mutual best matches (cross-check)."""
    back_best = torch.argmin(dist, dim=-2)    # best query of each train col
    rows = torch.arange(fwd.idx.shape[-1], device=dist.device)
    safe_idx = torch.clamp(fwd.idx, 0, dist.shape[-1] - 1)
    mutual = torch.gather(back_best, -1, safe_idx) == rows
    ok = fwd.valid & mutual
    return Matches(idx=torch.where(ok, fwd.idx, -1), dist=fwd.dist, valid=ok)


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      ratio: float = 0.8,
                      cross_check: bool = True) -> Matches:
    """Hamming matrix -> two-nearest ratio test -> optional mutual check."""
    d = hamming_matrix(desc_a, desc_b, valid_a, valid_b)
    m = knn2_ratio(d, ratio)
    return mutual_filter(m, d) if cross_check else m


def windowed_match(desc_a: torch.Tensor, xy_a: torch.Tensor,
                   desc_b: torch.Tensor, xy_b: torch.Tensor,
                   valid_a: torch.Tensor, valid_b: torch.Tensor,
                   du: float, dv: float, max_dist: float = 80.0) -> Matches:
    """Window-constrained nearest neighbour: candidate j must satisfy
    |u_a - u_b| <= du and |v_a - v_b| <= dv."""
    d = hamming_matrix(desc_a, desc_b, valid_a, valid_b)
    in_win = ((torch.abs(xy_a[..., :, None, 0] - xy_b[..., None, :, 0]) <= du)
              & (torch.abs(xy_a[..., :, None, 1] - xy_b[..., None, :, 1])
                 <= dv))
    d = torch.where(in_win, d, float(BIG))
    dist, best = torch.min(d, dim=-1)
    ok = dist < max_dist
    return Matches(idx=torch.where(ok, best, -1), dist=dist, valid=ok)
