"""Bag-of-words loop detection: a vocabulary tree and DBoW2's L1 score.

Counterpart of ``semantic_slam_mapping_tpu/backend/looper.py``. The
vocabulary is built on the host by hierarchical k-majority clustering of
binary descriptors, the same numpy code with the same ``default_rng(seed)``
draws, so the same descriptors give the same tree. A vocabulary saved by
either package loads in the other (npz keys ``level_i`` and ``idf_i``).

A descriptor's word is a tree descent, one batched Hamming argmin per
level; a keyframe's BoW is a sparse, sorted (word, weight) list; the loop
database scores a query against every stored keyframe at once.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

DESC_BITS = 256
PAD_WORD = 2 ** 30   # word id of the padding slots of a SparseBow


class Vocabulary(NamedTuple):
    """Dense vocabulary tree: ``centers[l]`` (k^(l+1), 256) uint8 in
    {0,1}, the leaves at level depth-1; ``idf_levels[l]`` (k^(l+1),) the
    inverse document frequency of every node of level l (inner nodes pool
    their subtree's counts), so BoW vectors can be formed at any level."""

    centers: Tuple[torch.Tensor, ...]
    idf_levels: Tuple[torch.Tensor, ...]

    @property
    def branching(self) -> int:
        return self.centers[0].shape[0]

    @property
    def n_leaves(self) -> int:
        return self.centers[-1].shape[0]

    @property
    def depth(self) -> int:
        return len(self.centers)

    @property
    def idf(self) -> torch.Tensor:
        return self.idf_levels[-1]

    def to(self, device: str | torch.device) -> "Vocabulary":
        return Vocabulary(tuple(c.to(device) for c in self.centers),
                          tuple(i.to(device) for i in self.idf_levels))


class SparseBow(NamedTuple):
    """Fixed-budget sparse BoW: ``idx`` (B,) word ids sorted ascending,
    PAD_WORD at the end; ``w`` (B,) L1-normalised tf-idf weights, 0 at
    padding."""

    idx: torch.Tensor
    w: torch.Tensor


def build_vocabulary(descriptors: np.ndarray, branching: int = 10,
                     depth: int = 3, seed: int = 0,
                     kmeans_iters: int = 8) -> Vocabulary:
    """Hierarchical k-majority clustering of (N, 256) {0,1} descriptors on
    the host. Empty branches get random centres so the tree stays complete.
    Returns a vocabulary of CPU tensors (``Vocabulary.to`` moves it)."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors).astype(np.uint8)
    n_total = len(desc)

    def kmajority(data: np.ndarray, k: int) -> np.ndarray:
        if len(data) == 0:
            return rng.integers(0, 2, (k, DESC_BITS)).astype(np.uint8)
        init = data[rng.choice(len(data), size=min(k, len(data)),
                               replace=False)]
        if len(init) < k:
            extra = rng.integers(0, 2, (k - len(init), DESC_BITS))
            init = np.concatenate([init, extra.astype(np.uint8)])
        centers = init.astype(np.float32)
        for _ in range(kmeans_iters):
            d = (data.sum(1)[:, None] + centers.sum(1)[None, :]
                 - 2.0 * data @ centers.T)
            assign = d.argmin(1)
            for j in range(k):
                members = data[assign == j]
                if len(members):
                    centers[j] = (members.mean(0) > 0.5)
        return centers.astype(np.uint8)

    levels = []
    groups = [desc]
    for _ in range(depth):
        centers_l = []
        next_groups = []
        for g in groups:
            c = kmajority(g, branching)
            centers_l.append(c)
            if len(g):
                d = (g.sum(1)[:, None] + c.sum(1)[None, :]
                     - 2.0 * g @ c.T.astype(np.float32))
                assign = d.argmin(1)
            else:
                assign = np.zeros(0, np.int64)
            for j in range(branching):
                next_groups.append(g[assign == j] if len(g) else g)
        levels.append(np.concatenate(centers_l, axis=0))
        groups = next_groups

    # idf at every level from the training corpus: leaf counts, pooled up
    counts = np.array([len(g) for g in groups], np.float32)
    idf_levels = []
    c = counts
    for lvl in range(depth - 1, -1, -1):
        idf_levels.append(np.log(max(n_total, 1) / np.maximum(c, 1.0)))
        if lvl:
            c = c.reshape(-1, branching).sum(axis=1)
    idf_levels.reverse()
    return Vocabulary(
        centers=tuple(torch.from_numpy(lv) for lv in levels),
        idf_levels=tuple(torch.from_numpy(np.asarray(i, np.float32))
                         for i in idf_levels))


def save_vocabulary(path: str, vocab: Vocabulary) -> None:
    """Write a vocabulary as npz (keys level_i, idf_i)."""
    data = {f"level_{i}": c.cpu().numpy() for i, c in enumerate(vocab.centers)}
    for i, idf in enumerate(vocab.idf_levels):
        data[f"idf_{i}"] = idf.cpu().numpy()
    np.savez_compressed(path, **data)


def load_vocabulary(path: str,
                    device: str | torch.device = "cpu") -> Vocabulary:
    """Read a vocabulary written by either package. A file with only the
    leaf idf (the JAX package's first format) gets flat upper levels."""
    z = np.load(path)
    levels = sorted(k for k in z.files if k.startswith("level_"))
    idfs = sorted(k for k in z.files if k.startswith("idf_"))
    centers = [z[k] for k in levels]
    if idfs:
        idf_levels = [z[k] for k in idfs]
    else:
        leaf = np.asarray(z["idf"])
        k = int(centers[0].shape[0])
        idf_levels, c = [], leaf
        for lvl in range(len(centers) - 1, -1, -1):
            idf_levels.append(c)
            if lvl:
                c = np.full(len(c) // k, float(np.mean(c)), np.float32)
        idf_levels = idf_levels[::-1]
    return Vocabulary(
        centers=tuple(torch.from_numpy(c).to(device) for c in centers),
        idf_levels=tuple(torch.from_numpy(np.asarray(i, np.float32)).to(device)
                         for i in idf_levels))


def _descend(vocab: Vocabulary, desc: torch.Tensor,
             n_levels: int) -> torch.Tensor:
    """Tree descent: (N, 256) descriptors -> node ids at level
    ``n_levels`` (1-indexed; ids in [0, k^n_levels)), one batched Hamming
    argmin over the current nodes' k children per level. The distances are
    integers, exact in float32 whatever the summation order."""
    k = vocab.branching
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    d = desc.float()
    d_sum = d.sum(dim=-1)
    children = torch.arange(k, device=desc.device)
    for centers_l in vocab.centers[:n_levels]:
        c = centers_l[node[:, None] * k + children].float()      # (N, k, 256)
        ham = (d_sum[:, None] + c.sum(dim=-1)
               - 2.0 * torch.einsum("nb,nkb->nk", d, c))
        node = node * k + torch.argmin(ham, dim=-1)
    return node


def transform(vocab: Vocabulary, desc: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Descriptors -> dense L1-normalised tf-idf BoW (n_leaves,), for small
    vocabularies; the epoch uses :func:`transform_sparse`."""
    node = _descend(vocab, desc, len(vocab.centers))
    tf = torch.zeros(vocab.n_leaves, device=desc.device).index_add_(
        0, node, valid.float())
    v = tf * vocab.idf
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def transform_sparse(vocab: Vocabulary, desc: torch.Tensor,
                     valid: torch.Tensor, scoring_level: int,
                     budget: int = 0) -> SparseBow:
    """Descriptors -> sparse L1-normalised tf-idf BoW at ``scoring_level``
    of the tree. budget: the most distinct words kept (0: one slot per
    descriptor, lossless). A word's weight is its count times its idf (the
    count is an exact integer sum, so the result is the same on every
    run)."""
    n = desc.shape[0]
    dev = desc.device
    lvl = min(scoring_level, vocab.depth)
    node = _descend(vocab, desc, lvl)
    word = torch.where(valid, node, PAD_WORD)
    s = torch.sort(word, stable=True)[0]                  # sorted word ids
    idf = vocab.idf_levels[lvl - 1]
    real = s < PAD_WORD
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       s[1:] != s[:-1]]) & real
    slot = torch.cumsum(first.long(), 0) - 1              # unique rank
    B = budget or n
    slot_c = torch.clamp(slot, 0, B - 1)
    keep = first & (slot < B)
    count = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(
        0, slot_c, (real & (slot < B)).long())
    idx = torch.full((B,), PAD_WORD, dtype=torch.int64, device=dev)
    idx = idx.scatter_reduce(0, slot_c, torch.where(keep, s, PAD_WORD),
                             reduce="amin")
    wgt = idf[torch.clamp(idx, 0, idf.shape[0] - 1)]
    w = torch.where(idx < PAD_WORD, count.float() * wgt, 0.0)
    return SparseBow(idx=idx, w=w / torch.clamp(torch.sum(w), min=1e-9))


def l1_score(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of two L1-normalised vectors, in [0, 1]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v - w), dim=-1)


def sparse_l1_scores(q: SparseBow, db_idx: torch.Tensor,
                     db_w: torch.Tensor) -> torch.Tensor:
    """L1 similarity of a sparse query against M sparse database rows
    (M, B): for L1-normalised non-negative vectors 1 - 0.5 |v - w|_1 is
    the sum over the common words of min(v_i, w_i), found by a batched
    binary search of each row's sorted word ids."""
    M = db_idx.shape[0]
    qi = q.idx.to(db_idx.dtype).expand(M, -1).contiguous()
    pos = torch.searchsorted(db_idx.contiguous(), qi)
    pos_c = torch.clamp(pos, 0, db_idx.shape[1] - 1)
    hit = (torch.gather(db_idx, 1, pos_c) == qi) & (qi < PAD_WORD)
    return torch.sum(torch.where(
        hit, torch.minimum(q.w, torch.gather(db_w, 1, pos_c)), 0.0), dim=1)


def get_possible_loops(bow: torch.Tensor, db_bows: torch.Tensor,
                       db_ids: torch.Tensor, db_valid: torch.Tensor,
                       query_id, min_score: float, min_interval: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score every stored keyframe at once (dense BoWs); candidates score
    above min_score with a frame gap above min_interval. Returns (scores
    (M,), candidate mask (M,))."""
    scores = l1_score(bow[None, :], db_bows)
    gap = torch.abs(query_id - db_ids)
    return scores, db_valid & (scores > min_score) & (gap > min_interval)


def get_possible_loops_sparse(bow: SparseBow, db_idx: torch.Tensor,
                              db_w: torch.Tensor, db_ids: torch.Tensor,
                              db_valid: torch.Tensor, query_id,
                              min_score: float, min_interval: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`get_possible_loops` over a sparse database (M, B)."""
    scores = sparse_l1_scores(bow, db_idx, db_w)
    gap = torch.abs(query_id - db_ids)
    return scores, db_valid & (scores > min_score) & (gap > min_interval)
