"""The voxel map split into X slabs over the mesh, with a halo exchange.

Counterpart of ``semantic_slam_mapping_tpu/parallel/sharded_map.py``. The
world's X range [-x_extent, x_extent) is cut into one equal slab per rank
of the mesh's data axis. Each rank holds its slab's voxels in fixed-budget
arrays (:class:`ShardedVoxelMap`, the rank's row of the JAX package's
(n_dev, budget) state). A fusion step on every rank:

1. keeps the points of the (replicated) cloud that fall in its slab and
   quantizes them into the slab's grid, whose X has one halo column on
   each side;
2. merges them with its voxels: concatenate, stable sort by key,
   run-unique (the first entry of a run keeps its position, colour and
   label; the counts add), at most ``budget`` voxels, the smallest keys;
3. sends the keys of its first interior column to the rank before it and
   those of its last to the rank after it, remapped into their halo
   columns (a ring: slab 0 and slab n-1 are neighbours, and with n = 1 a
   slab is its own);
4. keeps a voxel when at least ``min_support`` of its six neighbours are
   occupied, here or in the halo.

Keys are int64: at the default 0.1 m leaf and x_extent 64 they reach
1282**3, just under int32's limit. The support count looks each neighbour
up in the sorted occupied and halo keys (``searchsorted``), in memory of
the budget's size where the JAX package scatters into a dense grid of
gx*gy*gz cells (2.1 GB on a world of one at those settings).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from semantic_slam_mapping_torch.mapping.mapper import write_pcd
from semantic_slam_mapping_torch.parallel import mesh as pmesh

INVALID_KEY = torch.iinfo(torch.int64).max


class ShardedVoxelMap(NamedTuple):
    """One rank's voxel set: (budget,) entries, invalid ones keyed
    INVALID_KEY and zero."""

    keys: torch.Tensor    # int64 packed voxel key within the slab grid
    xyz: torch.Tensor     # (budget, 3) float32
    rgb: torch.Tensor     # (budget, 3) float32
    label: torch.Tensor   # int32 semantic class
    count: torch.Tensor   # float32 observations per voxel
    valid: torch.Tensor   # bool


def _device(mesh: DeviceMesh) -> torch.device:
    return torch.device(mesh.device_type)


def empty_map(mesh: DeviceMesh, budget: int) -> ShardedVoxelMap:
    """This rank's empty slab on the mesh's device."""
    dev = _device(mesh)
    return ShardedVoxelMap(
        keys=torch.full((budget,), INVALID_KEY, dtype=torch.int64,
                        device=dev),
        xyz=torch.zeros((budget, 3), device=dev),
        rgb=torch.zeros((budget, 3), device=dev),
        label=torch.zeros(budget, dtype=torch.int32, device=dev),
        count=torch.zeros(budget, device=dev),
        valid=torch.zeros(budget, dtype=torch.bool, device=dev))


def slab_grid(n: int, resolution: float, x_extent: float
              ) -> Tuple[float, int, int, int]:
    """(slab width, gx, gy, gz) of a slab's grid for n slabs: gx covers
    the slab plus a halo column on each side."""
    slab_w = 2.0 * x_extent / n
    gx = int(np.ceil(slab_w / resolution)) + 2
    gy = gz = int(np.ceil(2.0 * x_extent / resolution)) + 2
    return slab_w, gx, gy, gz


def fuse_cloud(state: ShardedVoxelMap, xyz: torch.Tensor, rgb: torch.Tensor,
               valid: torch.Tensor, mesh: DeviceMesh, budget: int = 1 << 15,
               resolution: float = 0.2, x_extent: float = 64.0,
               min_support: int = 1, label: Optional[torch.Tensor] = None
               ) -> ShardedVoxelMap:
    """Fuse a world-frame cloud (N, 3), (N, 3), (N,) given to every rank
    into this rank's slab, and re-filter the slab by neighbour support
    across the halo. Points outside [-x_extent, x_extent) in any axis are
    dropped (the reference's bounded map radius)."""
    n = pmesh.axis_size(mesh)
    r = pmesh.axis_index(mesh)
    slab_w, gx, gy, gz = slab_grid(n, resolution, x_extent)
    plane = gy * gz
    dev = state.keys.device
    f32 = np.float32
    # float32 as the JAX body computes them; XLA turns the division by
    # the static resolution into a product with its float32 reciprocal
    x0 = float(f32(-x_extent) + f32(slab_w) * f32(r))
    x1 = float(f32(x0) + f32(slab_w))
    ext = float(f32(x_extent))
    inv = float(f32(1.0) / f32(resolution))
    pts = xyz.to(dev, torch.float32)
    if label is None:
        label = torch.zeros(pts.shape[0], dtype=torch.int32, device=dev)

    # ---- ownership and quantization into the slab's grid ----
    own = (valid.to(dev, torch.bool) & (pts[:, 0] >= x0) & (pts[:, 0] < x1)
           & (pts[:, 1].abs() < ext) & (pts[:, 2].abs() < ext))
    lim = torch.tensor([gx - 1, gy - 1, gz - 1], device=dev)
    q = torch.floor(torch.stack([(pts[:, 0] - x0) * inv,
                                 (pts[:, 1] + ext) * inv,
                                 (pts[:, 2] + ext) * inv], dim=-1)) + 1.0
    q = torch.minimum(torch.clamp(q.to(torch.int64), min=0), lim)
    key = torch.where(own, (q[:, 0] * gy + q[:, 1]) * gz + q[:, 2],
                      INVALID_KEY)

    # ---- merge with the slab's voxels: concat, sort, run-unique ----
    all_keys = torch.cat([state.keys, key])
    order = torch.argsort(all_keys, stable=True)
    ks = all_keys[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       ks[1:] != ks[:-1]])
    uniq = first & (ks != INVALID_KEY)
    run_id = torch.cumsum(first.long(), 0) - 1
    all_cnt = torch.cat([state.count, own.float()])[order]
    run_cnt = torch.zeros(ks.shape[0], device=dev).index_add_(0, run_id,
                                                              all_cnt)
    rank = torch.cumsum(uniq.long(), 0) - 1
    # entries that are not a kept run's first go to the spare row `budget`
    slot = torch.where(uniq & (rank < budget), rank, budget)

    def place(fill, values):
        out = torch.full((budget + 1,) + values.shape[1:], fill,
                         dtype=values.dtype, device=dev)
        out[slot] = values
        return out[:budget]

    keys_n = place(INVALID_KEY, ks)
    xyz_n = place(0.0, torch.cat([state.xyz, pts])[order])
    rgb_n = place(0.0, torch.cat([state.rgb, rgb.to(dev, torch.float32)])
                  [order])
    lbl_n = place(0, torch.cat([state.label, label.to(dev, torch.int32)])
                  [order])
    cnt_n = place(0.0, run_cnt[run_id])
    valid_n = keys_n != INVALID_KEY

    # ---- halo exchange of the border columns' keys ----
    kx = torch.where(valid_n, keys_n, 0) // plane
    shift = (gx - 2) * plane
    # the last interior column appears as column 0 of the next slab, the
    # first as column gx-1 of the previous one
    to_next = torch.where(valid_n & (kx == gx - 2), keys_n - shift,
                          INVALID_KEY)
    to_prev = torch.where(valid_n & (kx == 1), keys_n + shift, INVALID_KEY)
    from_prev, from_next = pmesh.ring_exchange(to_next, to_prev,
                                               pmesh.axis_group(mesh))

    # ---- neighbour support (6-neighbourhood) ----
    occupied = torch.sort(torch.cat([keys_n, from_prev, from_next]))[0]
    offs = torch.tensor([plane, -plane, gz, -gz, 1, -1], device=dev)
    nb = torch.clamp(torch.where(valid_n, keys_n, 0)[:, None] + offs, 0,
                     gx * gy * gz - 1)
    pos = torch.clamp(torch.searchsorted(occupied, nb), max=occupied.numel()
                      - 1)
    support = (occupied[pos] == nb).sum(dim=-1)
    keep = valid_n & (support >= min_support)

    return ShardedVoxelMap(
        keys=torch.where(keep, keys_n, INVALID_KEY),
        xyz=torch.where(keep[:, None], xyz_n, 0.0),
        rgb=torch.where(keep[:, None], rgb_n, 0.0),
        label=torch.where(keep, lbl_n, 0),
        count=torch.where(keep, cnt_n, 0.0),
        valid=keep)


def gather_state(state: ShardedVoxelMap, mesh: DeviceMesh
                 ) -> ShardedVoxelMap:
    """Every rank's slab, stacked (n, budget, ...) in slab order, on every
    rank (the JAX package's global state)."""
    group = pmesh.axis_group(mesh)
    n = pmesh.axis_size(mesh)
    return ShardedVoxelMap(*(
        pmesh.all_gather(x, group).reshape((n,) + x.shape) for x in state))


def gather_map(state: ShardedVoxelMap, mesh: DeviceMesh
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The whole map on the host of every rank: (xyz (M, 3), rgb (M, 3),
    label (M,)) of the valid voxels, slab by slab."""
    full = gather_state(state, mesh)
    v = full.valid.reshape(-1).cpu().numpy()
    return (full.xyz.reshape(-1, 3).cpu().numpy()[v],
            full.rgb.reshape(-1, 3).cpu().numpy()[v],
            full.label.reshape(-1).cpu().numpy()[v])


class ShardedGlobalMap:
    """The mesh-mode map of ``SlamSystem`` with the host maps' interface
    (insert, clear, len, as_arrays, save_pcd): clouds fuse into the
    slab-sharded map on the mesh's devices with min_support 0 (every
    observed voxel stays, as in the host maps); the export and the length
    gather to every rank. Unlike the host maps' running means, a
    voxel's position, colour and label are its first observation's, and
    each rank keeps at most ``budget`` voxels and fuses at most
    ``pad_points`` points of a cloud (the first ones)."""

    def __init__(self, mesh: DeviceMesh, resolution: float,
                 budget: int = 1 << 15, x_extent: float = 64.0,
                 pad_points: int = 1 << 16):
        self.mesh = mesh
        self.resolution = float(resolution)
        self.budget = budget
        self.x_extent = float(x_extent)
        self.pad_points = pad_points
        self.state = empty_map(mesh, budget)

    def insert(self, xyz, rgb, label=None, valid=None):
        P = self.pad_points
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)[:P]
        n = len(xyz)
        cloud = {"xyz": np.zeros((P, 3), np.float32),
                 "rgb": np.zeros((P, 3), np.float32),
                 "label": np.zeros(P, np.int32),
                 "valid": np.zeros(P, bool)}
        cloud["xyz"][:n] = xyz
        cloud["rgb"][:n] = np.asarray(rgb, np.float32).reshape(-1, 3)[:n]
        cloud["valid"][:n] = (True if valid is None
                              else np.asarray(valid).astype(bool)[:n])
        if label is not None:
            cloud["label"][:n] = np.asarray(label)[:n]
        dev = self.state.keys.device
        t = {k: torch.from_numpy(v).to(dev) for k, v in cloud.items()}
        self.state = fuse_cloud(
            self.state, t["xyz"], t["rgb"], t["valid"], self.mesh,
            budget=self.budget, resolution=self.resolution,
            x_extent=self.x_extent, min_support=0, label=t["label"])

    def clear(self):
        self.state = empty_map(self.mesh, self.budget)

    def __len__(self) -> int:
        return int(pmesh.all_reduce_sum(self.state.valid.sum(),
                                        pmesh.axis_group(self.mesh)))

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return gather_map(self.state, self.mesh)

    def save_pcd(self, path: str, binary: bool = True):
        xyz, rgb, _ = gather_map(self.state, self.mesh)
        write_pcd(path, xyz, rgb, binary=binary)
