"""The (data, model) device mesh and the collectives of the sharded paths.

Counterpart of ``semantic_slam_mapping_tpu/parallel/mesh.py``. The JAX
package's ``jax.sharding.Mesh`` over the devices of one controller becomes
a ``torch.distributed`` ``DeviceMesh`` over ranks, one device each: NCCL
between CUDA ranks, gloo between CPU ranks. The data axis carries the
frame-pair, edge, BoW-row and map-slab parallelism; the model axis is
SegNet's channel parallelism. Where JAX inserts ``psum``, ``all_gather``
and ``ppermute``, the sharded modules call :func:`all_reduce_sum`,
:func:`all_gather` and :func:`ring_exchange` on the data axis's process
group. Each keeps a count of its calls (``.calls``, zeroed by the caller)
and of the bytes it sent (``.bytes``), so a run can show which collectives
its path made.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from semantic_slam_mapping_torch.device import resolve

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str | torch.device = "cuda") -> int:
    """Join the process group of a multi-process run and return its world
    size (one device a rank). ``coordinator`` is ``host:port`` (a TCP
    rendezvous) or a URL (``tcp://...``, ``file://...``), with the world
    size and this process's rank; with none of the three, torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``) when it is set, else a world of one. A no-op when the group
    is already initialised. The backend is NCCL on CUDA and gloo on the
    CPU; a CUDA device with no card raises."""
    if dist.is_initialized():
        return dist.get_world_size()
    dev = resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    # -1: read from the environment (init_process_group's default)
    world = -1 if num_processes is None else num_processes
    rank = -1 if process_id is None else process_id
    if coordinator is not None:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url, world_size=world,
                                rank=rank)
    elif num_processes is not None or process_id is not None \
            or "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=rank)
    else:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    return dist.get_world_size()


def mesh_shape(n: int, dp: Optional[int] = None,
               tp: Optional[int] = None) -> Tuple[int, int]:
    """The JAX package's (dp, tp) defaults for n devices: with neither
    given, tp is 2 when n is even and above 1, and dp takes the rest; with
    one given, the other is n divided by it."""
    if dp is None and tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    return dp, tp


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A (dp, tp) mesh named (data, model) over the ranks of the process
    group, on ``device``'s type (joining a world of one when no group
    exists, see :func:`initialize_distributed`). ``n_devices`` defaults to
    the world size; unlike a JAX mesh, which may take the first dp*tp
    devices, a ``DeviceMesh`` spans every rank, so dp*tp must equal the
    world size."""
    dev = resolve(device)
    world = initialize_distributed(device=dev)
    dp, tp = mesh_shape(n_devices or world, dp, tp)
    if dp * tp != world:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} ranks; the "
                         f"process group has {world}")
    return init_device_mesh(dev.type, (dp, tp),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str = DATA_AXIS) -> int:
    return mesh[axis].size()


def axis_index(mesh: DeviceMesh, axis: str = DATA_AXIS) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    return mesh[axis].get_local_rank()


def axis_group(mesh: DeviceMesh, axis: str = DATA_AXIS):
    """The process group of this rank's line along ``axis``."""
    return mesh[axis].get_group()


def _count(fn, x: torch.Tensor) -> None:
    fn.calls += 1
    fn.bytes += x.numel() * x.element_size()


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along dim 0, in rank order
    (``lax.all_gather(..., tiled=True)``); the same on every rank. Bools
    travel as bytes."""
    _count(all_gather, x)
    src = x.contiguous()
    if src.dtype == torch.bool:
        src = src.to(torch.uint8)
    n = dist.get_world_size(group)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    k = src.shape[0]
    dist.all_gather([out[i * k:(i + 1) * k] for i in range(n)], src,
                    group=group)
    return out.to(x.dtype) if x.dtype == torch.bool else out


all_gather.calls = 0
all_gather.bytes = 0


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x`` (``lax.psum``), as a new tensor; every
    rank gets the same bits."""
    _count(all_reduce_sum, x)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0


def ring_exchange(to_next: torch.Tensor, to_prev: torch.Tensor, group
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two ``ppermute``s of a ring: rank i sends ``to_next`` to rank
    i+1 and ``to_prev`` to rank i-1 (both modulo the group's size) and
    returns (what rank i-1 sent on, what rank i+1 sent back). In a group of
    one a rank is its own neighbour and gets its own tensors back, as a
    ``ppermute`` over one device does, without a message (gloo cannot send
    to its own rank)."""
    _count(ring_exchange, to_next)
    _count(ring_exchange, to_prev)
    n = dist.get_world_size(group)
    if n == 1:
        return to_next.clone(), to_prev.clone()
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    from_prev = torch.empty_like(to_next)
    from_next = torch.empty_like(to_prev)
    # tags keep the two directions apart where both neighbours are one
    # rank (n = 2)
    ops = [dist.P2POp(dist.isend, to_next.contiguous(), nxt, group, tag=0),
           dist.P2POp(dist.irecv, from_prev, prv, group, tag=0),
           dist.P2POp(dist.isend, to_prev.contiguous(), prv, group, tag=1),
           dist.P2POp(dist.irecv, from_next, nxt, group, tag=1)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return from_prev, from_next


ring_exchange.calls = 0
ring_exchange.bytes = 0


def reset_counts() -> None:
    """Zero the collectives' call and byte counts."""
    for fn in (all_gather, all_reduce_sum, ring_exchange):
        fn.calls = 0
        fn.bytes = 0


def counts() -> dict:
    """{name: {"calls", "bytes"}} of the collectives since the last
    :func:`reset_counts`."""
    return {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes}
            for fn in (all_gather, all_reduce_sum, ring_exchange)}
