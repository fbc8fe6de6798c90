"""The (data, model) device mesh and the collectives of the sharded paths.

Counterpart of ``semantic_slam_mapping_tpu/parallel/mesh.py``. The JAX
package's ``jax.sharding.Mesh`` over the devices of one controller becomes
a ``torch.distributed`` ``DeviceMesh`` over ranks, one device each: NCCL
between CUDA ranks, gloo between CPU ranks. The data axis carries the
frame-pair, edge, BoW-row and map-slab parallelism and SegNet training's
batch; the model axis is SegNet's channel parallelism. Where JAX inserts
``psum``, ``all_gather`` and ``ppermute``, the sharded modules call
:func:`all_reduce_sum`, :func:`all_gather`, :func:`gather_channels` and
:func:`ring_exchange` on an axis's process group. Each keeps a count of its
calls (``.calls``, zeroed by the caller) and of the bytes it sent
(``.bytes``), so a run can show which collectives its path made; the
backward passes of :func:`all_reduce_sum` and :func:`gather_channels` count
theirs too (the latter's as :func:`reduce_scatter`).

Where JAX places arrays with ``NamedSharding``s, the port hands each rank
its piece: :func:`replicated` and :func:`batch_sharding` give a function
from a global tensor to this rank's part, and :func:`shard_params` a copy
of a SegNet holding this rank's shards of the parameters that
:func:`param_shardings` splits over the model axis (JAX's
``_spec_for_param`` rule); :func:`gather_params` puts the full network
back together.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
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


class _AllReduceSum(torch.autograd.Function):
    # backward: every rank's output is the sum of every rank's input, so
    # the gradient of a rank's input is the sum of the outputs' gradients

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(all_reduce_sum, x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(all_reduce_sum, g, ctx.group), None


def _all_reduce(fn, x: torch.Tensor, group) -> torch.Tensor:
    _count(fn, x)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x`` (``lax.psum``), as a new tensor; every
    rank gets the same bits. Differentiable: the gradient of a rank's
    ``x`` is the group's sum of the gradients of the outputs."""
    return _AllReduceSum.apply(x, group)


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's channel slice (last dim) of the group's sum of ``x``:
    the group's size divides the channels into equal slices, rank i keeps
    the i-th. Summed by an all-reduce, then sliced (the backward of
    :func:`gather_channels`)."""
    total = _all_reduce(reduce_scatter, x, group)
    return _own_channels(total, group)


def _own_channels(x: torch.Tensor, group) -> torch.Tensor:
    k = x.shape[-1] // dist.get_world_size(group)
    return x.narrow(-1, dist.get_rank(group) * k, k).contiguous()


reduce_scatter.calls = 0
reduce_scatter.bytes = 0


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, partial_grad):
        ctx.group, ctx.partial_grad = group, partial_grad
        n = dist.get_world_size(group)
        # the ranks' tensors stacked on dim 0, then their channels side by
        # side in rank order
        rows = all_gather(x, group).view(n, *x.shape)
        return rows.movedim(0, -2).reshape(*x.shape[:-1], n * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        own = (reduce_scatter(g, ctx.group) if ctx.partial_grad
               else _own_channels(g, ctx.group))
        return own, None, None


def gather_channels(x: torch.Tensor, group,
                    partial_grad: bool = True) -> torch.Tensor:
    """The group's channel slices of ``x`` (last dim) concatenated in rank
    order, the same on every rank. Differentiable. With ``partial_grad``
    (the gathered tensor feeds a computation whose output channels are
    split over the group, so each rank's gradient is a partial sum) the
    backward is :func:`reduce_scatter`; without it (every rank computes
    the same thing from the gathered tensor, so each rank's gradient is
    whole) the backward keeps this rank's slice."""
    return _GatherChannels.apply(x, group, partial_grad)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(all_reduce_sum, g, ctx.group), None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over the group (a tensor that
    every rank holds whole, feeding a computation split over the group)."""
    return _SumGrad.apply(x, group)


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


_COUNTED = (all_gather, all_reduce_sum, reduce_scatter, ring_exchange)


def reset_counts() -> None:
    """Zero the collectives' call and byte counts."""
    for fn in _COUNTED:
        fn.calls = 0
        fn.bytes = 0


def counts() -> dict:
    """{name: {"calls", "bytes"}} of the collectives since the last
    :func:`reset_counts`."""
    return {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes}
            for fn in _COUNTED}


# ---------------------------------------------------------------------------
# shardings: SegNet training, dp x tp (JAX mesh.py:72-106)


def replicated(mesh: DeviceMesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``NamedSharding(mesh, P())``: every rank holds the whole tensor."""
    return lambda x: x


def batch_sharding(mesh: DeviceMesh
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``NamedSharding(mesh, P('data'))``: this rank's rows of a batch, the
    leading axis cut over the data axis by ``torch.tensor_split`` (so a
    batch that dp does not divide still splits, and a rank may get no
    row); the model ranks of one data index hold the same rows."""
    dp, d = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    return lambda x: torch.tensor_split(x, dp)[d]


def _spec_for_param(shape: Tuple[int, ...], tp: int) -> Optional[int]:
    """JAX's ``_spec_for_param`` on a parameter's Flax shape, given its
    torch shape: the dim split over the model axis, or None (replicated).
    A convolution kernel (torch (cout, cin, 3, 3), Flax (3, 3, cin, cout))
    splits cout, torch dim 0, when tp divides it and it is at least 2 tp;
    a 1-D parameter splits when tp divides it and it is at least 64 tp."""
    if len(shape) == 4 and shape[0] % tp == 0 and shape[0] >= 2 * tp:
        return 0
    if len(shape) == 1 and shape[0] % tp == 0 and shape[0] >= 64 * tp:
        return 0
    return None


def param_shardings(model: nn.Module, mesh: Union[DeviceMesh, int]
                    ) -> Dict[str, Optional[int]]:
    """{parameter name: the dim split over the model axis, or None} of a
    full SegNet; ``mesh`` may also be the model axis's size."""
    tp = mesh if isinstance(mesh, int) else axis_size(mesh, MODEL_AXIS)
    return {name: _spec_for_param(tuple(p.shape), tp)
            for name, p in model.named_parameters()}


def _state_split(specs: Dict[str, Optional[int]], name: str) -> bool:
    """Whether a state entry is split: a parameter by its spec, a
    BatchNorm buffer (``blocks.<i>.bn.mean``, ``.var``) with the output
    channels of its layer's kernel."""
    if name in specs:
        return specs[name] is not None
    return specs[name.rsplit(".bn.", 1)[0] + ".conv.weight"] is not None


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """A copy of the full SegNet ``model`` (the same on every rank) whose
    split parameters and buffers hold this rank's slice along dim 0 (the
    i-th of tp equal slices on model rank i) and whose replicated ones are
    whole. It keeps the full network's :func:`param_shardings` as
    ``.shardings``. Only ``sharded_segnet`` runs it; :func:`gather_params`
    is its inverse."""
    tp, m = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    specs = param_shardings(model, tp)
    local = copy.deepcopy(model)
    with torch.no_grad():
        for name, t in list(local.state_dict(keep_vars=True).items()):
            if _state_split(specs, name):
                k = t.shape[0] // tp
                piece = t.detach()[m * k:(m + 1) * k].clone()
                if isinstance(t, nn.Parameter):
                    t.data = piece
                else:
                    owner, _, leaf = name.rpartition(".")
                    setattr(local.get_submodule(owner), leaf, piece)
    local.shardings = specs
    return local


def gather_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """The full SegNet (in eval mode, on every rank) of a model made by
    :func:`shard_params`: its split parameters and buffers gathered over
    the model axis in one all-gather of a flat bucket."""
    # imported here: SegNet's module imports the tracker, which imports
    # this one
    from semantic_slam_mapping_torch.models.segnet import SegNet

    tp = axis_size(mesh, MODEL_AXIS)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    split = [k for k in state if _state_split(model.shardings, k)]
    first = next(iter(state.values()))
    if split:
        flat = torch.cat([state[k].reshape(-1) for k in split])
        rows = all_gather(flat, axis_group(mesh, MODEL_AXIS)).view(tp, -1)
        off = 0
        for k in split:
            t = state[k]
            state[k] = rows[:, off:off + t.numel()].reshape(
                tp * t.shape[0], *t.shape[1:])
            off += t.numel()
    full = SegNet(num_classes=model.num_classes, dtype=model.dtype,
                  width_mult=model.width_mult).to(device=first.device,
                                                  dtype=first.dtype)
    full.load_state_dict(state)
    return full.eval()
