"""SegNet training sharded dp x tp over the (data, model) mesh.

The JAX package has no such module: its ``cli train-segnet --mesh`` jits
the single-device ``make_train_step`` on parameters placed by
``mesh.shard_params``, and GSPMD inserts the collectives. The port spells
them out, one process a device:

- dp: every rank is handed the same global batch and keeps its rows
  (``mesh.batch_sharding``; a rank may get none and still joins every
  collective);
- tp: a convolution whose kernel ``mesh.param_shardings`` splits computes
  this rank's output channels from all its input channels. Activations
  stay channel-split through BatchNorm, ReLU, pooling and unpooling (all
  per channel) and are gathered over the model axis before the next
  convolution and before ``log_softmax`` (``mesh.gather_channels``, whose
  backward sums the partial input gradients of a split convolution);
- BatchNorm normalises over the global batch, as Flax's train mode does:
  the rank's sums of y and y^2 go over the data axis in one all-reduce,
  then Flax's fast biased variance ``max(0, E[y^2] - E[y]^2)`` in float32
  (float64 for a float64 network), and every data rank's running buffers
  move with the global statistics;
- the loss is the JAX package's ``loss_fn`` over the global batch; the
  parameter gradients are summed over the data axis, and those of a
  replicated parameter that a rank uses only on its channel slice also
  over the model axis, before Adam steps the local shards.

Convolutions round to the working dtype as ``models/segnet.py`` does, so a
(1, 1) mesh computes what the meshless network computes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from semantic_slam_mapping_torch.models import segnet
from semantic_slam_mapping_torch.models.segnet import (conv_nhwc,
                                                       max_pool_with_indices,
                                                       max_unpool, normalize,
                                                       promote)
from semantic_slam_mapping_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                       all_reduce_sum,
                                                       axis_group,
                                                       axis_index, axis_size,
                                                       batch_sharding,
                                                       gather_channels,
                                                       sum_grad)


def _kernel_name(name: str) -> str:
    """The kernel of the layer that owns parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return f"blocks.{parts[1]}.conv.weight"
    return f"{parts[0]}.weight"


class _Axes:
    """This rank's view of the mesh: both axes' groups, and its index on
    the model axis among tp."""

    def __init__(self, mesh: DeviceMesh):
        self.data = axis_group(mesh, DATA_AXIS)
        self.model = axis_group(mesh, MODEL_AXIS)
        self.tp = axis_size(mesh, MODEL_AXIS)
        self.m = axis_index(mesh, MODEL_AXIS)

    def own(self, p: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole parameter's channels."""
        k = p.shape[0] // self.tp
        return p[self.m * k:(self.m + 1) * k]


def _conv(x: torch.Tensor, x_split: bool, weight: torch.Tensor,
          bias: torch.Tensor, name: str, model, axes: _Axes
          ) -> Tuple[torch.Tensor, bool]:
    """One convolution of the sharded network: its input made whole, then
    this rank's output channels (all of them where the kernel is
    replicated). Returns the output and whether it is split."""
    split = model.shardings[name] is not None
    if x_split:
        x = gather_channels(x, axes.model, partial_grad=split)
    elif split and x.requires_grad:
        x = sum_grad(x, axes.model)
    if split and model.shardings[name.rsplit(".", 1)[0] + ".bias"] is None:
        bias = axes.own(bias)
    return conv_nhwc(x, weight, bias, model.dtype), split


def _batch_norm(y: torch.Tensor, split: bool, bn: segnet.BatchNorm,
                prefix: str, n_global: int, model, axes: _Axes
                ) -> torch.Tensor:
    """Flax's train-mode BatchNorm over the global batch of this rank's
    channels (``n_global`` rows)."""
    yf = promote(y)
    sums = all_reduce_sum(torch.stack([yf.sum(dim=(0, 1, 2)),
                                       (yf * yf).sum(dim=(0, 1, 2))]),
                          axes.data)
    count = n_global * y.shape[1] * y.shape[2]
    mean = sums[0] / count
    var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
    bn.update(mean, var)
    scale, bias = bn.scale, bn.bias
    if split and model.shardings[prefix + "scale"] is None:
        scale, bias = axes.own(scale), axes.own(bias)
    return normalize(yf, mean, var, scale, bias).to(y.dtype)


def forward(model, images: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Train-mode logits of this rank's rows of the global batch
    ``images`` ((B, H, W, 3), the same on every rank) through a model made
    by ``mesh.shard_params``: (rows, H, W, num_classes), float32 (float64
    for a float64 network), whole on every model rank. The BatchNorm
    buffers move as the meshless network's do in train mode."""
    axes = _Axes(mesh)
    n_global = images.shape[0]
    x, x_split = batch_sharding(mesh)(images).to(model.dtype), False
    layers = iter(enumerate(model.blocks))

    def conv_bn_relu(x, x_split):
        i, blk = next(layers)
        pre = f"blocks.{i}."
        y, split = _conv(x, x_split, blk.conv.weight, blk.conv.bias,
                         pre + "conv.weight", model, axes)
        y = _batch_norm(y, split, blk.bn, pre + "bn.", n_global, model,
                        axes)
        return torch.relu(y), split

    indices = []
    for n_convs, _ in segnet._BLOCKS:
        for _ in range(n_convs):
            x, x_split = conv_bn_relu(x, x_split)
        x, idx = max_pool_with_indices(x)
        indices.append(idx)
    for bi, (n_convs, _) in enumerate(reversed(segnet._BLOCKS)):
        x = max_unpool(x, indices[-1 - bi])
        for _ in range(n_convs):
            x, x_split = conv_bn_relu(x, x_split)
    logits, split = _conv(x, x_split, model.classifier.weight,
                          model.classifier.bias, "classifier.weight", model,
                          axes)
    if split:
        logits = gather_channels(logits, axes.model, partial_grad=False)
    return logits.to(torch.promote_types(model.dtype, torch.float32))


def loss_fn(model, images: torch.Tensor, labels: torch.Tensor,
            mesh: DeviceMesh, label_valid: Optional[torch.Tensor] = None,
            class_weights: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``loss_fn`` over the global batch, on a sharded
    model: ``(loss, objective)``. ``loss`` is ``-sum(w * ll) / max(sum(w),
    1e-6)`` with both sums all-reduced over the data axis (one message),
    the same on every rank; ``objective`` is this rank's share of it (its
    rows' numerator over the global denominator), whose gradient, summed
    over the data axis, is the loss's. The denominator carries no
    gradient."""
    place = batch_sharding(mesh)
    logp = torch.log_softmax(forward(model, images, mesh), dim=-1)
    labels = place(labels).long()
    ll = torch.gather(logp, -1, labels.unsqueeze(-1)).squeeze(-1)
    pix_w = (class_weights[labels] if class_weights is not None
             else torch.ones_like(ll))
    if label_valid is not None:
        pix_w = torch.where(place(label_valid), pix_w, 0.0)
    num = (pix_w * ll).sum()
    sums = all_reduce_sum(torch.stack([num, pix_w.sum()]).detach(),
                          axis_group(mesh, DATA_AXIS))
    den = torch.clamp(sums[1], min=1e-6)
    return -sums[0] / den, -num / den


def _sum_grads(params, group) -> None:
    """Sum the gradients of ``params`` over ``group`` in one flat
    all-reduce."""
    if not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    total = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    for p, g in zip(params, total.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def loss_and_grads(model, images: torch.Tensor, labels: torch.Tensor,
                   mesh: DeviceMesh,
                   label_valid: Optional[torch.Tensor] = None,
                   class_weights: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """:func:`loss_fn` and its gradient (``jax.value_and_grad``): each
    parameter's ``.grad`` (None, or zero, before the call) becomes the
    gradient of the loss with respect to this rank's shard. This rank's
    objective is backpropagated; then the
    gradients of replicated parameters that a rank uses on its channel
    slice only are summed over the model axis (each slice once), and every
    gradient over the data axis, one flat bucket each. Returns the loss,
    detached, the same on every rank."""
    specs = model.shardings
    loss, objective = loss_fn(model, images, labels, mesh, label_valid,
                              class_weights)
    objective.backward()
    sliced = [p for name, p in model.named_parameters()
              if specs[name] is None
              and specs[_kernel_name(name)] is not None]
    _sum_grads(sliced, axis_group(mesh, MODEL_AXIS))
    _sum_grads(list(model.parameters()), axis_group(mesh, DATA_AXIS))
    return loss.detach()


def make_sharded_train_step(model, mesh: DeviceMesh, lr: float,
                            class_weights: Optional[torch.Tensor] = None
                            ) -> Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor]:
    """``step(images, labels) -> loss`` on a model made by
    ``mesh.shard_params``, the counterpart of ``segnet.make_train_step``
    with the parameters sharded: every rank passes the same global batch;
    :func:`loss_and_grads`, then one Adam step (``segnet.adam``: optax's
    betas and eps, elementwise, so a shard steps as its slice of the full
    tensor would). The loss is returned detached, the same on every
    rank."""
    optimizer = segnet.adam(model, lr)

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_and_grads(model, images, labels, mesh,
                              class_weights=class_weights)
        optimizer.step()
        return loss

    return step
