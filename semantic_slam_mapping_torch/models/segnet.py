"""SegNet semantic segmentation as a ``torch.nn.Module``.

Counterpart of ``semantic_slam_mapping_tpu/models/segnet.py``: the VGG16
encoder-decoder with max-pooling-index unpooling and 12 output classes,
``width_mult`` scaling every block's channels (rounded to multiples of 8;
1.0 is the full network). Tensors are NHWC as in the JAX package; each
convolution runs on a channels-last view.

The arithmetic is Flax's in the working dtype (bfloat16 by default): a
convolution of bf16 inputs and kernel returns bf16 and adds its bias in
bf16; BatchNorm computes ``(y - mean) * (rsqrt(var + 1e-5) * scale) +
bias`` in float32 from the bf16 ``y`` and rounds to bf16; ReLU runs in
bf16; the classifier's bf16 logits are returned as float32. BatchNorm is
not folded into the convolution: that would round elsewhere. Pooling keeps
the first maximal entry of each 2x2 window in row-major order, as the JAX
package's one-hot indices do.

Training follows the JAX package's ``loss_fn`` and ``make_train_step``:
a new network is in eval mode (inference, the JAX module's default) and
``SegNet.train()`` switches BatchNorm to Flax's train mode (batch
statistics, running buffers updated with momentum 0.9), and
:func:`make_train_step` takes one Adam step (optax's ``adam``
hyper-parameters) on a class-weighted cross-entropy. Gradients go through
the pooling as through JAX's ``reduce_max``: a window's tied maxima share
it evenly, and the one-hot indices carry none.

:func:`load_checkpoint` reads the JAX package's pickles (numpy arrays
only) by path and :func:`save_checkpoint` writes them; :func:`create`
makes a seeded random network drawn as Flax's ``init`` draws it.
"""

from __future__ import annotations

import pickle
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from semantic_slam_mapping_torch.config import SegNetConfig
from semantic_slam_mapping_torch.utils.convert import (segnet_state_from_flax,
                                                        segnet_state_to_flax)
from semantic_slam_mapping_torch.utils.timing import span

# encoder plan: (convs per block, channels), VGG16
_BLOCKS: Sequence[Tuple[int, int]] = (
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Flax's BatchNorm(momentum=0.9) and epsilon
_BN_MOMENTUM = 0.9
_BN_EPS = 1e-5
# the standard deviation of a standard normal truncated to [-2, 2]: Flax's
# lecun_normal divides its scale by it, so a kernel keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def max_pool_with_indices(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2/2 max pool of (B, H, W, C): (pooled (B, H/2, W/2, C), one-hot
    indices (B, H/2, W/2, 4, C) in x's dtype, one entry per window: the
    first maximal one in row-major order)."""
    B, H, W, C = x.shape
    w = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    w = w.reshape(B, H // 2, W // 2, 4, C)
    pooled = w.amax(dim=3)
    is_max = w >= pooled.unsqueeze(3)
    onehot = is_max & (torch.cumsum(is_max, dim=3, dtype=torch.int32) <= 1)
    return pooled, onehot.to(x.dtype)


def max_unpool(pooled: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`max_pool_with_indices`: each pooled value back at
    its window's index, zeros elsewhere."""
    B, Hh, Wh, _, C = onehot.shape
    w = pooled.unsqueeze(3) * onehot
    w = w.reshape(B, Hh, Wh, 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return w.reshape(B, Hh * 2, Wh * 2, C)


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """3x3 'SAME' convolution of NHWC ``x`` by the (cout, cin, 3, 3)
    ``weight`` in ``dtype`` (kernel cast to it), then ``bias`` added in
    ``dtype``."""
    w = weight.to(dtype).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    return y + bias.to(dtype)


def promote(y: torch.Tensor) -> torch.Tensor:
    """``y`` in at least float32, as Flax's BatchNorm promotes (float64
    stays float64)."""
    return y.to(torch.promote_types(y.dtype, torch.float32))


def normalize(yf: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Flax's BatchNorm of the promoted ``yf`` by the statistics ``mean``
    and ``var`` (the caller casts the result back)."""
    mul = torch.rsqrt(var + _BN_EPS) * scale
    return (yf - mean) * mul + bias


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with Flax's rounding: float32 arithmetic
    (float64 for a float64 input) on the input, the result cast back to the
    input's dtype.

    In eval mode, where a new module starts (the JAX module's ``train=False``
    default), it normalises with the running ``mean`` and ``var``. In
    train mode it does what Flax's ``BatchNorm(use_running_average=False,
    momentum=0.9)`` does: it normalises with the batch's float32 statistics
    over (B, H, W), the variance by the fast biased formula ``max(0, E[y^2]
    - E[y]^2)``, and moves the running buffers to ``0.9 * old + 0.1 *
    batch`` outside autograd. (``F.batch_norm`` would keep the unbiased
    variance and compute it another way.)"""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.eval()

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        yf = promote(y)
        if self.training:
            mean = yf.mean(dim=(0, 1, 2))
            var = torch.clamp((yf * yf).mean(dim=(0, 1, 2)) - mean * mean,
                              min=0.0)
            self.update(mean, var)
        else:
            mean, var = self.mean, self.var
        return normalize(yf, mean, var, self.scale, self.bias).to(y.dtype)

    @torch.no_grad()
    def update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running buffers towards a batch's statistics."""
        m = _BN_MOMENTUM
        self.mean.copy_(m * self.mean + (1 - m) * mean)
        self.var.copy_(m * self.var + (1 - m) * var)


class ConvBNRelu(nn.Module):
    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_features, features, 3, padding=1)
        self.bn = BatchNorm(features)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(conv_nhwc(x, self.conv.weight,
                                            self.conv.bias, self.dtype)))


class SegNet(nn.Module):
    """SegNet-VGG16 with pooling-index unpooling. ``blocks`` holds the 13
    encoder and 13 decoder ConvBNRelu layers in the order the JAX module
    creates them (its ``ConvBNRelu_0`` ... ``ConvBNRelu_25``); the last
    conv of each decoder block moves to the next shallower block's width."""

    def __init__(self, num_classes: int = 12,
                 dtype: torch.dtype = torch.bfloat16,
                 width_mult: float = 1.0):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.width_mult = width_mult
        plan = []                       # (in, out) of each ConvBNRelu
        ch_in = 3
        for n_convs, ch in _BLOCKS:
            for _ in range(n_convs):
                plan.append((ch_in, self._ch(ch)))
                ch_in = self._ch(ch)
        for bi, (n_convs, ch) in enumerate(reversed(_BLOCKS)):
            next_ch = (_BLOCKS[len(_BLOCKS) - 2 - bi][1]
                       if bi < len(_BLOCKS) - 1 else _BLOCKS[0][1])
            for ci in range(n_convs):
                out = self._ch(ch if ci < n_convs - 1 else next_ch)
                plan.append((ch_in, out))
                ch_in = out
        self.blocks = nn.ModuleList(ConvBNRelu(i, o, dtype) for i, o in plan)
        self.classifier = nn.Conv2d(ch_in, num_classes, 3, padding=1)
        self.eval()

    def _ch(self, ch: int) -> int:
        return max(8, int(round(ch * self.width_mult / 8)) * 8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float in [0, 1], H and W multiples of 32 -> (B, H,
        W, num_classes) float32 logits (float64 for a float64 network)."""
        x = x.to(self.dtype)
        layers = iter(self.blocks)
        indices = []
        for n_convs, _ in _BLOCKS:
            for _ in range(n_convs):
                x = next(layers)(x)
            x, idx = max_pool_with_indices(x)
            indices.append(idx)
        for bi, (n_convs, _) in enumerate(reversed(_BLOCKS)):
            x = max_unpool(x, indices[-1 - bi])
            for _ in range(n_convs):
                x = next(layers)(x)
        # float32 logits, as the JAX module returns (float64 stays float64)
        return conv_nhwc(x, self.classifier.weight, self.classifier.bias,
                         self.dtype).to(
            torch.promote_types(self.dtype, torch.float32))


def create(cfg: SegNetConfig = SegNetConfig(),
           generator: Optional[torch.Generator] = None) -> SegNet:
    """A SegNet of the configured width with weights drawn from
    ``generator`` (a CPU generator, so one seed gives the same network on
    every device) as the JAX package's ``create`` draws them with Flax's
    defaults: every kernel lecun-normal (a normal truncated at two standard
    deviations, scaled to variance 1/fan_in), zero biases, identity
    BatchNorm. The draws are torch's, not ``jax.random``'s: the
    distribution is the same, the values are not."""
    model = SegNet(num_classes=cfg.num_classes, dtype=_DTYPES[cfg.dtype],
                   width_mult=cfg.width_mult)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                m.weight.copy_(w * std)
                m.bias.zero_()
    return model.eval()


def load_checkpoint(path) -> Tuple[SegNet, dict]:
    """(model, meta) from a pickle of the JAX package's ``save_checkpoint``
    (params and batch_stats as numpy arrays, float16 or float32, widened to
    float32 here). A missing file raises."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    model = SegNet(num_classes=d.get("num_classes", 12),
                   dtype=_DTYPES[d.get("dtype", "bfloat16")],
                   width_mult=d.get("width_mult", 1.0))
    model.load_state_dict(segnet_state_from_flax(d["params"],
                                                 d["batch_stats"]))
    return model.eval(), d.get("meta", {})


def save_checkpoint(path, cfg: SegNetConfig, model: SegNet,
                    meta: Optional[dict] = None, store_dtype=None) -> None:
    """Pickle the model as the JAX package's ``save_checkpoint`` does: Flax's
    nested ``params`` and ``batch_stats`` dicts of numpy arrays (kernels
    HWIO), ``num_classes``, ``width_mult`` and ``dtype`` of ``cfg``, and
    ``meta``. ``store_dtype`` (e.g. ``np.float16``) stores the arrays in a
    smaller float type; either package's loader widens them to float32."""
    params, batch_stats = segnet_state_to_flax(model.state_dict())
    if store_dtype is not None:
        def cast(tree):
            return {k: cast(v) if isinstance(v, dict)
                    else v.astype(store_dtype) for k, v in tree.items()}
        params, batch_stats = cast(params), cast(batch_stats)
    with open(path, "wb") as f:
        pickle.dump({"params": params, "batch_stats": batch_stats,
                     "num_classes": cfg.num_classes,
                     "width_mult": cfg.width_mult, "dtype": cfg.dtype,
                     "meta": meta or {}}, f)


def loss_fn(model: SegNet, images: torch.Tensor, labels: torch.Tensor,
            label_valid: Optional[torch.Tensor] = None,
            class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's ``loss_fn``: the network in train mode (so its
    BatchNorm buffers move, as JAX returns ``new_batch_stats``), then the
    per-pixel cross-entropy of the float32 logits' log-softmax, weighted by
    ``class_weights[labels]`` (zero where ``label_valid`` is false) and
    divided by ``max(sum of the weights, 1e-6)``. The model's mode is
    restored afterwards."""
    was_training = model.training
    model.train()
    try:
        logits = model(images)
    finally:
        model.train(was_training)
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    ll = torch.gather(logp, -1, labels.unsqueeze(-1)).squeeze(-1)
    pix_w = (class_weights[labels] if class_weights is not None
             else torch.ones_like(ll))
    if label_valid is not None:
        pix_w = torch.where(label_valid, pix_w, 0.0)
    return -(pix_w * ll).sum() / torch.clamp(pix_w.sum(), min=1e-6)


def median_frequency_weights(label_batches, num_classes: int
                             ) -> torch.Tensor:
    """Median-frequency balancing weights (Badrinarayanan et al. 2015),
    the JAX package's numpy code: w_c = median(freq) / freq_c over the
    classes that appear; absent classes get weight 1. A float32 CPU
    tensor."""
    counts = np.zeros(num_classes, np.int64)
    for y in label_batches:
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
        counts += np.bincount(np.asarray(y).ravel(), minlength=num_classes)
    freq = counts / max(counts.sum(), 1)
    present = freq > 0
    med = np.median(freq[present])
    w = np.where(present, med / np.maximum(freq, 1e-12), 1.0)
    return torch.from_numpy(w.astype(np.float32))


def adam(model: SegNet, lr: float) -> torch.optim.Adam:
    """The counterpart of ``optax.adam(lr)`` over the model's parameters
    (not its BatchNorm buffers)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def make_train_step(model: SegNet, optimizer: torch.optim.Optimizer,
                    class_weights: Optional[torch.Tensor] = None
                    ) -> Callable[[torch.Tensor, torch.Tensor],
                                  torch.Tensor]:
    """``step(images, labels) -> loss``: :func:`loss_fn` in train mode, its
    gradient with respect to the parameters, and one optimizer step, as
    the JAX package's ``make_train_step``. The loss is returned detached,
    on the model's device, without a host synchronisation."""

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with span("segnet/forward"):
            loss = loss_fn(model, images, labels,
                           class_weights=class_weights)
        with span("segnet/backward"):
            loss.backward()
        with span("segnet/optimizer"):
            optimizer.step()
        return loss.detach()

    return step


@torch.no_grad()
def infer(model: SegNet, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) int64 argmax labels (ties to the first
    class, as ``jnp.argmax``)."""
    with span("segnet/infer"):
        with span("segnet/forward"):
            logits = model(images)
        return torch.argmax(logits, dim=-1)


def miou(pred: torch.Tensor, gt: torch.Tensor, num_classes: int,
         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean intersection-over-union over the classes present in ``gt``."""
    if valid is None:
        valid = torch.ones(pred.shape, dtype=torch.bool, device=pred.device)
    v = valid.reshape(-1)
    p = F.one_hot(pred.reshape(-1).long(), num_classes)[v].float()
    g = F.one_hot(gt.reshape(-1).long(), num_classes)[v].float()
    inter = (p * g).sum(0)
    union = p.sum(0) + g.sum(0) - inter
    present = g.sum(0) > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0), 0.0)
    return iou.sum() / torch.clamp(present.sum(), min=1)


def flops(model: SegNet, height: int, width: int) -> int:
    """Multiply-adds x 2 of one (1, height, width, 3) forward pass: every
    3x3 convolution at its resolution (pooling and BatchNorm left out)."""
    convs = [b.conv for b in model.blocks] + [model.classifier]
    sizes = []
    h, w = height, width
    for n_convs, _ in _BLOCKS:
        sizes += [(h, w)] * n_convs
        h, w = h // 2, w // 2
    for n_convs, _ in reversed(_BLOCKS):
        h, w = h * 2, w * 2
        sizes += [(h, w)] * n_convs
    sizes.append((h, w))
    return sum(2 * hh * ww * c.in_channels * c.out_channels * 9
               for c, (hh, ww) in zip(convs, sizes))
