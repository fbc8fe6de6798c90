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

:func:`load_checkpoint` reads the JAX package's pickles (numpy arrays
only) by path; :func:`create` makes a seeded random network.
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from semantic_slam_mapping_torch.config import SegNetConfig
from semantic_slam_mapping_torch.utils.convert import segnet_state_from_flax

# encoder plan: (convs per block, channels), VGG16
_BLOCKS: Sequence[Tuple[int, int]] = (
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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


def _conv_nhwc(x: torch.Tensor, conv: nn.Conv2d,
               dtype: torch.dtype) -> torch.Tensor:
    """3x3 'SAME' convolution of NHWC ``x`` in ``dtype`` (kernel cast to
    it), then the bias added in ``dtype``."""
    w = conv.weight.to(dtype).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    return y + conv.bias.to(dtype)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last axis with Flax's rounding: float32
    arithmetic on the input, the result cast back to the input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + 1e-5) * self.scale
        return ((y.float() - self.mean) * mul + self.bias).to(y.dtype)


class ConvBNRelu(nn.Module):
    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_features, features, 3, padding=1)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(_conv_nhwc(x, self.conv, self.dtype)))


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

    def _ch(self, ch: int) -> int:
        return max(8, int(round(ch * self.width_mult / 8)) * 8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float in [0, 1], H and W multiples of 32 -> (B, H,
        W, num_classes) float32 logits."""
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
        return _conv_nhwc(x, self.classifier, self.dtype).float()


def create(cfg: SegNetConfig = SegNetConfig(),
           generator: Optional[torch.Generator] = None) -> SegNet:
    """A SegNet of the configured width with weights drawn from
    ``generator`` (a CPU generator, so one seed gives the same network on
    every device): He-normal kernels, so that activations keep their scale
    through the 27 convolutions; zero biases; identity BatchNorm."""
    model = SegNet(num_classes=cfg.num_classes, dtype=_DTYPES[cfg.dtype],
                   width_mult=cfg.width_mult)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               * (2.0 / fan_in) ** 0.5)
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


@torch.no_grad()
def infer(model: SegNet, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) int64 argmax labels (ties to the first
    class, as ``jnp.argmax``)."""
    return torch.argmax(model(images), dim=-1)


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
