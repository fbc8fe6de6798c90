"""Plain SegNet-VGG16: the reference that the program's labels and
training steps are held to, and its lower-precision control.

The network of Badrinarayanan et al. (TPAMI 2017) as the port defines it:
13 encoder and 13 decoder 3x3 convolutions, each followed by BatchNorm
(Flax's: float32 statistics, the fast biased variance, running buffers
moved by momentum 0.9) and ReLU; 2x2 max pooling keeping the first maximal
entry of each window, whose indices unpool the decoder; a 3x3 classifier.
Tensors are NHWC at the interface. The reference computes in float32 with
TF32 off. ``precision="float8"`` is the control: every tensor that the
program stores in bfloat16 (a convolution's input, kernel and output,
BatchNorm's output) is rounded to float8_e4m3fn under a scale per tensor,
the type below the configuration's bfloat16, and so is its gradient going
back; the arithmetic between stores stays float32.

Layers are a list of dicts ``w`` (cout, cin, 3, 3), ``b``, ``scale``,
``shift``, ``mean``, ``var``, and a last dict ``w``, ``b`` for the
classifier.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

BLOCKS: Sequence[Tuple[int, int]] = ((2, 64), (2, 128), (3, 256), (3, 512),
                                     (3, 512))
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
FP8_MAX = 448.0


def plan(num_classes: int = 12) -> List[Tuple[int, int]]:
    """(cin, cout) of the 26 convolutions and the classifier."""
    out, cin = [], 3
    for n, ch in BLOCKS:
        for _ in range(n):
            out.append((cin, ch))
            cin = ch
    rev = list(reversed(BLOCKS))
    for bi, (n, ch) in enumerate(rev):
        nxt = rev[bi + 1][1] if bi + 1 < len(rev) else BLOCKS[0][1]
        for ci in range(n):
            cout = ch if ci < n - 1 else nxt
            out.append((cin, cout))
            cin = cout
    return out + [(cin, num_classes)]


@contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions inside the block."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _round8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn under a scale of its own (its largest
    magnitude maps to the type's largest value)."""
    s = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Float8(torch.autograd.Function):
    """A value stored in float8: rounded going forward, and its gradient
    rounded going back."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x)

    @staticmethod
    def backward(ctx, g):
        return _round8(g)


def _store(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A tensor as the network stores it: as it is in float32; rounded to
    float8 (forward and backward) for the control, where the program
    stores bfloat16."""
    return _Float8.apply(x) if precision == "float8" else x


def _conv(x, layer, precision):
    y = F.conv2d(_store(x, precision), _store(layer["w"], precision),
                 layer["b"], padding=1)
    return _store(y, precision)


def _bn(y, layer, train):
    if train:
        mean = y.mean(dim=(0, 2, 3))
        var = torch.clamp((y * y).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            layer["mean"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            layer["var"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    else:
        mean, var = layer["mean"], layer["var"]
    mul = torch.rsqrt(var + BN_EPS) * layer["scale"]
    return (y - mean[:, None, None]) * mul[:, None, None] \
        + layer["shift"][:, None, None]


def _pool(x):
    """2x2 max pool of NCHW: pooled values and the one-hot index of the
    first maximal entry of each window (row-major)."""
    B, C, H, W = x.shape
    w = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 1, 2, 4, 3, 5)
    w = w.reshape(B, C, H // 2, W // 2, 4)
    pooled = w.amax(dim=-1)
    is_max = w >= pooled[..., None]
    first = is_max & (torch.cumsum(is_max.int(), dim=-1) <= 1)
    return pooled, first.to(x.dtype)


def _unpool(x, onehot):
    B, C, Hh, Wh, _ = onehot.shape
    w = (x[..., None] * onehot).reshape(B, C, Hh, Wh, 2, 2)
    return w.permute(0, 1, 2, 4, 3, 5).reshape(B, C, Hh * 2, Wh * 2)


def forward(layers: List[dict], images: torch.Tensor, train: bool = False,
            precision: str = "float32") -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, H, W, classes) float32 logits. In
    train mode BatchNorm uses the batch's statistics and moves the layers'
    running buffers."""
    x = images.float().permute(0, 3, 1, 2)
    it = iter(layers[:-1])
    idx = []
    for n, _ in BLOCKS:
        for _ in range(n):
            layer = next(it)
            x = torch.relu(_store(_bn(_conv(x, layer, precision), layer,
                                      train), precision))
        x, i = _pool(x)
        idx.append(i)
    for bi, (n, _) in enumerate(reversed(BLOCKS)):
        x = _unpool(x, idx[-1 - bi])
        for _ in range(n):
            layer = next(it)
            x = torch.relu(_store(_bn(_conv(x, layer, precision), layer,
                                      train), precision))
    return _conv(x, layers[-1], precision).permute(0, 2, 3, 1)


@torch.no_grad()
def centre_classes(layers: List[dict], images: torch.Tensor) -> None:
    """Shift the classifier's biases so that every class's logit has mean
    nought over ``images``: a drawn network then spreads its labels over
    the classes alike, whatever the seed."""
    with exact_float32():
        logits = forward(layers, images)
    layers[-1]["b"] -= logits.mean(dim=(0, 1, 2))


def loss(logits: torch.Tensor, labels: torch.Tensor,
         class_weights: torch.Tensor) -> torch.Tensor:
    """Class-weighted cross-entropy over all pixels, divided by the sum of
    the pixels' weights."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    w = class_weights[labels.long()]
    return -(w * ll).sum() / torch.clamp(w.sum(), min=1e-6)


class Adam:
    """Adam with torch's and optax's defaults (b1 0.9, b2 0.999, eps 1e-8
    added to the bias-corrected root of the second moment)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, state=None):
        self.params, self.lr, self.b1, self.b2, self.eps = \
            list(params), lr, b1, b2, eps
        if state is None:
            self.m = [torch.zeros_like(p) for p in self.params]
            self.v = [torch.zeros_like(p) for p in self.params]
            self.t = 0
        else:
            m, v, self.t = state
            self.m = [x.clone().float() for x in m]
            self.v = [x.clone().float() for x in v]

    @torch.no_grad()
    def step(self):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            denom = v.sqrt() / bc2 ** 0.5 + self.eps
            p.sub_(self.lr / bc1 * m / denom)
            p.grad = None


def trainable(layers: List[dict]) -> List[torch.Tensor]:
    """The parameters in a fixed order: each layer's w, b, then scale and
    shift where it has them."""
    out = []
    for layer in layers:
        for k in ("w", "b", "scale", "shift"):
            if k in layer:
                out.append(layer[k])
    return out


def train_steps(layers: List[dict], batches, class_weights: torch.Tensor,
                lr: float, precision: str = "float32", adam_state=None):
    """Adam steps on ``batches`` ((images, labels) pairs) from ``layers``,
    which are updated in place: (losses, the first step's gradients as
    Adam gets them, in ``trainable`` order). ``adam_state``: the first and
    second moments, in ``trainable`` order, and the steps taken, to go on
    from (a new Adam without it)."""
    params = trainable(layers)
    for p in params:
        p.requires_grad_(True)
    opt = Adam(params, lr, state=adam_state)
    losses, first_grads = [], None
    for images, labels in batches:
        loss_t = loss(forward(layers, images, train=True, precision=precision),
                      labels, class_weights)
        loss_t.backward()
        if first_grads is None:
            first_grads = [p.grad.detach().clone() for p in params]
        losses.append(float(loss_t.detach()))
        opt.step()
    for p in params:
        p.requires_grad_(False)
    return losses, first_grads


def logit_gap(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per pixel, how far the labelled class's logit lies below the best
    one, in units of the logits' standard deviation over the image."""
    best = logits.amax(dim=-1)
    got = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (best - got) / logits.std()
