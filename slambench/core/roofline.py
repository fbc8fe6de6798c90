"""The yardstick's arithmetic: the card's published peaks and the work that
each counted piece of the program has to do, worked out from shapes alone,
whatever implements it.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), which
assume the full 700 W power limit; a traced run prints the card's limit
beside its shares.
"""

from __future__ import annotations

BF16_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth

# SegNet-VGG16: (convolutions, channels) of the five encoder blocks; the
# decoder mirrors them, its last convolution of each block moving to the
# next shallower block's width, then a 3x3 classifier
SEGNET_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def segnet_forward_flops(height: int, width: int, num_classes: int = 12,
                         in_channels: int = 3) -> int:
    """2 x multiply-adds of every 3x3 convolution of one (height, width)
    image through the full-width network (pooling, unpooling, BatchNorm and
    ReLU left out): 241,002,086,400 at 384 x 480. The port pads CamVid's
    360 rows to 384, and the count is of the padded image it runs: the
    padding is 6.25% of what the ``mfu`` shares count as work."""
    convs = []                               # (h, w, cin, cout)
    h, w, cin = height, width, in_channels
    for n, ch in SEGNET_BLOCKS:
        for _ in range(n):
            convs.append((h, w, cin, ch))
            cin = ch
        h, w = h // 2, w // 2
    blocks = list(reversed(SEGNET_BLOCKS))
    for bi, (n, ch) in enumerate(blocks):
        h, w = h * 2, w * 2
        nxt = (blocks[bi + 1][1] if bi + 1 < len(blocks)
               else SEGNET_BLOCKS[0][1])
        for ci in range(n):
            cout = ch if ci < n - 1 else nxt
            convs.append((h, w, cin, cout))
            cin = cout
    convs.append((h, w, cin, num_classes))
    return sum(2 * hh * ww * ci * co * 9 for hh, ww, ci, co in convs)


def segnet_train_flops(height: int, width: int, num_classes: int = 12) -> int:
    """One training image: the forward pass and a backward pass of twice its
    work (the input gradient and the weight gradient of each convolution)."""
    return 3 * segnet_forward_flops(height, width, num_classes)


def k1_bytes(batch: int, height: int, width: int, disparities: int,
             itemsize: int = 2) -> int:
    """SGM aggregation over four paths (K1): the (B, H, W, D) cost volume
    read once and the aggregate written once: 149,317,120 bytes at
    (376, 1241, 80) in bf16."""
    return 2 * batch * height * width * disparities * itemsize


def bytes_bound_s(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S


def flops_bound_s(flops: float) -> float:
    return flops / BF16_FLOPS
