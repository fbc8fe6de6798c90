"""The port's SegNet against the JAX package's Flax SegNet.

Test 1: ``max_pool_with_indices`` and ``max_unpool`` on bfloat16 inputs
drawn from three values (ties in most windows, not only at 0) give the
same pooled values, one-hot indices and unpooled tensor as JAX's, exactly;
one ``ConvBNRelu`` in bfloat16 with random weights and BatchNorm
statistics gives JAX's output, all but at most 0.5% of the elements
exactly and the rest within one bfloat16 ulp of the largest output (the
two frameworks sum a convolution in float32 in different orders, a sum
within float32 rounding of a bfloat16 tie can round either way, and
BatchNorm and ReLU carry that ulp on).

Test 2: the full-width network (``segnet_w1.pkl``, width 1.0) carried
across at a 64x96 rendered frame: in float32 the logits agree within 1e-3
of their largest magnitude; in bfloat16, the shipped dtype, the labels
agree on at least 99% of the pixels. The JAX side runs op by op
(``model.apply`` outside ``jit``), which rounds every op to bfloat16 as
Flax writes it: under ``jit``, XLA on the CPU keeps some bfloat16
intermediates in float32, and its labels differ from its own op-by-op
labels on about 1% of this frame's pixels.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu.config import CameraConfig
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_tpu.models import segnet as jseg
from semantic_slam_mapping_torch.models import segnet as tseg
from semantic_slam_mapping_torch.utils import convert

torch.set_num_threads(4)

WEIGHTS = (Path(__file__).resolve().parents[1] / "semantic_slam_mapping_tpu"
           / "models" / "weights" / "segnet_w1.pkl")


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.float().numpy()


def test_pool_ties_and_conv_bn_relu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.choice(np.float32([0.0, 0.5, 1.25]), size=(2, 8, 12, 16))
    jp, jo = jseg.max_pool_with_indices(jnp.asarray(x, jnp.bfloat16))
    tp, to = tseg.max_pool_with_indices(_bf16(x))
    assert to.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(jp, np.float32), _np(tp))
    assert np.array_equal(np.asarray(jo, np.float32), _np(to))
    ties = (x.reshape(2, 4, 2, 6, 2, 16) == x.reshape(2, 4, 2, 6, 2, 16)
            .max(axis=(2, 4), keepdims=True)).sum(axis=(2, 4)) > 1
    assert ties.mean() > 0.3
    assert np.array_equal(np.asarray(jseg.max_unpool(jp, jo), np.float32),
                          _np(tseg.max_unpool(tp, to)))

    # one ConvBNRelu, 16 -> 32 channels, in bf16
    params = {"Conv_0": {"kernel": rng.normal(0, 0.2, (3, 3, 16, 32)),
                         "bias": rng.normal(0, 0.1, 32)},
              "BatchNorm_0": {"scale": rng.uniform(0.5, 2, 32),
                              "bias": rng.normal(0, 0.3, 32)}}
    stats = {"BatchNorm_0": {"mean": rng.normal(0, 0.5, 32),
                             "var": rng.uniform(0.2, 3, 32)}}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float32), stats)
    xin = rng.normal(0, 1, (2, 16, 24, 16)).astype(np.float32)
    jy = jseg.ConvBNRelu(32, jnp.bfloat16).apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(xin, jnp.bfloat16))
    block = tseg.ConvBNRelu(16, 32, torch.bfloat16)
    state = convert.segnet_state_from_flax({"ConvBNRelu_0": params},
                                           {"ConvBNRelu_0": stats})
    block.load_state_dict({k[len("blocks.0."):]: v
                           for k, v in state.items()})
    with torch.no_grad():
        ty = block(_bf16(xin))
    assert ty.dtype == torch.bfloat16
    a, b = np.asarray(jy, np.float32), _np(ty)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)
    assert (a != b).mean() <= 0.005, (a != b).mean()
    assert np.abs(a - b).max() <= ulp, (np.abs(a - b).max(), ulp)


@pytest.mark.skipif(not WEIGHTS.exists(), reason="no shipped checkpoint")
def test_full_width_checkpoint_matches_jax():
    model, variables, _ = jseg.load_checkpoint(WEIGHTS)
    tmodel, meta = tseg.load_checkpoint(WEIGHTS)
    assert tmodel.width_mult == 1.0 and meta["miou"] > 0.5
    assert tseg.flops(tmodel, 384, 480) == 241_002_086_400
    h, w = 64, 96
    K = Intrinsics.from_config(CameraConfig(fx=80.0, fy=80.0, cx=w / 2,
                                            cy=h / 2))
    world = jsyn.make_world(jax.random.PRNGKey(321), n_boxes=8)
    img = np.asarray(jsyn.render(K, jnp.eye(4), world, h, w)[0])
    x = np.stack([img] * 3, -1)[None].astype(np.float32)

    # float32: the arithmetic
    j32 = jseg.SegNet(num_classes=12, dtype=jnp.float32, width_mult=1.0)
    jl = np.asarray(j32.apply(variables, jnp.asarray(x)))
    t32 = tseg.SegNet(12, torch.float32, 1.0)
    t32.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        tl = t32(torch.from_numpy(x)).numpy()
    scale = float(np.abs(jl).max())
    assert np.abs(tl - jl).max() <= 1e-3 * scale, (
        np.abs(tl - jl).max(), scale)

    # bfloat16, as shipped: the labels
    jlab = np.asarray(jnp.argmax(model.apply(variables, jnp.asarray(x)), -1))
    tlab = tseg.infer(tmodel, torch.from_numpy(x)).numpy()
    agree = float((jlab == tlab).mean())
    assert agree >= 0.99, agree
    assert len(np.unique(tlab)) >= 3
