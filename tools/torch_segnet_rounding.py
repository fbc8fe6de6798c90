"""How bfloat16 rounding moves SegNet's labels, on the CPU.

Prints one JSON line with the share of equal labels between:

- the port's SegNet and the JAX package's, both with the trained
  full-width weights (``segnet_w1.pkl``) in bfloat16 on a 64x96 rendered
  frame, JAX run op by op (``model.apply`` outside ``jit``) and jitted,
  with the largest logit difference to the op-by-op run;
- the jitted JAX network and its own op-by-op run;
- the port's full-width network with seeded random weights at its
  384x480 input, in bfloat16 and in float32, and the same network in
  float64.

    python tools/torch_segnet_rounding.py
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.config import CameraConfig
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_tpu.models import segnet as jseg
from semantic_slam_mapping_torch.config import SegNetConfig
from semantic_slam_mapping_torch.models import segnet as tseg

WEIGHTS = (Path(__file__).resolve().parents[1] / "semantic_slam_mapping_tpu"
           / "models" / "weights" / "segnet_w1.pkl")


def trained() -> dict:
    model, variables, _ = jseg.load_checkpoint(WEIGHTS)
    tmodel, _ = tseg.load_checkpoint(WEIGHTS)
    h, w = 64, 96
    K = Intrinsics.from_config(CameraConfig(fx=80.0, fy=80.0, cx=w / 2,
                                            cy=h / 2))
    world = jsyn.make_world(jax.random.PRNGKey(321), n_boxes=8)
    img = np.asarray(jsyn.render(K, jnp.eye(4), world, h, w)[0])
    x = np.stack([img] * 3, -1)[None].astype(np.float32)
    eager = np.asarray(model.apply(variables, jnp.asarray(x)))
    jitted = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        port = tmodel(torch.from_numpy(x)).numpy()
    same = lambda a, b: float((a.argmax(-1) == b.argmax(-1)).mean())  # noqa: E731
    return {"port_vs_jax_op_by_op": same(port, eager),
            "port_vs_jax_op_by_op_max_logit_diff":
                float(np.abs(port - eager).max()),
            "port_vs_jax_jit": same(port, jitted),
            "jax_jit_vs_jax_op_by_op": same(jitted, eager)}


def random_network() -> dict:
    x = torch.rand(1, 384, 480, 3, generator=torch.Generator().manual_seed(1))
    labels = {}
    for dtype in ("bfloat16", "float32"):
        m = tseg.create(SegNetConfig(dtype=dtype),
                        torch.Generator().manual_seed(0))
        labels[dtype] = tseg.infer(m, x)
    m64 = copy.deepcopy(m).double()
    m64.dtype = torch.float64
    for b in m64.blocks:
        b.dtype = torch.float64
    labels["float64"] = tseg.infer(m64, x.double())
    return {f"random_{d}_vs_float64": float(
        (labels[d] == labels["float64"]).float().mean())
        for d in ("bfloat16", "float32")}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    print(json.dumps({**trained(), **random_network()}))
