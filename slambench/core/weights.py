"""SegNet-VGG16 weights drawn from a seed on the device, in one call, and
handed to both sides: the reference's layer list, and the same numbers
under the port's ``state_dict`` names.

Every kernel is lecun-normal as Flax's default draws it (a normal truncated
at two standard deviations, scaled to variance 1 / fan_in); biases are zero
and BatchNorm is the identity (scale 1, shift 0, running mean 0 and
variance 1), as a new network starts.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from slambench.reference.segnet import plan

# the standard deviation of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def segnet_layers(seed: int, num_classes: int, device) -> List[dict]:
    shapes = plan(num_classes)
    sizes = [ci * co * 9 for ci, co in shapes]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    layers = []
    for (ci, co), w in zip(shapes, torch.split(flat, sizes)):
        w = (w * ((1.0 / (ci * 9)) ** 0.5 / _TRUNC_STD)).reshape(co, ci, 3, 3)
        layer = {"w": w, "b": torch.zeros(co, device=device)}
        if len(layers) < len(shapes) - 1:
            layer.update(scale=torch.ones(co, device=device),
                         shift=torch.zeros(co, device=device),
                         mean=torch.zeros(co, device=device),
                         var=torch.ones(co, device=device))
        layers.append(layer)
    return layers


def port_state(layers: List[dict]) -> Dict[str, torch.Tensor]:
    """The layers under the names of the port's ``SegNet.state_dict``."""
    sd = {}
    for i, layer in enumerate(layers[:-1]):
        sd[f"blocks.{i}.conv.weight"] = layer["w"]
        sd[f"blocks.{i}.conv.bias"] = layer["b"]
        sd[f"blocks.{i}.bn.scale"] = layer["scale"]
        sd[f"blocks.{i}.bn.bias"] = layer["shift"]
        sd[f"blocks.{i}.bn.mean"] = layer["mean"]
        sd[f"blocks.{i}.bn.var"] = layer["var"]
    sd["classifier.weight"] = layers[-1]["w"]
    sd["classifier.bias"] = layers[-1]["b"]
    return sd
