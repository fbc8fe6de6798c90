"""State carried across from the JAX package, as plain functions of numpy
data (no JAX import): a config dict, intrinsics, a tracker state, a
synthetic world and SegNet's Flax parameters each become the port's
counterpart; SegNet's state also goes back to Flax's layout
(:func:`segnet_state_to_flax`), so trained weights cross both ways.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from semantic_slam_mapping_torch import config as cfg_mod
from semantic_slam_mapping_torch.frontend.tracker import TrackerState
from semantic_slam_mapping_torch.frontend.uvdisparity import PitchKalmanState
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.io.synthetic import World


def config_from_dict(d: Mapping[str, Any]) -> cfg_mod.SlamConfig:
    """``dataclasses.asdict`` of a JAX ``SlamConfig`` -> the port's config,
    section by section; a field the port does not know raises."""
    sections = {}
    for f in dataclasses.fields(cfg_mod.SlamConfig):
        if f.name in d:
            sections[f.name] = f.default_factory().__class__(**d[f.name])
    return cfg_mod.SlamConfig(**sections)


def intrinsics_from_numpy(fx, fy, cx, cy, baseline, scale) -> Intrinsics:
    """Intrinsics from six numbers (e.g. ``*np.asarray`` of the JAX
    ``Intrinsics`` fields)."""
    return Intrinsics(*(float(np.asarray(v)) for v in
                        (fx, fy, cx, cy, baseline, scale)))


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def tracker_state_from_numpy(status, pose, velocity, lost_count, pitch_kf,
                             frame_index,
                             device: str | torch.device = "cuda"
                             ) -> TrackerState:
    """A TrackerState from numpy fields (pitch_kf is an (x, P) pair)."""
    x, P = pitch_kf
    return TrackerState(
        status=_t(status, device, torch.int32),
        pose=_t(pose, device, torch.float32),
        velocity=_t(velocity, device, torch.float32),
        lost_count=_t(lost_count, device, torch.int32),
        pitch_kf=PitchKalmanState(x=_t(x, device, torch.float32),
                                  P=_t(P, device, torch.float32)),
        frame_index=_t(frame_index, device, torch.int32))


def world_from_numpy(boxes, box_class, ground_y, backdrop_z,
                     box_velocity=None,
                     device: str | torch.device = "cuda") -> World:
    """A synthetic World from numpy fields."""
    return World(
        boxes=_t(boxes, device, torch.float32),
        box_class=_t(box_class, device, torch.int64),
        ground_y=_t(ground_y, device, torch.float32),
        backdrop_z=_t(backdrop_z, device, torch.float32),
        box_velocity=(None if box_velocity is None
                      else _t(box_velocity, device, torch.float32)))


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.float32))


def segnet_state_from_flax(params: Mapping[str, Any],
                           batch_stats: Mapping[str, Any]
                           ) -> dict:
    """SegNet's Flax ``params`` and ``batch_stats`` (nested dicts of numpy
    arrays) -> the port's ``SegNet.state_dict()``, in float32.

    Flax names the layers ``ConvBNRelu_<i>`` in creation order (13 encoder,
    then 13 decoder layers) and the classifier ``Conv_0``; the suffix is
    the index into ``SegNet.blocks`` (the dict keys sort as strings, so
    they are not taken in key order). Kernels are HWIO; torch wants OIHW."""
    state = {}

    def conv(prefix, p):
        state[prefix + "weight"] = _f32(p["kernel"]).permute(3, 2, 0, 1) \
            .contiguous()
        state[prefix + "bias"] = _f32(p["bias"])

    for name, p in params.items():
        if name == "Conv_0":
            conv("classifier.", p)
            continue
        kind, _, idx = name.rpartition("_")
        if kind != "ConvBNRelu":
            raise KeyError(f"unknown SegNet layer {name!r}")
        pre = f"blocks.{int(idx)}."
        conv(pre + "conv.", p["Conv_0"])
        bn, stats = p["BatchNorm_0"], batch_stats[name]["BatchNorm_0"]
        state[pre + "bn.scale"] = _f32(bn["scale"])
        state[pre + "bn.bias"] = _f32(bn["bias"])
        state[pre + "bn.mean"] = _f32(stats["mean"])
        state[pre + "bn.var"] = _f32(stats["var"])
    return state


def segnet_state_to_flax(state: Mapping[str, torch.Tensor]
                         ) -> tuple[dict, dict]:
    """The inverse of :func:`segnet_state_from_flax`: the port's
    ``SegNet.state_dict()`` -> Flax's ``(params, batch_stats)``, nested
    dicts of float32 numpy arrays. ``blocks.<i>`` becomes ``ConvBNRelu_<i>``
    and the classifier ``Conv_0``; OIHW kernels become HWIO."""
    params: dict = {}
    batch_stats: dict = {}

    def f32(t):
        return t.detach().cpu().float().numpy()

    def conv(prefix):
        return {"kernel": f32(state[prefix + "weight"].permute(2, 3, 1, 0)),
                "bias": f32(state[prefix + "bias"])}

    params["Conv_0"] = conv("classifier.")
    n_blocks = 1 + max(int(k.split(".")[1]) for k in state
                       if k.startswith("blocks."))
    for i in range(n_blocks):
        pre = f"blocks.{i}."
        params[f"ConvBNRelu_{i}"] = {
            "Conv_0": conv(pre + "conv."),
            "BatchNorm_0": {"scale": f32(state[pre + "bn.scale"]),
                            "bias": f32(state[pre + "bn.bias"])}}
        batch_stats[f"ConvBNRelu_{i}"] = {"BatchNorm_0": {
            "mean": f32(state[pre + "bn.mean"]),
            "var": f32(state[pre + "bn.var"])}}
    return params, batch_stats
