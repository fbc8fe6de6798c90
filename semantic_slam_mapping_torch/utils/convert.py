"""State carried across from the JAX package, as plain functions of numpy
data (no JAX import): a config dict, intrinsics, a tracker state and a
synthetic world each become the port's counterpart. The ported slices have
no learned weights.
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
    """``dataclasses.asdict`` of a JAX ``SlamConfig`` -> the port's config.
    Sections the port does not read (map, SegNet, ...) are dropped; a field the port does
    not know raises."""
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
