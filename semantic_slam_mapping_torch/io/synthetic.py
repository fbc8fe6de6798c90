"""Synthetic stereo world with exact ground truth.

Counterpart of the street-world part of
``semantic_slam_mapping_tpu/io/synthetic.py``: a ray-cast renderer over a
ground plane, boxes and a backdrop, giving photoconsistent stereo pairs
with ground-truth poses, depth, semantics and moving-object masks. It is
the port's own source of KITTI-size frames. :func:`make_world` draws from
a ``torch.Generator`` (it cannot replay ``jax.random``); :func:`render`
takes any world's arrays, so a JAX-made world renders here too.

Conventions: camera x right, y down, z forward; world = first camera.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from semantic_slam_mapping_torch.geometry import se3
from semantic_slam_mapping_torch.geometry.camera import Intrinsics, pixel_grid

# CamVid/SegNet class ids, as the JAX package's mapping/semantics.py
CLASS_SKY = 0
CLASS_BUILDING = 1
CLASS_ROAD = 4
CLASS_CAR = 9
CLASS_PEDESTRIAN = 10   # only in worlds carried across from JAX


class World(NamedTuple):
    """Boxes (N, 2, 3) [min, max] world corners, their class ids (N,), the
    ground height and backdrop depth (0-d), and per-box velocities (N, 3)
    in units per frame (None: all static)."""

    boxes: torch.Tensor
    box_class: torch.Tensor
    ground_y: torch.Tensor
    backdrop_z: torch.Tensor
    box_velocity: Optional[torch.Tensor] = None


def _standing_boxes(cx, cz, w, ground):
    mins = torch.stack([cx - w[:, 0], ground - w[:, 1] * 2.0, cz - w[:, 2]],
                       dim=-1)
    maxs = torch.stack([cx + w[:, 0], torch.full_like(cx, ground + 0.01),
                        cz + w[:, 2]], dim=-1)
    return torch.stack([mins, maxs], dim=1)


def make_world(generator: torch.Generator, n_boxes: int = 12,
               camera_height: float = 1.65, backdrop_z: float = 120.0,
               with_moving_box: bool = False,
               device: str | torch.device = "cuda") -> World:
    """Random street: boxes standing on the ground on both sides of a
    corridor the camera drives through; ``with_moving_box`` adds a car in
    the corridor ahead, moving laterally."""
    gdev = generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=gdev)

    side = torch.where(uniform((n_boxes,), 0.0, 1.0) < 0.5, 1.0, -1.0)
    cx = side * uniform((n_boxes,), 4.0, 14.0)
    cz = uniform((n_boxes,), 6.0, 90.0)
    w = uniform((n_boxes, 3), 1.0, 4.0) * torch.tensor([1.0, 1.5, 1.0],
                                                        device=gdev)
    ground = float(camera_height)
    boxes = _standing_boxes(cx, cz, w, ground)
    box_class = torch.full((n_boxes,), CLASS_BUILDING, dtype=torch.int64,
                           device=gdev)
    vel = torch.zeros((n_boxes, 3), device=gdev)

    if with_moving_box:
        car = torch.tensor([[[-1.0, ground - 1.5, 14.0],
                             [1.0, ground, 17.0]]], device=gdev)
        boxes = torch.cat([boxes, car])
        box_class = torch.cat([box_class, torch.tensor([CLASS_CAR],
                                                       device=gdev)])
        vel = torch.cat([vel, torch.tensor([[0.35, 0.0, 0.1]], device=gdev)])

    return World(boxes.to(device), box_class.to(device),
                 torch.tensor(ground, device=device),
                 torch.tensor(float(backdrop_z), device=device),
                 vel.to(device) if with_moving_box else None)


def _value_noise(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-periodic value noise in [-1, 1] on the integer lattice of (u, v),
    smoothstep-interpolated."""
    ui, vi = torch.floor(u), torch.floor(v)
    uf, vf = u - ui, v - vi

    def rnd(cu, cv):
        h = torch.sin(cu * 127.1 + cv * 311.7) * 43758.5453
        return 2.0 * (h - torch.floor(h)) - 1.0

    wu = uf * uf * (3.0 - 2.0 * uf)
    wv = vf * vf * (3.0 - 2.0 * vf)
    n0 = rnd(ui, vi) * (1 - wu) + rnd(ui + 1, vi) * wu
    n1 = rnd(ui, vi + 1) * (1 - wu) + rnd(ui + 1, vi + 1) * wu
    return n0 * (1 - wv) + n1 * wv


_OCTAVES = (  # (cells per metre, amplitude, phase u, phase w)
    (0.25, 0.16, 0.0, 7.3),
    (0.70, 0.20, 3.1, 1.7),
    (2.00, 0.24, 9.2, 4.8),
    (5.50, 0.30, 1.3, 6.1),
    (15.0, 0.36, 5.7, 2.9),
    (40.0, 0.36, 8.4, 0.6),
)


def _texture(p: torch.Tensor,
             footprint: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fractal value-noise texture in [0, 1] of world points (…, 3); each
    octave fades out as the pixel footprint (metres) nears a quarter of its
    wavelength."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    u = x + 0.83 * y
    w = z + 0.61 * y
    v = torch.zeros_like(x)
    for f, a, pu, pw in _OCTAVES:
        wavelength = 2.0 / f
        lod = 1.0 if footprint is None else torch.sigmoid(
            (wavelength * 0.25 - footprint) / (wavelength / 12.0))
        v = v + a * lod * _value_noise(f * u + pu, f * w + pw)
    return 0.5 + 0.5 * torch.tanh(1.8 * v)


def _intersect_boxes(origin: torch.Tensor, direction: torch.Tensor,
                     boxes: torch.Tensor) -> torch.Tensor:
    """Slab-method ray/AABB distances (…, N), inf on a miss."""
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-9,
                              torch.full_like(direction, 1e-9), direction)
    t0 = (boxes[:, 0, :] - origin) * inv_d[..., None, :]
    t1 = (boxes[:, 1, :] - origin) * inv_d[..., None, :]
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    t_near = torch.clamp(t_near, min=1e-3)
    return torch.where(t_far >= t_near, t_near, float("inf"))


def _plane_hit(dist: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    t = dist / torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    return torch.where(t > 1e-3, t, float("inf"))


def render(K: Intrinsics, T_w_c: torch.Tensor, world: World, height: int,
           width: int, box_offset: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, ...]:
    """Render one view from camera-to-world pose T_w_c (4, 4);
    ``box_offset`` (N, 3) moves the boxes for this frame. Returns
    (intensity (H, W) float, depth (H, W) camera z, semantic (H, W) int64,
    moving (H, W) bool)."""
    dev = T_w_c.device
    uv = pixel_grid(height, width, device=dev)
    d_cam = torch.stack([(uv[..., 0] - K.cx) / K.fx,
                         (uv[..., 1] - K.cy) / K.fy,
                         torch.ones((height, width), device=dev)], dim=-1)
    origin = T_w_c[:3, 3]
    d_world = d_cam @ T_w_c[:3, :3].T
    boxes = world.boxes if box_offset is None \
        else world.boxes + box_offset[:, None, :]

    t_ground = _plane_hit(world.ground_y - origin[1], d_world[..., 1])
    t_back = _plane_hit(world.backdrop_z - origin[2], d_world[..., 2])
    n_boxes = boxes.shape[0]
    if n_boxes > 0:
        t_boxes = _intersect_boxes(origin, d_world, boxes)
        t_box_min, box_id = t_boxes.min(dim=-1)
    else:
        t_box_min = torch.full((height, width), float("inf"), device=dev)
        box_id = torch.zeros((height, width), dtype=torch.int64, device=dev)
    t_hit, prim = torch.stack([t_ground, t_back, t_box_min], dim=-1).min(
        dim=-1)   # prim: 0 ground, 1 backdrop, 2 box

    p_world = origin + d_world * t_hit[..., None]
    sky = ~torch.isfinite(t_hit)
    footprint = torch.where(sky, 0.0, t_hit) / K.fx
    intensity = _texture(p_world, footprint=footprint)

    box_sem = world.box_class[box_id] if n_boxes > 0 else \
        torch.full((height, width), CLASS_BUILDING, device=dev)
    semantic = torch.where(prim == 0, CLASS_ROAD,
                           torch.where(prim == 1, CLASS_BUILDING, box_sem))
    semantic = torch.where(sky, CLASS_SKY, semantic).long()

    # class-correlated albedo (gain, bias)
    gain = torch.ones_like(intensity)
    bias = torch.zeros_like(intensity)
    for cls, g, b in ((CLASS_ROAD, 0.45, 0.25), (CLASS_CAR, 0.30, 0.45),
                      (CLASS_PEDESTRIAN, 0.25, 0.02)):
        sel = semantic == cls
        gain = torch.where(sel, g, gain)
        bias = torch.where(sel, b, bias)
    intensity = torch.clamp(bias + gain * intensity, 0.0, 1.0)
    intensity = torch.where(sky, 0.55, intensity)

    p_cam = se3.transform_points(se3.inverse(T_w_c), p_world.reshape(-1, 3))
    depth = torch.where(sky, 0.0, p_cam[:, 2].reshape(height, width))

    moving = torch.zeros((height, width), dtype=torch.bool, device=dev)
    if world.box_velocity is not None:
        is_moving = torch.any(world.box_velocity != 0.0, dim=-1)
        moving = (prim == 2) & is_moving[box_id] & ~sky
    return intensity, depth, semantic, moving


def right_camera_pose(T_w_cl: torch.Tensor, baseline: float) -> torch.Tensor:
    """Right camera = left shifted by +baseline along camera x."""
    shift = torch.eye(4, device=T_w_cl.device)
    shift[0, 3] = baseline
    return se3.compose(T_w_cl, shift)


def straight_trajectory(n_frames: int, speed: float = 0.8,
                        yaw_rate: float = 0.0,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """(N, 4, 4) camera-to-world poses: forward motion plus optional yaw."""
    step = se3.exp(torch.tensor([0.0, 0.0, speed, 0.0, yaw_rate, 0.0],
                                device=device))
    poses = [se3.identity(device=device)]
    for _ in range(n_frames - 1):
        poses.append(se3.compose(poses[-1], step))
    return torch.stack(poses)


def render_sequence(K: Intrinsics, world: World, poses_w_c: torch.Tensor,
                    height: int, width: int) -> dict:
    """Render a stereo sequence: a dict of stacked left/right (F, H, W)
    images, left-camera depth/semantic/moving, and the poses."""
    frames = []
    for i in range(poses_w_c.shape[0]):
        offs = (world.box_velocity * float(i)
                if world.box_velocity is not None else None)
        T = poses_w_c[i]
        left, depth, sem, mov = render(K, T, world, height, width, offs)
        right = render(K, right_camera_pose(T, K.baseline), world, height,
                       width, offs)[0]
        frames.append((left, right, depth, sem, mov))
    left, right, depth, sem, mov = (torch.stack(x) for x in zip(*frames))
    return dict(left=left, right=right, depth=depth, semantic=sem,
                moving=mov, poses=poses_w_c)
