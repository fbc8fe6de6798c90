"""Synthetic stereo world with exact ground truth.

Counterpart of ``semantic_slam_mapping_tpu/io/synthetic.py``: a ray-cast
renderer over a ground plane, boxes and a backdrop, giving photoconsistent
stereo pairs with ground-truth poses, depth, semantics and moving-object
masks; a straight street and a circular loop course with its world. It is
the port's own source of KITTI-size frames. :func:`make_world` and
:func:`make_loop_world` draw from a ``torch.Generator`` (it cannot replay
``jax.random``), so their worlds follow the same recipe with other draws;
:func:`render` takes any world's arrays, so a JAX-made world renders here
too: :func:`load_world_json` reads one that ``tools/torch_golden_world.py``
exported.

Conventions: camera x right, y down, z forward; world = first camera.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from semantic_slam_mapping_torch.geometry import se3
from semantic_slam_mapping_torch.geometry.camera import Intrinsics, pixel_grid
from semantic_slam_mapping_torch.mapping import semantics as _semcls

# the SegNet class ids, so that ground-truth labels and the map's class
# filters agree
CLASS_SKY = _semcls.SKY
CLASS_BUILDING = _semcls.BUILDING
CLASS_ROAD = _semcls.ROAD
CLASS_CAR = _semcls.VEHICLE
CLASS_PEDESTRIAN = _semcls.PEDESTRIAN


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


def _moving_boxes(mx, mz, is_ped, ground):
    """Standing boxes of movers: pedestrians (0.6 x 1.8 x 0.6 m) and cars
    (2 x 1.5 x 3.2 m) at ground positions (mx, mz)."""
    half = torch.where(is_ped[:, None],
                       torch.tensor([[0.3, 0.9, 0.3]], device=mx.device),
                       torch.tensor([[1.0, 0.75, 1.6]], device=mx.device))
    mmin = torch.stack([mx - half[:, 0], ground - 2 * half[:, 1],
                        mz - half[:, 2]], -1)
    mmax = torch.stack([mx + half[:, 0], torch.full_like(mx, ground + 0.01),
                        mz + half[:, 2]], -1)
    cls = torch.where(is_ped, CLASS_PEDESTRIAN, CLASS_CAR).long()
    return torch.stack([mmin, mmax], 1), cls


def make_world(generator: torch.Generator, n_boxes: int = 12,
               camera_height: float = 1.65, backdrop_z: float = 120.0,
               with_moving_box: bool = False, n_moving: int = 0,
               device: str | torch.device = "cuda") -> World:
    """Random street: boxes standing on the ground on both sides of a
    corridor the camera drives through; ``with_moving_box`` adds a car in
    the corridor ahead, moving laterally; ``n_moving`` adds that many
    independently moving cars and pedestrians along the corridor."""
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

    if n_moving > 0:
        mz = torch.linspace(12.0, 60.0, n_moving, device=gdev) \
            + uniform((n_moving,), -2.0, 2.0)
        mx = uniform((n_moving,), -2.5, 2.5)
        is_ped = torch.arange(n_moving, device=gdev) % 3 == 2
        # pedestrians stay near (5-20 m)
        mz = torch.where(is_ped, 5.0 + 0.3 * (mz - 12.0), mz)
        mboxes, mcls = _moving_boxes(mx, mz, is_ped, ground)
        boxes = torch.cat([boxes, mboxes])
        box_class = torch.cat([box_class, mcls])
        # cars drive along z (with or against the camera), pedestrians
        # cross
        vz = torch.where(is_ped, 0.0, uniform((n_moving,), -0.5, 0.6))
        vx = torch.where(is_ped, 0.25, 0.05 * torch.sign(mx))
        vel = torch.cat([vel, torch.stack([vx, torch.zeros_like(vx), vz],
                                          -1)])

    moving = with_moving_box or n_moving > 0
    return World(boxes.to(device), box_class.to(device),
                 torch.tensor(ground, device=device),
                 torch.tensor(float(backdrop_z), device=device),
                 vel.to(device) if moving else None)


def make_loop_world(generator: torch.Generator, n_boxes: int = 48,
                    radius: float = 30.0, camera_height: float = 1.65,
                    corridor: float = 3.5, n_moving: int = 0,
                    backdrop_z: float = 1500.0,
                    device: str | torch.device = "cuda") -> World:
    """World for :func:`loop_trajectory`: half the boxes are wall segments
    lining both sides of the ring (elongated along it, nearly touching,
    so every view has near-field structure), the rest scattered inside
    and outside it, plus ``n_moving`` cars and pedestrians on the ring's
    first half. The backdrop sits at 1.5 km, where the texture's level of
    detail flattens it."""
    gdev = generator.device
    pi = float(np.pi)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=gdev)

    ground = float(camera_height)
    n_wall = n_boxes // 2
    n_scatter = n_boxes - n_wall
    # wall segments: alternately inner and outer, evenly spaced
    wang = torch.arange(n_wall, device=gdev) * (2.0 * pi / n_wall) \
        + uniform((n_wall,), -0.04, 0.04)
    w_inner = torch.arange(n_wall, device=gdev) % 2 == 0
    wdr = uniform((n_wall,), corridor + 2.0, corridor + 5.0)
    wr = torch.clamp(torch.where(w_inner, radius - wdr, radius + wdr),
                     min=2.0)
    wcx = radius - wr * torch.cos(wang)
    wcz = wr * torch.sin(wang)
    seg_len = 2.0 * pi * radius / n_wall * uniform((n_wall,), 0.45, 0.7)
    seg_th = uniform((n_wall,), 0.5, 1.0)
    seg_h = uniform((n_wall,), 2.5, 5.0)
    # axis-aligned boxes: extents from the tangent's projection
    tx, tz = torch.abs(torch.sin(wang)), torch.abs(torch.cos(wang))
    whx = 0.5 * (seg_len * tx + seg_th * (1 - tx))
    whz = 0.5 * (seg_len * tz + seg_th * (1 - tz))
    wall_boxes = _standing_boxes(wcx, wcz,
                                 torch.stack([whx, seg_h * 0.5, whz], -1),
                                 ground)

    ang = uniform((n_scatter,), 0.0, 2.0 * pi)
    inner = uniform((n_scatter,), 0.0, 1.0) < 0.5
    dr = uniform((n_scatter,), corridor + 1.5, corridor + 13.0)
    r = torch.clamp(torch.where(inner, radius - dr, radius + dr), min=2.0)
    w = uniform((n_scatter, 3), 1.0, 4.0) * torch.tensor([1.0, 1.5, 1.0],
                                                         device=gdev)
    boxes = torch.cat([wall_boxes,
                       _standing_boxes(radius - r * torch.cos(ang),
                                       r * torch.sin(ang), w, ground)])
    box_class = torch.full((n_boxes,), CLASS_BUILDING, dtype=torch.int64,
                           device=gdev)
    vel = torch.zeros((n_boxes, 3), device=gdev)

    if n_moving > 0:
        mang = torch.linspace(0.15, pi, n_moving, device=gdev) \
            + uniform((n_moving,), -0.05, 0.05)
        is_ped = torch.arange(n_moving, device=gdev) % 3 == 2
        mboxes, mcls = _moving_boxes(radius - radius * torch.cos(mang),
                                     radius * torch.sin(mang), is_ped, ground)
        boxes = torch.cat([boxes, mboxes])
        box_class = torch.cat([box_class, mcls])
        # cars drift along the ring's tangent (sin, cos), pedestrians
        # cross it
        speed = torch.where(is_ped, 0.12, uniform((n_moving,), 0.2, 0.5))
        tx, tz = torch.sin(mang), torch.cos(mang)
        vx = torch.where(is_ped, 0.12 * tz, speed * tx)
        vz = torch.where(is_ped, -0.12 * tx, speed * tz)
        vel = torch.cat([vel, torch.stack([vx, torch.zeros_like(vx), vz],
                                          -1)])

    return World(boxes.to(device), box_class.to(device),
                 torch.tensor(ground, device=device),
                 torch.tensor(float(backdrop_z), device=device),
                 vel.to(device) if n_moving > 0 else None)


def load_world_json(path, device: str | torch.device = "cuda") -> World:
    """A world written by ``tools/torch_golden_world.py`` (the JAX
    package's ``make_loop_world`` draw, float32 values exact in the JSON).
    A missing file raises; no world is drawn in its place."""
    # convert imports World from this module
    from semantic_slam_mapping_torch.utils.convert import world_from_numpy

    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(
            f"no world file {path}: export the JAX package's worlds with "
            "`python tools/torch_golden_world.py` (on the CPU, with JAX)")
    d = json.loads(path.read_text())
    vel = d["box_velocity"]
    return world_from_numpy(
        np.asarray(d["boxes"], np.float32),
        np.asarray(d["box_class"], np.int64),
        np.float32(d["ground_y"]), np.float32(d["backdrop_z"]),
        None if vel is None else np.asarray(vel, np.float32),
        device=device)


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


def _angles(stop: float, n: int, device: str | torch.device) -> torch.Tensor:
    """``jnp.linspace(0, stop, n)`` as XLA computes it, to the bit: the
    division by n - 1 folded into a reciprocal and the products
    reassociated, (stop * float32(1 / (n - 1))) * i, then stop itself.
    ``torch.linspace`` rounds otherwise: an ulp of the angle, 1.4e-5 m on
    a 30 m circle."""
    b = torch.tensor(stop, dtype=torch.float32, device=device)
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    r = torch.tensor(1.0, dtype=torch.float32, device=device) / (n - 1)
    i = torch.arange(n - 1, dtype=torch.float32, device=device)
    return torch.cat([(b * r) * i, b[None]])


def loop_trajectory(n_frames: int, radius: float = 30.0,
                    laps: float = 1.2, pitch_amp: float = 0.0,
                    revisit_offset: float = 0.0,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """(N, 4, 4) poses driving a circle of ``radius`` (centre to the
    camera's right), heading along the tangent; ``laps`` > 1 revisits the
    start. ``pitch_amp`` adds a sinusoidal platform pitch (rad);
    ``revisit_offset`` (m) widens the radius on the second lap (a
    smoothstep over 1/16 lap past 2 pi), so the revisit runs in a parallel
    lane."""
    pi = float(np.pi)
    th = _angles(2.0 * pi * laps, n_frames, device)
    ramp = torch.clamp((th - 2.0 * pi) / (pi / 8.0), 0.0, 1.0)
    r_eff = radius + revisit_offset * (ramp * ramp * (3.0 - 2.0 * ramp))
    pos = torch.stack([radius - r_eff * torch.cos(th), torch.zeros_like(th),
                       r_eff * torch.sin(th)], dim=-1)
    pitch = pitch_amp * torch.sin(th * 7.0)
    cy, sy = torch.cos(th), torch.sin(th)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    one, zero = torch.ones_like(th), torch.zeros_like(th)
    Ry = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    Rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cp, -sp], -1),
                      torch.stack([zero, sp, cp], -1)], -2)
    return se3.make(Ry @ Rx, pos)


def render_sequence(K: Intrinsics, world: World, poses_w_c: torch.Tensor,
                    height: int, width: int, start_index: int = 0) -> dict:
    """Render a stereo sequence: a dict of stacked left/right (F, H, W)
    images, left-camera depth/semantic/moving, and the poses.
    ``start_index`` offsets the movers' time base, so a long sequence can
    be rendered in chunks."""
    frames = []
    for i in range(poses_w_c.shape[0]):
        offs = (world.box_velocity * float(start_index + i)
                if world.box_velocity is not None else None)
        T = poses_w_c[i]
        left, depth, sem, mov = render(K, T, world, height, width, offs)
        right = render(K, right_camera_pose(T, K.baseline), world, height,
                       width, offs)[0]
        frames.append((left, right, depth, sem, mov))
    left, right, depth, sem, mov = (torch.stack(x) for x in zip(*frames))
    return dict(left=left, right=right, depth=depth, semantic=sem,
                moving=mov, poses=poses_w_c)
