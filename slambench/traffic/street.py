"""The long straight street that the stereo cells drive: world, ground
truth and rendered KITTI-size stereo pairs, all drawn from the seed.

A copy of the port's ``io/synthetic`` renderer (ray-cast ground plane,
boxes and backdrop; fractal value-noise texture with level of detail;
class-correlated albedo), extended for a street of any length:

- boxes stand on both sides of the whole street at a fixed density, one
  in each slot of the street's length on each side, each clear of a
  corridor around the camera's path (today's ``make_world`` draws them
  only 6-90 m ahead, anywhere in that stretch, and some reach into the
  camera's path); so every seed's street holds the same amount;
- movers are spread along it: cars in the lanes beside the camera's,
  driving with or against it, and pedestrians walking on the pavements;
- the backdrop stands far beyond the street's end, where the texture's
  level of detail flattens it;
- each chunk of frames is rendered against the boxes it can see only, so a
  frame costs what a frame of today's street costs.

Camera conventions as the port's: x right, y down, z forward; the world is
the first camera's frame; the right camera sits ``baseline`` along x.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# SegNet class ids (CamVid order, as the port's mapping/semantics): road,
# building, vehicle, pedestrian; they set each surface's albedo
ROAD, BUILDING, VEHICLE, PEDESTRIAN = 4, 1, 9, 10

_OCTAVES = (  # (cells per metre, amplitude, phase u, phase w)
    (0.25, 0.16, 0.0, 7.3),
    (0.70, 0.20, 3.1, 1.7),
    (2.00, 0.24, 9.2, 4.8),
    (5.50, 0.30, 1.3, 6.1),
    (15.0, 0.36, 5.7, 2.9),
    (40.0, 0.36, 8.4, 0.6),
)
_ALBEDO = ((ROAD, 0.45, 0.25), (VEHICLE, 0.30, 0.45),
           (PEDESTRIAN, 0.25, 0.02))


def _value_noise(u, v):
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


def _texture(p, footprint):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    u, w = x + 0.83 * y, z + 0.61 * y
    v = torch.zeros_like(x)
    for f, a, pu, pw in _OCTAVES:
        wavelength = 2.0 / f
        lod = torch.sigmoid((wavelength * 0.25 - footprint)
                            / (wavelength / 12.0))
        v = v + a * lod * _value_noise(f * u + pu, f * w + pw)
    return 0.5 + 0.5 * torch.tanh(1.8 * v)


def _plane_hit(dist, d):
    t = dist / torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    return torch.where(t > 1e-3, t, float("inf"))


def _cast(cam: dict, origins: torch.Tensor, boxes: torch.Tensor,
          ground_y: float, backdrop_z: float):
    """Rays of V views from camera centres ``origins`` (V, 3) looking along
    +z (no rotation) against the ground, the backdrop and boxes (V, N, 2, 3)
    [min, max]: (ray directions (H, W, 3) with z = 1, so that a hit's
    distance is its depth; the depth (V, H, W), inf for the sky; the
    primitive hit, 0 ground, 1 backdrop, 2 a box; the box's index)."""
    H, W = cam["height"], cam["width"]
    dev = origins.device
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    d = torch.stack([((u - cam["cx"]) / cam["fx"]).expand(H, W),
                     ((v - cam["cy"]) / cam["fy"]).expand(H, W),
                     torch.ones((H, W), device=dev)], dim=-1)     # (H, W, 3)
    o = origins[:, None, None, :]                                 # (V,1,1,3)
    t_ground = _plane_hit(ground_y - o[..., 1], d[..., 1])
    t_back = _plane_hit(backdrop_z - o[..., 2], d[..., 2])
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-9,
                              torch.full_like(d, 1e-9), d)
    t_box = torch.full_like(t_ground, float("inf"))
    box_id = torch.zeros(t_ground.shape, dtype=torch.long, device=dev)
    for n in range(boxes.shape[1]):
        lo = boxes[:, n, 0][:, None, None, :]
        hi = boxes[:, n, 1][:, None, None, :]
        t0, t1 = (lo - o) * inv_d, (hi - o) * inv_d
        near = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=1e-3)
        far = torch.maximum(t0, t1).amin(dim=-1)
        t = torch.where(far >= near, near, float("inf"))
        closer = t < t_box
        t_box = torch.where(closer, t, t_box)
        box_id = torch.where(closer, n, box_id)
    t_hit, prim = torch.stack([t_ground, t_back, t_box], dim=-1).min(dim=-1)
    return d, t_hit, prim, box_id


def render(cam: dict, origins: torch.Tensor, boxes: torch.Tensor,
           box_class: torch.Tensor, ground_y: float, backdrop_z: float
           ) -> torch.Tensor:
    """Intensity (V, H, W) in [0, 1] of V views from camera centres
    ``origins`` (V, 3) looking along +z (no rotation), against boxes
    (V, N, 2, 3) [min, max] with classes (V, N)."""
    d, t_hit, prim, box_id = _cast(cam, origins, boxes, ground_y, backdrop_z)
    o = origins[:, None, None, :]
    sky = ~torch.isfinite(t_hit)
    p = o + d * torch.where(sky, 0.0, t_hit)[..., None]
    intensity = _texture(p, torch.where(sky, 0.0, t_hit) / cam["fx"])
    box_sem = torch.gather(box_class, 1, box_id.reshape(len(origins), -1)
                           ).reshape(box_id.shape)
    sem = torch.where(prim == 0, ROAD, torch.where(prim == 1, BUILDING,
                                                   box_sem))
    gain, bias = torch.ones_like(intensity), torch.zeros_like(intensity)
    for cls, g, b in _ALBEDO:
        gain = torch.where(sem == cls, g, gain)
        bias = torch.where(sem == cls, b, bias)
    intensity = torch.clamp(bias + gain * intensity, 0.0, 1.0)
    return torch.where(sky, 0.55, intensity)


def make_world(seed: int, p: dict, device) -> dict:
    """The street's boxes and movers from ``seed`` and the traffic's
    parameters: numpy arrays (boxes (N, 2, 3), classes, movers (M, 2, 3)
    at frame 0, their classes and velocities in metres a frame)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def uniform(n, lo, hi, k=1):
        return lo + (hi - lo) * torch.rand((n, k), generator=g,
                                           device=device)

    ground = float(p["camera_height_m"])
    length = p["speed_m"] * (p["frames"] - 1) + p["view_m"]
    z0 = p["box_z_start_m"]
    # one box a slot on each side, jittered within it: every stretch of the
    # street holds as much as any other, whatever the seed
    per_side = int(round(p["box_density_per_m"] * (length - z0) / 2))
    n = 2 * per_side
    slot = (length - z0) / per_side
    side = torch.cat([torch.ones(per_side, device=device),
                      -torch.ones(per_side, device=device)])
    half = uniform(n, 1.0, 4.0, 3) * torch.tensor([1.0, 1.5, 1.0],
                                                  device=device)
    cx = side * (p["corridor_m"] + half[:, 0]
                 + uniform(n, 0.0, p["box_spread_m"])[:, 0])
    k = torch.arange(per_side, device=device).repeat(2)
    cz = z0 + slot * (k + uniform(n, 0.0, 1.0)[:, 0])
    lo = torch.stack([cx - half[:, 0], ground - 2 * half[:, 1],
                      cz - half[:, 2]], -1)
    hi = torch.stack([cx + half[:, 0], torch.full_like(cx, ground + 0.01),
                      cz + half[:, 2]], -1)
    boxes = torch.stack([lo, hi], 1)

    m = int(length // p["mover_spacing_m"])
    mz = torch.arange(m, device=device) * p["mover_spacing_m"] + 12.0 \
        + uniform(m, -2.0, 2.0)[:, 0]
    is_ped = torch.arange(m, device=device) % 3 == 2
    mside = torch.where(uniform(m, 0, 1) < 0.5, 1.0, -1.0)[:, 0]
    mx = mside * torch.where(is_ped, p["pavement_x_m"], p["lane_x_m"])
    mhalf = torch.where(is_ped[:, None],
                        torch.tensor([[0.3, 0.9, 0.3]], device=device),
                        torch.tensor([[1.0, 0.75, 1.6]], device=device))
    mlo = torch.stack([mx - mhalf[:, 0], ground - 2 * mhalf[:, 1],
                       mz - mhalf[:, 2]], -1)
    mhi = torch.stack([mx + mhalf[:, 0], torch.full_like(mx, ground + 0.01),
                       mz + mhalf[:, 2]], -1)
    vz = torch.where(is_ped, uniform(m, -0.1, 0.1)[:, 0],
                     uniform(m, -p["car_speed_m"], p["car_speed_m"])[:, 0])
    vel = torch.stack([torch.zeros_like(vz), torch.zeros_like(vz), vz], -1)
    return {"boxes": boxes.cpu().numpy(),
            "box_class": np.full(n, BUILDING, np.int64),
            "movers": torch.stack([mlo, mhi], 1).cpu().numpy(),
            "mover_class": torch.where(is_ped, PEDESTRIAN, VEHICLE)
            .cpu().numpy(),
            "mover_velocity": vel.cpu().numpy(),
            "ground_y": ground, "backdrop_z": float(p["backdrop_z_m"])}


def poses(p: dict) -> np.ndarray:
    """(F, 4, 4) float64 camera-to-world poses: straight ahead along z."""
    T = np.tile(np.eye(4), (p["frames"], 1, 1))
    T[:, 2, 3] = p["speed_m"] * np.arange(p["frames"])
    return T


def _boxes_in_view(world: dict, frames: np.ndarray, z_lo: float,
                   z_hi: float, device):
    """The boxes of the frames ``frames``, the static ones and the movers
    where each frame has them, that reach into [z_lo, z_hi]: (boxes
    (F', N, 2, 3), classes (N,), whether each is a mover (N,))."""
    static = torch.as_tensor(world["boxes"], dtype=torch.float32,
                             device=device)
    movers = torch.as_tensor(world["movers"], dtype=torch.float32,
                             device=device)
    mvel = torch.as_tensor(world["mover_velocity"], dtype=torch.float32,
                           device=device)
    cls = torch.as_tensor(np.concatenate([world["box_class"],
                                          world["mover_class"]]),
                          device=device)
    moving = torch.arange(len(cls), device=device) >= len(static)
    idx = torch.as_tensor(frames, dtype=torch.float32, device=device)
    frame_boxes = torch.cat([
        static[None].expand(len(idx), -1, -1, -1),
        movers[None] + (idx[:, None, None] * mvel[None])[:, :, None]],
        dim=1)                                            # (F', N, 2, 3)
    hi_z = frame_boxes[..., 1, 2].amax(dim=0)
    lo_z = frame_boxes[..., 0, 2].amin(dim=0)
    keep = (hi_z > z_lo) & (lo_z < z_hi)
    return frame_boxes[:, keep], cls[keep], moving[keep]


def render_street(cam: dict, p: dict, world: dict, device
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Host float32 (F, H, W) left and right images, rendered in chunks of
    ``render_chunk`` frames against the boxes in view of the chunk."""
    F, chunk = p["frames"], p["render_chunk"]
    H, W = cam["height"], cam["width"]
    z = p["speed_m"] * np.arange(F)
    lefts = np.empty((F, H, W), np.float32)
    rights = np.empty((F, H, W), np.float32)
    for a in range(0, F, chunk):
        b = min(F, a + chunk)
        fb, fc, _ = _boxes_in_view(world, np.arange(a, b), z[a] + 0.05,
                                   z[b - 1] + p["view_m"], device)
        fc = fc[None].expand(b - a, -1)
        cz = torch.as_tensor(z[a:b], dtype=torch.float32, device=device)
        zeros = torch.zeros_like(cz)
        left_o = torch.stack([zeros, zeros, cz], -1)
        right_o = torch.stack([zeros + cam["baseline"], zeros, cz], -1)
        img = render(cam, torch.cat([left_o, right_o]),
                     torch.cat([fb, fb]), torch.cat([fc, fc]),
                     world["ground_y"], world["backdrop_z"])
        img = img.cpu().numpy()
        lefts[a:b], rights[a:b] = img[:b - a], img[b - a:]
    return lefts, rights


def static_mask(cam: dict, p: dict, world: dict, frame: int, device
                ) -> np.ndarray:
    """Whether each pixel of the left camera of frame ``frame`` shows a
    static surface (the ground, the backdrop or a box that does not move):
    host (H, W) bools."""
    z = p["speed_m"] * frame
    fb, _, moving = _boxes_in_view(world, np.array([frame]), z + 0.05,
                                   z + p["view_m"], device)
    origin = torch.tensor([[0.0, 0.0, z]], dtype=torch.float32,
                          device=device)
    _, _, prim, box_id = _cast(cam, origin, fb, world["ground_y"],
                               world["backdrop_z"])
    mover = (prim == 2) & moving[box_id] if len(moving) else prim < 0
    return (~mover[0]).cpu().numpy()
