"""The port's synthetic street against the JAX renderer: a JAX-made world
carried across by ``utils/convert.py`` renders the same depth (rtol 1e-5),
semantics and moving mask (exact); the texture hashes sin() of large
arguments, which the two libraries round apart, so intensities agree to
1e-2 on 99% of pixels. Trajectories and the right camera agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.geometry import se3 as jse3
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_torch.io import synthetic as tsyn
from semantic_slam_mapping_torch.utils import convert
from torch_parity_scene import JK_, TK, H, W, to_np

torch.set_num_threads(2)


def test_render_matches_jax_with_world_carried_across():
    world = jsyn.make_world(jax.random.PRNGKey(3), n_boxes=14,
                            with_moving_box=True)
    pose = np.array(jsyn.straight_trajectory(3, speed=0.3,
                                             yaw_rate=0.01)[2])
    offs = world.box_velocity * 2.0
    render = jax.jit(jsyn.render, static_argnums=(3, 4))
    img_j, depth_j, sem_j, mov_j = map(np.asarray, render(
        JK_, jnp.asarray(pose), world, H, W, offs))
    tw = convert.world_from_numpy(
        *(None if v is None else np.asarray(v) for v in world), device="cpu")
    img, depth, sem, mov = tsyn.render(TK, torch.from_numpy(pose), tw, H, W,
                                       tw.box_velocity * 2.0)
    np.testing.assert_array_equal(to_np(sem), sem_j)
    np.testing.assert_array_equal(to_np(mov), mov_j)
    assert mov_j.sum() > 0
    np.testing.assert_allclose(to_np(depth), depth_j, rtol=1e-5, atol=1e-4)
    diff = np.abs(to_np(img) - img_j)
    assert diff.mean() < 1e-3 and np.mean(diff < 1e-2) > 0.99


def test_trajectory_and_world_match_jax():
    traj_j = np.asarray(jsyn.straight_trajectory(5, speed=0.3,
                                                 yaw_rate=0.01))
    traj = tsyn.straight_trajectory(5, 0.3, 0.01, device="cpu")
    np.testing.assert_allclose(to_np(traj), traj_j, atol=1e-5)
    right_j = jse3.compose(jnp.asarray(traj_j[2]), jse3.make(
        jnp.eye(3), jnp.asarray([TK.baseline, 0.0, 0.0])))
    np.testing.assert_allclose(
        to_np(tsyn.right_camera_pose(traj[2], TK.baseline)),
        np.asarray(right_j), atol=1e-6)

    def world():
        return tsyn.make_world(torch.Generator().manual_seed(1), n_boxes=6,
                               with_moving_box=True, device="cpu")
    a, b = world(), world()
    assert a.boxes.shape == (7, 2, 3) and a.box_velocity.shape == (7, 3)
    torch.testing.assert_close(a.boxes, b.boxes, rtol=0, atol=0)
    assert int(a.box_class[-1]) == tsyn.CLASS_CAR
