"""Parity of the port's geometry (se3, camera, stereo) with the JAX package.

Inputs are drawn with numpy and handed to both. Tolerance: 1e-5 absolute
on unit-scale float32 quantities (a few ulps of the same formulas, taken in
another operation order); pixel coordinates, which carry fx ~ 700, get
1e-3 px.
"""

import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.config import CameraConfig as JCam
from semantic_slam_mapping_tpu.geometry import camera as jcam
from semantic_slam_mapping_tpu.geometry import se3 as jse3
from semantic_slam_mapping_tpu.geometry import stereo as jstereo
from semantic_slam_mapping_torch.config import CameraConfig as TCam
from semantic_slam_mapping_torch.geometry import camera as tcam
from semantic_slam_mapping_torch.geometry import se3 as tse3
from semantic_slam_mapping_torch.geometry import stereo as tstereo

torch.set_num_threads(2)
ATOL = 1e-5
RNG = np.random.default_rng(0)
XI = (RNG.normal(size=(16, 6)) * 0.8).astype(np.float32)
XI[0, 3:] = 0.0                      # pure translation: the small-angle path
PTS = RNG.uniform(-5, 5, (32, 3)).astype(np.float32)
PTS[:, 2] = np.abs(PTS[:, 2]) + 2.0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


SE3_CASES = ["exp", "log_of_exp", "so3_exp", "hat", "inverse", "compose",
             "orthonormalize", "transform_points"]


def _se3_case(name):
    """(JAX result, port result, atol) of one se3 function on XI / PTS."""
    xi_j, xi_t = jnp.asarray(XI), torch.from_numpy(XI)
    if name == "exp":
        return jse3.exp(xi_j), tse3.exp(xi_t), ATOL
    if name == "log_of_exp":
        # log amplifies the rotation's rounding near |w| ~ pi
        return jse3.log(jse3.exp(xi_j)), tse3.log(tse3.exp(xi_t)), 1e-4
    if name == "so3_exp":
        return jse3.so3_exp(xi_j[:, 3:]), tse3.so3_exp(xi_t[:, 3:]), ATOL
    if name == "hat":
        return jse3.hat(xi_j[:, :3]), tse3.hat(xi_t[:, :3]), ATOL
    if name == "inverse":
        return (jse3.inverse(jse3.exp(xi_j)), tse3.inverse(tse3.exp(xi_t)),
                ATOL)
    if name == "compose":
        return (jse3.compose(jse3.exp(xi_j), jse3.exp(xi_j[::-1])),
                tse3.compose(tse3.exp(xi_t), tse3.exp(xi_t.flip(0))), ATOL)
    if name == "orthonormalize":
        noisy = (np.random.default_rng(5).normal(size=(16, 4, 4)) * 1e-3
                 ).astype(np.float32)
        Tj = jse3.exp(xi_j) + jnp.asarray(noisy)
        return (jse3.orthonormalize(Tj),
                tse3.orthonormalize(torch.from_numpy(np.array(Tj))), ATOL)
    return (jse3.transform_points(jse3.exp(xi_j[1]), jnp.asarray(PTS)),
            tse3.transform_points(tse3.exp(xi_t[1]), torch.from_numpy(PTS)),
            ATOL)


def test_se3_matches_jax():
    for name in SE3_CASES:
        a, b, atol = _se3_case(name)
        np.testing.assert_allclose(_np(a), _np(b), atol=atol, err_msg=name)
    assert tse3.identity(device="cpu").device.type == "cpu"
    np.testing.assert_array_equal(tse3.identity(device="cpu").numpy(),
                                  np.eye(4, dtype=np.float32))


CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
           baseline=0.5323, roix=20.0, roiy=5.0, roiz=40.0)


CAMERA_CASES = ["project", "project_stereo", "triangulate_stereo",
                "backproject", "pixel_grid"]


def _camera_case(name, Kj, Kt):
    pj, pt = jnp.asarray(PTS), torch.from_numpy(PTS)
    rng = np.random.default_rng(6)
    uv = rng.uniform(0, 1000, (32, 2)).astype(np.float32)
    dd = rng.uniform(1, 80, 32).astype(np.float32)
    if name == "project":
        return jcam.project(Kj, pj), tcam.project(Kt, pt)
    if name == "project_stereo":
        return jcam.project_stereo(Kj, pj), tcam.project_stereo(Kt, pt)
    if name == "triangulate_stereo":
        return (jcam.triangulate_stereo(Kj, jnp.asarray(uv), jnp.asarray(dd)),
                tcam.triangulate_stereo(Kt, torch.from_numpy(uv),
                                        torch.from_numpy(dd)))
    if name == "backproject":
        return (jcam.backproject(Kj, jnp.asarray(uv), jnp.asarray(dd)),
                tcam.backproject(Kt, torch.from_numpy(uv),
                                 torch.from_numpy(dd)))
    return jcam.pixel_grid(5, 7), tcam.pixel_grid(5, 7, device="cpu")


def test_camera_and_stereo_match_jax():
    Kj = jcam.Intrinsics.from_config(JCam(**CAM))
    Kt = tcam.Intrinsics.from_config(TCam(**CAM))
    for name in CAMERA_CASES:
        a, b = _camera_case(name, Kj, Kt)
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-3,
                                   err_msg=name)
    disp = np.random.default_rng(7).uniform(-1, 40, (24, 40)).astype(
        np.float32)
    a = jstereo.triangulate_image(Kj, jnp.asarray(disp), JCam(**CAM))
    b = tstereo.triangulate_image(Kt, torch.from_numpy(disp), TCam(**CAM))
    np.testing.assert_allclose(_np(a.xyz), _np(b.xyz), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(_np(a.valid), _np(b.valid))
    np.testing.assert_array_equal(_np(a.roi), _np(b.roi))
    ac = jstereo.correct_pitch(a, jnp.float32(0.03), JCam(**CAM))
    bc = tstereo.correct_pitch(b, torch.tensor(0.03), TCam(**CAM))
    np.testing.assert_allclose(_np(ac.xyz), _np(bc.xyz), rtol=1e-5,
                               atol=1e-4)
    # ROI membership may flip only for points within rounding of a bound
    assert (_np(ac.roi) != _np(bc.roi)).mean() < 1e-3
