"""Parity of the port's image primitives and connected components with the
JAX package.

The separable filters sum the same taps in the same order in float32, so
they are held to 1e-6 (absolute, on [0, 1] images). Connected-component
labels are integers and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.config import SgbmConfig as JSgbm
from semantic_slam_mapping_tpu.ops import components as jcc
from semantic_slam_mapping_tpu.ops import image as jim
from semantic_slam_mapping_tpu.ops import sgbm as jsgbm
from semantic_slam_mapping_torch.config import SgbmConfig as TSgbm
from semantic_slam_mapping_torch.ops import components as tcc
from semantic_slam_mapping_torch.ops import image as tim
from semantic_slam_mapping_torch.ops import sgbm as tsgbm

torch.set_num_threads(2)
RNG = np.random.default_rng(1)
IMG = RNG.uniform(0, 1, (48, 80)).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


FILTERS = {
    "gaussian_blur": lambda m, x: m.gaussian_blur(x, 1.0),
    "gaussian_blur_r1": lambda m, x: m.gaussian_blur(x, 0.8, radius=1),
    "box_blur": lambda m, x: m.box_blur(x, 5),
    "box_blur_11": lambda m, x: m.box_blur(x, 11),
    "gradients_x": lambda m, x: m.gradients(x)[0],
    "gradients_y": lambda m, x: m.gradients(x, smooth=False)[1],
    "downsample2": lambda m, x: m.downsample2(x),
    "pyramid_top": lambda m, x: m.build_pyramid(x, 3, 2.0)[2],
    "dilate": lambda m, x: m.dilate(x > 0.7, 3, iterations=2),
    "erode": lambda m, x: m.erode(x, 3),
}


def test_image_ops_match_jax():
    for name in sorted(FILTERS):
        f = FILTERS[name]
        a = _np(f(jim, jnp.asarray(IMG)))
        b = _np(f(tim, torch.from_numpy(IMG)))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)

    xy = RNG.uniform(-3, 85, (200, 2)).astype(np.float32)
    a = jim.bilinear_sample(jnp.asarray(IMG), jnp.asarray(xy), -2.0)
    b = tim.bilinear_sample(torch.from_numpy(IMG), torch.from_numpy(xy), -2.0)
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)

    # Otsu, on a plain image and on one with an empty gap between modes
    # (the plateau midpoint rule)
    bimodal = np.where(IMG > 0.5, 0.8 + 0.1 * IMG, 0.1 * IMG).astype(
        np.float32)
    for x in (IMG, bimodal):
        a = jim.otsu_threshold(jnp.asarray(x), 64, (0.0, 1.0))
        b = tim.otsu_threshold(torch.from_numpy(x), 64, (0.0, 1.0))
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)


def _same_from(valid):
    v = torch.from_numpy(valid)
    return (torch.roll(v, 1, 0), torch.roll(v, -1, 0),
            torch.roll(v, 1, 1), torch.roll(v, -1, 1))


def test_connected_components_match_jax():
    for density, sweeps in ((0.55, 4), (0.65, 2), (0.5, 16)):
        valid = RNG.uniform(size=(40, 56)) < density
        vj = jnp.asarray(valid)
        same_j = (jnp.roll(vj, 1, 0), jnp.roll(vj, -1, 0),
                  jnp.roll(vj, 1, 1), jnp.roll(vj, -1, 1))
        a = jcc.connected_components(vj, same_j, sweeps=sweeps)
        b = tcc.connected_components(torch.from_numpy(valid),
                                     _same_from(valid), sweeps=sweeps)
        np.testing.assert_array_equal(_np(a), _np(b),
                                      err_msg=f"{density} {sweeps}")
    _check_speckle_serpentine()


def _check_speckle_serpentine():
    """The serpentine of tests/test_sgbm.py: one 1-px-wide component whose
    runs chain through single-pixel connectors survives in both."""
    Hs, Ws = 40, 40
    disp = np.zeros((Hs, Ws), np.float32)
    valid = np.zeros((Hs, Ws), bool)
    for r in range(0, Hs, 2):
        valid[r, :] = True
        disp[r, :] = 10.0
        if r + 2 < Hs:
            c = Ws - 1 if (r // 2) % 2 == 0 else 0
            valid[r + 1, c] = True
            disp[r + 1, c] = 10.0
    jcfg = JSgbm(speckle_window_size=100, speckle_range=32)
    tcfg = TSgbm(speckle_window_size=100, speckle_range=32)
    a = _np(jsgbm._speckle_filter(jnp.asarray(disp), jnp.asarray(valid),
                                  jcfg))
    b = _np(tsgbm._speckle_filter(torch.from_numpy(disp),
                                  torch.from_numpy(valid), tcfg))
    np.testing.assert_array_equal(a, b)
    assert b[valid].all()
