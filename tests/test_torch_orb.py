"""Parity of the port's ORB features with the JAX package: the antialiased
resize, the 1.2x pyramid, the FAST and Harris responses (atol 1e-5 on
[0, 1] images), and ``orb.extract`` on a street frame: the valid keypoints
equal as sets, xy within 1e-4 px, angles within 1e-4 rad, at least 99.5%
of the descriptor bits equal (a bit can flip only where its two samples
are equal up to rounding), and the per-level budgets exact.
"""

import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.ops import corners as jcorners
from semantic_slam_mapping_tpu.ops import image as jim
from semantic_slam_mapping_tpu.ops import orb as jorb
from semantic_slam_mapping_torch import config as tcfg
from semantic_slam_mapping_torch.ops import corners as tcorners
from semantic_slam_mapping_torch.ops import image as tim
from semantic_slam_mapping_torch.ops import orb as torb
from torch_parity_scene import street_frames, to_np

torch.set_num_threads(2)


def test_resize_pyramid_and_responses_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (96, 190)).astype(np.float32)
    ji, ti = jnp.asarray(img), torch.from_numpy(img)
    # 1.2x and 2x down, ragged sizes, and an upscale
    for hw in ((80, 158), (48, 95), (67, 133), (31, 44), (120, 200)):
        np.testing.assert_allclose(to_np(tim.resize_bilinear(ti, hw)),
                                   to_np(jim.resize_bilinear(ji, hw)),
                                   atol=1e-5, err_msg=str(hw))
        np.testing.assert_array_equal(to_np(tim.resize_nearest(ti, hw)),
                                      to_np(jim.resize_nearest(ji, hw)))
    jp, tp = jim.build_pyramid(ji, 8, 1.2), tim.build_pyramid(ti, 8, 1.2)
    assert [p.shape for p in tp] == [p.shape for p in jp]
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(to_np(b), to_np(a), atol=1e-5)
    for th in (20 / 255.0, 7 / 255.0):
        np.testing.assert_allclose(to_np(tcorners.fast_response(ti, th)),
                                   to_np(jcorners.fast_response(ji, th)),
                                   atol=1e-5)
    np.testing.assert_allclose(to_np(tcorners.harris_response(ti)),
                               to_np(jcorners.harris_response(ji)),
                               atol=1e-5)


def test_extract_matches_jax():
    left = street_frames()["left"][0].astype(np.float32)
    # as rendered, and as a frame read from an 8-bit file (u8 * f32(1/255),
    # the JAX package's upload): quantised intensities make FAST score ties
    u8 = (np.clip(left, 0, 1) * 255 + 0.5).astype(np.uint8)
    quantised = u8.astype(np.float32) * np.float32(1.0 / 255.0)
    for n_features, n_levels in ((2000, 8), (256, 4)):
        jc = jcfg.OrbConfig(n_features=n_features, n_levels=n_levels)
        tc = tcfg.OrbConfig(n_features=n_features, n_levels=n_levels)
        assert (torb._level_budgets(n_features, n_levels, 1.2)
                == jorb._level_budgets(n_features, n_levels, 1.2))
        for img in (left, quantised):
            a = jorb.extract(jnp.asarray(img), jc)
            b = torb.extract(torch.from_numpy(img), tc)
            va, vb = to_np(a.valid), to_np(b.valid)
            assert va.sum() > 20
            xa, xb = to_np(a.xy)[va], to_np(b.xy)[vb]
            assert {tuple(p) for p in xa.round(3)} == \
                {tuple(p) for p in xb.round(3)}
            # same slots as well: the order is the per-level top-K's
            np.testing.assert_array_equal(va, vb)
            np.testing.assert_allclose(xb, xa, atol=1e-4)
            np.testing.assert_array_equal(to_np(b.level), to_np(a.level))
            np.testing.assert_allclose(to_np(b.angle)[vb], to_np(a.angle)[va],
                                       atol=1e-4)
            same = (to_np(b.desc) == to_np(a.desc))[va]
            assert same.mean() >= 0.995, same.mean()
            np.testing.assert_array_equal(to_np(b.desc)[~vb], 0)
