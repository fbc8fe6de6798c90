"""Parity of the port's GFTT, pyramidal KLT and quad matching with the JAX
package, on two frames of a synthetic street (the same numpy arrays to
both).

Tolerances: corner positions are integers and must be equal; tracked
positions agree to 1e-2 px (KLT iterates bilinear samples whose fractional
weights are rounded in another order), and since a few tracks may then
flip a gate, status and match masks must agree on >= 97% of slots.
"""

import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu.frontend import quadmatch as jqm
from semantic_slam_mapping_tpu.ops import corners as jcorners
from semantic_slam_mapping_tpu.ops import image as jim
from semantic_slam_mapping_tpu.ops import klt as jklt
from semantic_slam_mapping_torch.frontend import quadmatch as tqm
from semantic_slam_mapping_torch.ops import corners as tcorners
from semantic_slam_mapping_torch.ops import image as tim
from semantic_slam_mapping_torch.ops import klt as tklt
from torch_parity_scene import QCFG, TCFG, TK, street_frames, to_np

torch.set_num_threads(2)


def _pyr(m, img, lib):
    return tuple(m.build_pyramid(lib(img), 3, 2.0))


def test_gftt_and_klt_match_jax():
    frames = street_frames()
    lc, lp = frames["left"][1], frames["left"][0]
    a = jcorners.gftt(jnp.asarray(lc), max_corners=64)
    b = tcorners.gftt(torch.from_numpy(lc), max_corners=64)
    np.testing.assert_array_equal(to_np(a.valid), to_np(b.valid))
    np.testing.assert_array_equal(to_np(a.xy), to_np(b.xy))
    np.testing.assert_allclose(to_np(a.score), to_np(b.score), rtol=1e-5,
                               atol=1e-9)
    assert to_np(b.valid).sum() > 20

    pts = np.array(a.xy)
    for init in (None, (-3.0, 1.0)):
        ini = None if init is None else np.tile(np.float32(init), (64, 1))
        ka = jklt.track_pyramid(
            _pyr(jim, lc, jnp.asarray), _pyr(jim, lp, jnp.asarray),
            jnp.asarray(pts), init=None if ini is None else jnp.asarray(ini))
        kb = tklt.track_pyramid(
            _pyr(tim, lc, torch.from_numpy), _pyr(tim, lp, torch.from_numpy),
            torch.from_numpy(pts),
            init=None if ini is None else torch.from_numpy(ini))
        sa, sb = to_np(ka.status), to_np(kb.status)
        assert (sa == sb).mean() >= 0.97, init
        both = sa & sb
        assert both.sum() > 20, init
        np.testing.assert_allclose(to_np(ka.xy)[both], to_np(kb.xy)[both],
                                   atol=1e-2, err_msg=str(init))
        np.testing.assert_allclose(to_np(ka.error)[both],
                                   to_np(kb.error)[both], atol=1e-4,
                                   err_msg=str(init))


def test_quad_match_matches_jax():
    frames = street_frames()
    imgs = [frames["left"][1], frames["right"][1], frames["left"][0],
            frames["right"][0]]
    depth = frames["depth"][1]
    disp = np.where(depth > 0.5, TK.bf / np.maximum(depth, 0.5), 0.0)
    disp = disp.astype(np.float32)
    prior = np.float32([1.0, -0.5])
    a = jqm.quad_match(*map(jnp.asarray, imgs), qcfg=QCFG,
                       cur_disparity=jnp.asarray(disp),
                       flow_prior=jnp.asarray(prior))
    b = tqm.quad_match(*map(torch.from_numpy, imgs), qcfg=TCFG.quadmatch,
                       cur_disparity=torch.from_numpy(disp),
                       flow_prior=torch.from_numpy(prior))
    va, vb = to_np(a.valid), to_np(b.valid)
    assert (va == vb).mean() >= 0.97
    both = va & vb
    assert both.sum() > 15
    for leg in ("lc", "rc", "rp", "lp"):
        np.testing.assert_allclose(to_np(getattr(a, leg))[both],
                                   to_np(getattr(b, leg))[both], atol=1e-2,
                                   err_msg=leg)
