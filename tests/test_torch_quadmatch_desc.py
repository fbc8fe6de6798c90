"""The port's descriptor-mode quad matching against the JAX package's, on
the scene of test_quadmatch_desc.py (160x480 stereo, two frames 0.6 m
apart), rendered by the JAX package.

Test 1: ``quad_match_desc`` on the pair with test_quadmatch_desc.py's ORB
settings: at least 99% of the valid chains valid in both, and the four
points of the common chains within 1e-3 px (ORB keypoints agree within
1e-4 px; a descriptor bit may flip where its two samples tie up to
rounding, which can move a windowed argmin, so chains are compared as
sets); the chains hold the reference's gates.

Test 2: the same with the default ORB budget and tighter quad gates
(``max_dy_stereo=2``, ``min_disparity=5``), then VO on each package's
matches with the samples JAX draws (``picks``): the rotation entries
within 1e-4 and the translation within 1e-3 m of JAX's, and the
translation within 0.08 m of the ground truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.frontend import quadmatch_desc as jqd
from semantic_slam_mapping_tpu.frontend import vo as jvo
from semantic_slam_mapping_tpu.geometry import se3 as jse3
from semantic_slam_mapping_torch import config as tcfg
from semantic_slam_mapping_torch.frontend import quadmatch_desc as tqd
from semantic_slam_mapping_torch.frontend import vo as tvo
from semantic_slam_mapping_torch.utils import convert

from tests.test_quadmatch import stereo_seq  # noqa: F401
from tests.test_quadmatch_desc import OCFG

torch.set_num_threads(2)


def _both(seq, jq, jo):
    imgs = [np.asarray(seq[s][i]) for s, i in (("left", 1), ("right", 1),
                                               ("left", 0), ("right", 0))]
    tq = tcfg.QuadMatchConfig(**jq.__dict__)
    to = tcfg.OrbConfig(**jo.__dict__)
    j = jqd.quad_match_desc(*map(jnp.asarray, imgs), qcfg=jq, ocfg=jo)
    t = tqd.quad_match_desc(*(torch.from_numpy(a.copy()) for a in imgs),
                            qcfg=tq, ocfg=to)
    return j, t


def _compare(j, t, min_valid):
    jv, tv = np.asarray(j.valid), t.valid.numpy()
    assert jv.sum() >= min_valid, jv.sum()
    both = jv & tv
    assert both.sum() >= 0.99 * max(jv.sum(), tv.sum()), (jv.sum(),
                                                           tv.sum())
    for name in ("lp", "rp", "lc", "rc"):
        np.testing.assert_allclose(getattr(t, name).numpy()[both],
                                   np.asarray(getattr(j, name))[both],
                                   atol=1e-3, err_msg=name)
    return both


def test_quad_match_desc_matches_jax(stereo_seq):  # noqa: F811
    _, seq, _ = stereo_seq
    q = jcfg.QuadMatchConfig()
    j, t = _both(seq, q, OCFG)
    both = _compare(j, t, 15)
    lc, rc, lp, rp = (getattr(t, n).numpy()[both]
                      for n in ("lc", "rc", "lp", "rp"))
    assert np.all(np.abs(lc[:, 1] - rc[:, 1]) < q.max_dy_stereo)
    assert np.all(lc[:, 0] - rc[:, 0] > q.min_disparity)
    assert np.all(lp[:, 0] - rp[:, 0] > q.min_disparity)
    assert np.all(np.abs(lc[:, 0] - lp[:, 0]) < q.max_dx_temporal)


def test_quad_match_desc_into_vo_matches_jax(stereo_seq):  # noqa: F811
    K, seq, T_delta = stereo_seq
    q = jcfg.QuadMatchConfig(max_dy_stereo=2.0, min_disparity=5.0)
    j, t = _both(seq, q, jcfg.OrbConfig(n_levels=4))
    _compare(j, t, 15)
    vcfg = jcfg.VoConfig(ransac_iters=50, gn_iters_hypothesis=10,
                         gn_iters_refine=30)
    key = jax.random.PRNGKey(0)
    a = jvo.estimate_motion(j, K, key, vcfg)
    picks = jax.vmap(jvo._distinct3, in_axes=(0, None))(
        jax.random.split(key, vcfg.ransac_iters), jnp.sum(j.valid))
    b = tvo.estimate_motion(t, convert.intrinsics_from_numpy(*K), None,
                            tcfg.VoConfig(**vcfg.__dict__),
                            picks=torch.from_numpy(np.array(picks)))
    assert bool(a.success) and bool(b.success)
    Ta, Tb = np.asarray(a.T_delta), b.T_delta.numpy()
    np.testing.assert_allclose(Tb[:3, :3], Ta[:3, :3], atol=1e-4)
    np.testing.assert_allclose(Tb[:3, 3], Ta[:3, 3], atol=1e-3)
    T_gt = np.asarray(jse3.compose(jse3.inverse(seq["poses"][1]),
                                   seq["poses"][0]))
    err = np.linalg.inv(Tb) @ T_gt
    assert np.linalg.norm(err[:3, 3]) < 0.08
