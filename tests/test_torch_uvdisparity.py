"""Parity of the port's U-V-disparity stage with the JAX package: the
histograms, ground-line fit, pitch and its Kalman filter, and the
moving-object detector with VO-outlier seeds on the moving car.

Tolerances: float outputs rtol/atol 1e-5 (the same float32 sums, taken in
another order); the moving mask may differ in 1% of its pixels, where a
rounding tips a threshold.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.frontend import uvdisparity as juvd
from semantic_slam_mapping_torch.frontend import uvdisparity as tuvd
from torch_parity_scene import (JK_, TCFG, TK, H, W, gt_disparity,
                                street_frames, to_np)

torch.set_num_threads(2)


def test_detect_moving_objects_matches_jax():
    frames = street_frames()
    depth, moving_gt = frames["depth"][1], frames["moving"][1]
    disp, valid = gt_disparity(depth)
    roi = valid & (depth < 40.0)
    rng = np.random.default_rng(9)
    ys, xs = np.nonzero(moving_gt)
    pick = rng.choice(len(ys), 8)
    out_uv = np.stack([xs[pick], ys[pick]], -1).astype(np.float32)
    in_uv = rng.uniform([0, 0], [W, H], (32, 2)).astype(np.float32)
    in_ok = ~moving_gt[in_uv[:, 1].astype(int), in_uv[:, 0].astype(int)]
    out_ok = np.ones(8, bool)
    ucfg = jcfg.UVDisparityConfig(min_area=5, min_intensity=6)
    args = (disp, valid, roi, in_uv, in_ok, out_uv, out_ok)
    a = juvd.detect_moving_objects(*map(jnp.asarray, args), JK_,
                                   num_disparities=48, cfg=ucfg)
    b = tuvd.detect_moving_objects(
        *map(torch.from_numpy, args), TK, num_disparities=48,
        cfg=TCFG.uvdisparity.__class__(**dataclasses.asdict(ucfg)))
    ma, mb = to_np(a.moving_mask), to_np(b.moving_mask)
    assert ma.sum() > 20
    assert (ma != mb).sum() <= 0.01 * ma.sum()
    np.testing.assert_allclose(float(a.pitch), float(b.pitch), atol=1e-5)
    np.testing.assert_allclose(to_np(a.u_disparity), to_np(b.u_disparity),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(to_np(a.ground_mask), to_np(b.ground_mask))


def test_uv_primitives_match_jax():
    disp, valid = gt_disparity(street_frames()["depth"][1])
    roi = valid & (street_frames()["depth"][1] < 40.0)
    ucfg = jcfg.UVDisparityConfig()
    tcfg = TCFG.uvdisparity
    dj, vj, rj = map(jnp.asarray, (disp, valid, roi))
    dt, vt, rt = map(torch.from_numpy, (disp, valid, roi))
    ud = np.array(juvd.u_disparity(dj, rj, 48))

    sj = juvd.PitchKalmanState.init(ucfg.kf_error_cov_post)
    st = tuvd.PitchKalmanState.init(tcfg.kf_error_cov_post, "cpu")
    for m in (0.02, 0.025, 0.018):
        sj = juvd.pitch_kalman_update(sj, jnp.float32([m]), ucfg)
        st = tuvd.pitch_kalman_update(st, torch.tensor([m]), tcfg)

    cases = {
        "v_disparity": (juvd.v_disparity(dj, vj, 48),
                        tuvd.v_disparity(dt, vt, 48)),
        "u_disparity": (ud, tuvd.u_disparity(dt, rt, 48)),
        "fit_ground_line": (
            np.stack(juvd.fit_ground_line(juvd.v_disparity(dj, vj, 48),
                                          ucfg)),
            torch.stack(tuvd.fit_ground_line(tuvd.v_disparity(dt, vt, 48),
                                             tcfg))),
        "measure_pitch": (
            np.stack(juvd.measure_pitch(dj, vj, rj, JK_, 48, ucfg)),
            torch.stack(tuvd.measure_pitch(dt, vt, rt, TK, 48, tcfg))),
        "pitch_kalman_update": (
            np.concatenate([np.asarray(sj.x), np.asarray(sj.P).ravel()]),
            torch.cat([st.x, st.P.reshape(-1)])),
        "sigmoid_adjust": (juvd.sigmoid_adjust(jnp.asarray(ud), ucfg),
                           tuvd.sigmoid_adjust(torch.from_numpy(ud), tcfg)),
    }
    for name, (a, b) in cases.items():
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
