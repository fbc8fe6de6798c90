"""The batched window frontend against the JAX package, and the port's
batched ops against a stack of their per-frame calls.

Test 1 runs two overlapping windows of B = 4 pairs (frames 0-4, then 4-8 of
a JAX-rendered street with a moving car, 96x192) through JAX's
``track_frames_batched`` (``window_core`` under ``vmap``) and through the
port's, on the CPU, with the float32 cost volume and the exact SGM scan
(``scan_block=0``). PyTorch cannot replay ``jax.random``, so the port is
given JAX's RANSAC samples (``jax.vmap(vo._distinct3)`` over each pair's
keys). Tolerances: poses 1e-4 in rotation and 1e-3 m; the valid pixels
equal and disparities within 1e-5 px (JAX's jitted window program and the
port round the subpixel step up to 4e-6 px apart); match counts equal;
inliers within 2; pitch 1e-4; moving masks differ in at most 1% of the
pixels JAX marks (at this size VO finds no outlier on the car and both
masks are empty, as in test_torch_slice.py); the final states equal
(poses and the pitch filter within the same tolerances).

Test 2 holds every batched op of the window to the same op called on each
frame alone, on a batch with one blank frame: SGBM with its speckle
labels, connected components, GFTT corners and the U-V-disparity pass
exact; KLT and VO (the same samples) within 1e-5, and VO with
``pairwise=True`` exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.frontend import tracker as jtracker
from semantic_slam_mapping_tpu.frontend import vo as jvo
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics as JK
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_torch.frontend import quadmatch
from semantic_slam_mapping_torch.frontend import tracker as ttracker
from semantic_slam_mapping_torch.frontend import uvdisparity as uvd
from semantic_slam_mapping_torch.frontend import vo as tvo
from semantic_slam_mapping_torch.geometry import stereo as gstereo
from semantic_slam_mapping_torch.ops import components, corners, klt, sgbm
from semantic_slam_mapping_torch.ops import image as im
from semantic_slam_mapping_torch.utils import convert

torch.set_num_threads(2)
H, W = 96, 192
B = 4
CFG = jcfg.SlamConfig(
    camera=jcfg.CameraConfig(fx=150.0, fy=150.0, cx=W / 2, cy=H / 2,
                             baseline=0.54),
    sgbm=jcfg.SgbmConfig(num_disparities=16, sad_window_size=5,
                         p1=8 * 25, p2=32 * 25, speckle_window_size=20,
                         cost_dtype="float32", scan_block=0),
    quadmatch=jcfg.QuadMatchConfig(max_features=64),
    vo=jcfg.VoConfig(ransac_iters=16),
    uvdisparity=jcfg.UVDisparityConfig(min_area=5, min_intensity=6))
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
JKI = JK.from_config(CFG.camera)
TKI = convert.intrinsics_from_numpy(*JKI)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def street():
    world = jsyn.make_world(jax.random.PRNGKey(3), n_boxes=14,
                            with_moving_box=True)
    poses = jsyn.straight_trajectory(2 * B + 1, speed=0.3, yaw_rate=0.01)
    return jax.tree.map(np.asarray,
                        jsyn.render_sequence(JKI, world, poses, H, W))


def jax_picks(key, n_valid):
    """The samples JAX's window draws from ``key`` for pairs with these
    valid-match counts (track_frames_batched splits the key per pair,
    estimate_motion per hypothesis)."""
    R = CFG.vo.ransac_iters
    keys = jax.random.split(key, int(n_valid.shape[0]))
    return torch.from_numpy(np.stack([np.asarray(jax.vmap(
        jvo._distinct3, in_axes=(0, None))(
            jax.random.split(keys[i], R), jnp.int32(int(n_valid[i]))))
        for i in range(int(n_valid.shape[0]))]))


def test_window_matches_jax_window_core(street):
    L, R = street["left"], street["right"]
    jstate = jtracker.TrackerState.initial(CFG)
    tstate = ttracker.TrackerState.initial(TCFG, "cpu")
    key = jax.random.PRNGKey(0)
    for lo in (0, B):           # consecutive windows share one frame
        sl = slice(lo, lo + B + 1)
        key, k = jax.random.split(key)
        jstate, jout = jtracker.track_frames_batched(
            jstate, jnp.asarray(L[sl]), jnp.asarray(R[sl]), JKI, k, CFG)
        jout = jax.tree.map(np.asarray, jout)
        tstate, tout = ttracker.track_frames_batched(
            tstate, torch.from_numpy(L[sl].copy()),
            torch.from_numpy(R[sl].copy()), TKI,
            None, TCFG, picks=lambda n, k=k: jax_picks(k, n))
        assert tout.pose.shape == (B, 4, 4)
        assert jout.vo_success.all() and _np(tout.vo_success).all()
        # the valid pixels are equal; the subpixel step of the jitted
        # window program rounds a few ulps apart
        np.testing.assert_array_equal(_np(tout.disparity) > 0,
                                      jout.disparity > 0)
        np.testing.assert_allclose(_np(tout.disparity), jout.disparity,
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(_np(tout.n_matches), jout.n_matches)
        np.testing.assert_array_equal(_np(tout.status), jout.status)
        assert np.abs(_np(tout.n_inliers).astype(int)
                      - jout.n_inliers.astype(int)).max() <= 2
        np.testing.assert_allclose(_np(tout.pose)[:, :3, :3],
                                   jout.pose[:, :3, :3], atol=1e-4)
        np.testing.assert_allclose(_np(tout.pose)[:, :3, 3],
                                   jout.pose[:, :3, 3], atol=1e-3)
        np.testing.assert_allclose(_np(tout.pitch), jout.pitch, atol=1e-4)
        mj, mt = jout.moving_mask, _np(tout.moving_mask)
        for i in range(B):
            assert (mj[i] != mt[i]).sum() <= 0.01 * max(int(mj[i].sum()),
                                                        100)
    # the final states: status, counters, pose, velocity and pitch filter
    for f in ("status", "lost_count", "frame_index"):
        assert int(getattr(tstate, f)) == int(getattr(jstate, f)), f
    assert int(tstate.frame_index) == 2 * B
    for f in ("pose", "velocity"):
        np.testing.assert_allclose(_np(getattr(tstate, f))[:3, :3],
                                   np.asarray(getattr(jstate, f))[:3, :3],
                                   atol=1e-4)
        np.testing.assert_allclose(_np(getattr(tstate, f))[:3, 3],
                                   np.asarray(getattr(jstate, f))[:3, 3],
                                   atol=1e-3)
    np.testing.assert_allclose(_np(tstate.pitch_kf.x),
                               np.asarray(jstate.pitch_kf.x), atol=1e-4)
    np.testing.assert_allclose(_np(tstate.pitch_kf.P),
                               np.asarray(jstate.pitch_kf.P), atol=1e-4)


def test_batched_ops_equal_per_frame_calls(street):
    L = torch.from_numpy(street["left"][:B + 1].copy())
    R = torch.from_numpy(street["right"][:B + 1].copy())
    L[2] = 0.0                  # a blank frame: no disparity, no corners
    R[2] = 0.0
    cfg = TCFG
    for fdp in (False, True):
        scfg = dataclasses.replace(cfg.sgbm, full_dp=fdp,
                                   cost_dtype="bfloat16")
        sb = sgbm.compute(L, R, scfg)
        for i in range(B + 1):
            s1 = sgbm.compute(L[i], R[i], scfg)
            assert torch.equal(sb.disparity[i], s1.disparity), (fdp, i)
            assert torch.equal(sb.valid[i], s1.valid), (fdp, i)
    sg = sgbm.compute(L, R, cfg.sgbm)
    assert not sg.valid[2].any() and sg.valid[0].float().mean() > 0.5
    disp = torch.where(sg.valid, sg.disparity, 0.0)

    # the speckle filter's labels: each frame's own flat indices
    same = tuple(torch.roll(sg.valid, s, d) for d, s in
                 ((-2, 1), (-2, -1), (-1, 1), (-1, -1)))
    lb = components.connected_components(sg.valid, same, sweeps=8)
    for i in range(B + 1):
        l1 = components.connected_components(
            sg.valid[i], tuple(x[i] for x in same), sweeps=8)
        assert torch.equal(lb[i], l1), i
    assert int(lb.max()) < H * W

    kb = corners.gftt(L, 64)
    for i in range(B + 1):
        k1 = corners.gftt(L[i], 64)
        for a, b in zip(kb, k1):
            assert torch.equal(a[i], b), i
    assert not kb.valid[2].any() and kb.valid[0].all()

    # KLT, quad matching and VO over the B pairs, with a per-pair prior
    fp = torch.tensor([[1.0, -0.5], [0.0, 0.0], [-2.0, 1.0], [0.5, 0.5]])
    pyr_c = im.build_pyramid(L[1:], cfg.klt.pyramid_levels, 2.0)
    pyr_p = im.build_pyramid(L[:-1], cfg.klt.pyramid_levels, 2.0)
    tb = klt.track_pyramid(pyr_c, pyr_p, kb.xy[1:], cfg.klt,
                           fp[:, None, :].expand(B, 64, 2))
    for i in range(B):
        t1 = klt.track_pyramid([p[i] for p in pyr_c], [p[i] for p in pyr_p],
                               kb.xy[i + 1], cfg.klt,
                               fp[i].expand(64, 2))
        torch.testing.assert_close(tb.xy[i], t1.xy, rtol=0, atol=1e-5)
        assert torch.equal(tb.status[i], t1.status)
    mb = quadmatch.quad_match(L[1:], R[1:], L[:-1], R[:-1], cfg.quadmatch,
                              cfg.gftt, cfg.klt, disp[1:], fp)
    ms = [quadmatch.quad_match(L[i + 1], R[i + 1], L[i], R[i],
                               cfg.quadmatch, cfg.gftt, cfg.klt,
                               disp[i + 1], fp[i]) for i in range(B)]
    for i in range(B):
        for a, b in zip(mb, ms[i]):
            torch.testing.assert_close(a[i], b, rtol=0, atol=1e-5)
    picks = tvo._distinct3(torch.Generator().manual_seed(1),
                           mb.valid.sum(-1), cfg.vo.ransac_iters)
    vb = tvo.estimate_motion(mb, TKI, None, cfg.vo, picks=picks)
    vp = tvo.estimate_motion(mb, TKI, None, cfg.vo, picks=picks,
                             pairwise=True)
    assert vb.success[0] and vb.success[3] and not vb.success[1]
    for i in range(B):
        v1 = tvo.estimate_motion(ms[i], TKI, None, cfg.vo, picks=picks[i])
        torch.testing.assert_close(vb.T_delta[i], v1.T_delta, rtol=0,
                                   atol=1e-5)
        assert torch.equal(vb.inliers[i], v1.inliers)
        assert bool(vb.success[i]) == bool(v1.success)
        # pairwise: each pair's own bits
        assert torch.equal(vp.T_delta[i], v1.T_delta)
        assert torch.equal(vp.inliers[i], v1.inliers)

    # the U-V-disparity pass, each frame with its own pitch and seeds
    pts = gstereo.triangulate_image(TKI, disp[1:], cfg.camera)
    pm, la, lb_ = uvd.measure_pitch(disp[1:], sg.valid[1:], pts.roi, TKI,
                                    cfg.sgbm.num_disparities,
                                    cfg.uvdisparity)
    pts_c = gstereo.correct_pitch(pts, pm, cfg.camera)
    ub = uvd.detect_moving_objects(
        disp[1:], sg.valid[1:], pts_c.roi, mb.lc, mb.valid & vb.inliers,
        mb.lc, mb.valid & ~vb.inliers, TKI, cfg.sgbm.num_disparities,
        cfg.uvdisparity, (la, lb_))
    for i in range(B):
        p1 = gstereo.triangulate_image(TKI, disp[i + 1], cfg.camera)
        m1 = uvd.measure_pitch(disp[i + 1], sg.valid[i + 1], p1.roi, TKI,
                               cfg.sgbm.num_disparities, cfg.uvdisparity)
        assert all(torch.equal(a[i], b) for a, b in zip((pm, la, lb_), m1))
        p1c = gstereo.correct_pitch(p1, m1[0], cfg.camera)
        assert torch.equal(pts_c.roi[i], p1c.roi)
        u1 = uvd.detect_moving_objects(
            disp[i + 1], sg.valid[i + 1], p1c.roi, mb.lc[i],
            (mb.valid & vb.inliers)[i], mb.lc[i],
            (mb.valid & ~vb.inliers)[i], TKI, cfg.sgbm.num_disparities,
            cfg.uvdisparity, (la[i], lb_[i]))
        for a, b in zip(ub, u1):
            assert torch.equal(a[i], b), i
