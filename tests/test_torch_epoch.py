"""The keyframe epoch of the port's SlamSystem against the JAX package's,
on the scene of test_pipeline.py (128x384, 20 frames, a vocabulary of
branching 6 and depth 3), rendered by JAX and carried across.

Test 1 holds the epoch alone: JAX's ``SlamSystem.process_frame`` runs the
scene, and the port's ``_postprocess_frame`` is fed the JAX frontend's
FrameResults (converted), with the port's tracker state set to JAX's after
each dispatch, so both epochs see the same per-frame inputs. The loop
re-measure's RANSAC samples are JAX's, replayed through the port's
``picks`` (PyTorch cannot replay ``jax.random``). Tolerances: the
keyframes, the (i, j, is_loop) edge list and the optimisation counts are
equal; odometry and nearby edge measurements agree within 1e-4, loop edge
measurements within 1e-2 m and 1e-3 rad, the finished trajectories within
0.02 m.

Test 2 runs the port on its own frontend: ``process_stream`` equals
``process_frame`` within 0.08 m (as test_pipeline.py holds the JAX
package), and the lost-recovery scene of test_pipeline.py recovers with an
ATE below 1.0 m on the sighted frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu.backend import looper as jlp
from semantic_slam_mapping_tpu.config import (CameraConfig, LooperConfig,
                                              OrbConfig, PoseGraphConfig,
                                              SgbmConfig, SlamConfig,
                                              VoConfig)
from semantic_slam_mapping_tpu.frontend import vo as jvo
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_tpu.ops import orb as jorb
from semantic_slam_mapping_tpu.pipeline import SlamSystem as JaxSlam
from semantic_slam_mapping_torch.backend import looper as tlp
from semantic_slam_mapping_torch.backend import pnp as tpnp
from semantic_slam_mapping_torch.frontend import tracker as ttracker
from semantic_slam_mapping_torch.frontend import vo as tvo
from semantic_slam_mapping_torch.pipeline import SlamSystem
from semantic_slam_mapping_torch.utils import convert, metrics

torch.set_num_threads(2)

# the scene and configuration of test_pipeline.py
H, W = 128, 384
N_FRAMES = 20
CAM = CameraConfig(fx=250.0, fy=250.0, cx=W / 2, cy=H / 2, baseline=0.54)
CFG = SlamConfig(
    camera=CAM,
    sgbm=SgbmConfig(num_disparities=48, sad_window_size=7,
                    p1=8 * 49, p2=32 * 49, speckle_window_size=50),
    vo=VoConfig(ransac_iters=40, gn_iters_hypothesis=8, gn_iters_refine=25),
    orb=OrbConfig(n_features=256, n_levels=4),
    pose_graph=PoseGraphConfig(keyframe_min_translation=1.2,
                               keyframe_min_rotation=0.4,
                               pcg_iters=40, max_keyframes=64),
    looper=LooperConfig(min_sim_score=0.03, min_interval=6),
)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def scene():
    """The JAX-rendered sequence and the vocabulary of test_pipeline.py,
    built by both packages from the same descriptors."""
    K = Intrinsics.from_config(CAM)
    world = jsyn.make_world(jax.random.PRNGKey(30), n_boxes=16)
    poses = jsyn.straight_trajectory(N_FRAMES, speed=0.45, yaw_rate=0.01)
    seq = jax.tree.map(np.asarray,
                       jsyn.render_sequence(K, world, poses, H, W))
    descs = []
    for i in (0, N_FRAMES // 2, N_FRAMES - 1):
        f = jorb.extract(jnp.asarray(seq["left"][i]), CFG.orb)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    descs = np.concatenate(descs)
    return (seq, jlp.build_vocabulary(descs, branching=6, depth=3),
            tlp.build_vocabulary(descs, branching=6, depth=3))


def _to_port(x):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), x)


def _feed(system, jax_out, jax_state, left, right):
    """The port's per-frame epoch on a JAX frontend step: what
    ``_dispatch_frame`` would have left behind, then ``_postprocess_frame``."""
    left, right = system._upload_gray(left), system._upload_gray(right)
    out = ttracker.FrameResult(
        *_to_port(tuple(jax_out[:7])),
        tvo.QuadMatches(*_to_port(tuple(jax_out.matches))),
        *_to_port(tuple(jax_out[8:])))
    s = jax.tree.map(np.asarray, jax_state)
    system.state = convert.tracker_state_from_numpy(
        s.status, s.pose, s.velocity, s.lost_count,
        (s.pitch_kf.x, s.pitch_kf.P), s.frame_index, device="cpu")
    system._prev = (left, right)
    system._last_disparity = out.disparity
    system._dispatched += 1
    system._postprocess_frame(out, left, right)


def _edges(system):
    n = system.n_edges
    g = system.graph
    return ([(int(i), int(j), bool(b)) for i, j, b in
             zip(g.edge_i[:n], g.edge_j[:n], g.edge_is_loop[:n])],
            np.asarray(g.edge_T[:n]))


def _closure(fn) -> dict:
    """The variables a closure captured (unset ones are left out)."""
    out = {}
    for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
        try:
            out[name] = cell.cell_contents
        except ValueError:
            pass
    return out


def test_epoch_matches_jax(scene, monkeypatch):
    seq, jvocab, tvocab = scene
    jsys = JaxSlam(CFG, vocab=jvocab)
    tsys = SlamSystem(TCFG, vocab=tvocab, device="cpu")
    nb = CFG.pose_graph.nearby_keyframes

    # what JAX's edge dispatches drew and solved: the loop re-measure's
    # keys, and the PnP gates' results in call order (forward, then the
    # loop's reverse PnP)
    loop_keys, jax_pnp = [], []
    jax_dispatch = JaxSlam._dispatch_edges

    def recording_dispatch(self, refs, kf, is_loop):
        if is_loop:
            _, k = jax.random.split(self.key)
            loop_keys.append(jax.random.split(k, nb))
        harvest = jax_dispatch(self, refs, kf, is_loop)
        cells = _closure(harvest)
        jax_pnp.append(cells["infos"])
        if is_loop:
            jax_pnp.append(cells["res_rev"])
        return harvest

    monkeypatch.setattr(JaxSlam, "_dispatch_edges", recording_dispatch)

    # the port solves every PnP gate itself, then goes on with JAX's result
    # (a non-converging LM on a few wrong matches ends where float32
    # rounding sends it, in either package); its own results are held to
    # JAX's below
    pairs = []
    port_pnp = tpnp.solve_pnp_lazy

    def replaying_pnp(*args):
        own = port_pnp(*args)
        ref = jax_pnp[len(pairs)]
        pairs.append((own, jax.tree.map(np.asarray, ref)))
        return tpnp.PnpInformation(*_to_port(tuple(ref)))

    monkeypatch.setattr(tpnp, "solve_pnp_lazy", replaying_pnp)
    replayed = []

    def replaying_loop_vo(m):
        # one batched call a dispatch: (n, N) matches, one row a candidate
        keys = loop_keys[len(replayed)]
        replayed.append(len(replayed))
        picks = [jax.vmap(jvo._distinct3, in_axes=(0, None))(
            jax.random.split(keys[c], CFG.vo.ransac_iters),
            jnp.int32(int(m.valid[c].sum())))
            for c in range(m.valid.shape[0])]
        return tvo.estimate_motion(m, tsys.K, None, TCFG.vo,
                                   picks=torch.from_numpy(np.stack(picks)),
                                   pairwise=True)

    monkeypatch.setattr(tsys, "_loop_vo", replaying_loop_vo)

    for i in range(N_FRAMES):
        left, right = seq["left"][i], seq["right"][i]
        if i == 0:      # both only prime their pair buffers
            assert jsys.process_frame(left, right) is None
            assert tsys.process_frame(left, right) is None
            continue
        jout = jsys._dispatch_frame(left, right)
        jstate = jsys.state
        jsys._postprocess_frame(jout, jsys._prev[0], jsys._prev[1],
                                None, None)
        _feed(tsys, jout, jstate, left, right)

    assert ([k.frame_index for k in tsys.keyframes]
            == [k.frame_index for k in jsys.keyframes])
    jedges, jT = _edges(jsys)
    tedges, tT = _edges(tsys)
    assert tedges == jedges
    loop = np.array([b for _, _, b in jedges])
    np.testing.assert_allclose(tT[~loop], jT[~loop], atol=1e-4)
    np.testing.assert_allclose(tT[loop][:, :3, 3], jT[loop][:, :3, 3],
                               atol=1e-2)
    np.testing.assert_allclose(tT[loop][:, :3, :3], jT[loop][:, :3, :3],
                               atol=1e-3)
    # the scene accepts a loop edge and fires a global optimisation
    assert tsys.n_loop_edges == jsys.n_loop_edges >= 1
    assert (tsys.n_global_optimizations == jsys.n_global_optimizations
            >= 1)
    assert tsys.n_local_optimizations == jsys.n_local_optimizations
    assert tsys.loop_candidate_inliers == jsys.loop_candidate_inliers
    jtraj = jsys.finish()       # first: the port replays its dispatches
    np.testing.assert_allclose(tsys.finish(), jtraj, atol=0.02)
    assert tsys.n_global_optimizations == jsys.n_global_optimizations

    # the port's own PnP gates on the epoch's inputs: the same matches
    # everywhere, and wherever JAX's gate passed, the port's passes with
    # the same inliers and pose (a gate that fails may end anywhere)
    assert len(pairs) == len(jax_pnp) > 0
    n_passed = 0
    for own, ref in pairs:
        np.testing.assert_array_equal(own.n_matches.numpy(), ref.n_matches)
        ok = ref.success
        n_passed += int(ok.sum())
        assert own.success.numpy()[ok].all()
        np.testing.assert_array_equal(own.n_inliers.numpy()[ok],
                                      ref.n_inliers[ok])
        np.testing.assert_allclose(own.T.numpy()[ok], ref.T[ok], atol=1e-4)
    assert n_passed > 0


def test_port_stream_and_lost_recovery(scene):
    seq, _, tvocab = scene
    frames = [(seq["left"][i], seq["right"][i]) for i in range(N_FRAMES)]
    a = SlamSystem(TCFG, vocab=tvocab, device="cpu")
    for left, right in frames:
        a.process_frame(left, right)
    b = SlamSystem(TCFG, vocab=tvocab, device="cpu")
    b.process_stream(frames)
    ta, tb = a.finish(), b.finish()
    assert len(a.keyframes) == len(b.keyframes) >= 3
    assert a.n_edges == b.n_edges
    assert a.n_loop_edges >= 1 and a.n_global_optimizations >= 1
    np.testing.assert_allclose(ta, tb, atol=0.08)
    assert metrics.ate_rmse(ta, seq["poses"]) < 0.6

    # blind the tracker for more than max_lost_frames frames (noise for a
    # covered lens while the camera holds still), then resume: it must go
    # LOST, relocalise against the reference keyframes and finish with a
    # bounded error on the sighted frames
    cfg = dataclasses.replace(TCFG, tracker=dataclasses.replace(
        TCFG.tracker, max_lost_frames=2))
    n_sighted, n_blind = 8, 4
    rng = np.random.default_rng(7)
    lefts, rights = seq["left"].copy(), seq["right"].copy()
    gt = seq["poses"].copy()
    for i in range(n_sighted, n_sighted + n_blind):
        lefts[i] = rng.uniform(0, 1, lefts[i].shape).astype(np.float32)
        rights[i] = rng.uniform(0, 1, rights[i].shape).astype(np.float32)
        gt[i] = gt[n_sighted - 1]
    for i in range(n_sighted + n_blind, N_FRAMES):
        lefts[i], rights[i] = lefts[i - n_blind], rights[i - n_blind]
        gt[i] = gt[i - n_blind]
    c = SlamSystem(cfg, vocab=tvocab, device="cpu")
    statuses = []
    for i in range(N_FRAMES):
        c.process_frame(lefts[i], rights[i])
        if i:
            statuses.append(c.frame_log[-1].status)
    traj = c.finish()
    assert ttracker.LOST in statuses
    assert c.n_recoveries >= 1
    assert int(c.state.status) == ttracker.OK
    sighted = list(range(n_sighted)) + list(range(n_sighted + n_blind,
                                                  N_FRAMES))
    assert metrics.ate_rmse(traj[sighted], gt[sighted]) < 1.0
