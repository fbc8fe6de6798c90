"""Checkpoints and g2o files of the port against the JAX package's.

Test 1: the JAX ``SlamSystem(enable_mapping=True)`` runs 5 frames of the
scene of test_checkpoint.py (color and labels) and saves; the port loads
that checkpoint and saves it again: the same keys, dtypes and values. The
JAX package loads the port's file and saves it again: the same again. The
resumed port then keeps mapping on the next 5 frames: its map is colored
(the red channel above the blue, as the input's) and holds no excluded
class, and its keyframes read back from a second save.

Test 2: for the same keyframes and graph (random poses, edges and
information weights), the port's ``save_g2o`` writes the JAX package's
text exactly, and its ``load_g2o`` reads that file back as JAX's does and
to the graph's poses within 1e-6.
"""

import dataclasses

import jax
import numpy as np
import torch

from semantic_slam_mapping_tpu.geometry import se3_np as jse3
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_tpu.pipeline import Keyframe as JaxKeyframe
from semantic_slam_mapping_tpu.pipeline import SlamSystem as JaxSlam
from semantic_slam_mapping_tpu.pipeline import load_g2o as jax_load_g2o
from semantic_slam_mapping_tpu.utils import checkpoint as jckpt
from semantic_slam_mapping_torch.mapping import semantics
from semantic_slam_mapping_torch.pipeline import Keyframe, SlamSystem
from semantic_slam_mapping_torch.pipeline import load_g2o
from semantic_slam_mapping_torch.utils import checkpoint as tckpt
from semantic_slam_mapping_torch.utils import convert

from tests.test_pipeline import CFG, H, W

torch.set_num_threads(4)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))


def _same_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, (k, za[k].dtype, zb[k].dtype)
        assert np.array_equal(za[k], zb[k]), k
    return za


def test_checkpoint_round_trip_and_resumed_mapping(tmp_path):
    K = Intrinsics.from_config(CFG.camera)
    world = jsyn.make_world(jax.random.PRNGKey(77), n_boxes=10)
    poses = jsyn.straight_trajectory(10, speed=0.8)
    seq = jax.tree.map(np.asarray, jsyn.render_sequence(K, world, poses, H,
                                                        W))
    grey = seq["left"]
    color = np.clip(np.stack([grey, grey * 0.8, grey * 0.6], -1) * 255,
                    0, 255).astype(np.uint8)
    sem = seq["semantic"]

    jsys = JaxSlam(CFG, enable_mapping=True)
    for i in range(5):
        jsys.process_frame(seq["left"][i], seq["right"][i], color=color[i],
                           semantic=sem[i])
    a, b, c = (tmp_path / f"{n}.npz" for n in "abc")
    jckpt.save_slam(a, jsys)

    port = tckpt.load_slam(a, TCFG, enable_mapping=True, device="cpu")
    tckpt.save_slam(b, port)
    z = _same_npz(a, b)
    assert int(z["n_keyframes"]) >= 2 and "kf0_color" in z.files
    assert "kf0_semantic" in z.files
    jckpt.save_slam(c, jckpt.load_slam(b, CFG))
    _same_npz(a, c)

    # the resumed port keeps mapping
    assert len(port.ref_frames) > 0
    port._prev = (port._upload_gray(seq["left"][4]),
                  port._upload_gray(seq["right"][4]))
    port.process_stream((seq["left"][i], seq["right"][i], color[i], sem[i])
                        for i in range(5, 10))
    port.finish()
    assert len(port.keyframes) > int(z["n_keyframes"])
    assert len(port.map) > 100
    _, rgb, lbl = port.map.as_arrays()
    assert (rgb[:, 0] > rgb[:, 2]).mean() > 0.9
    assert not np.isin(lbl, semantics.MAP_EXCLUDED_CLASSES).any()
    tckpt.save_slam(b, port)
    again = tckpt.load_slam(b, TCFG, device="cpu")
    assert len(again.keyframes) == len(port.keyframes)
    for k0, k1 in zip(port.keyframes, again.keyframes):
        assert np.array_equal(k0.semantic, k1.semantic)
        assert np.array_equal(k0.color, k1.color)
        assert np.array_equal(k0.pose, k1.pose)


def test_g2o_text_and_round_trip_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    n_kf, n_edges = 6, 11

    def random_pose():
        q = rng.normal(0, 1, 4)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = jse3.quaternion_to_rotation(q / np.linalg.norm(q))
        T[:3, 3] = rng.normal(0, 5, 3)
        return T

    kf_poses = [random_pose() for _ in range(n_kf)]
    jsys = JaxSlam(CFG)
    tsys = SlamSystem(TCFG, device="cpu")
    for i, p in enumerate(kf_poses):
        jsys.keyframes.append(JaxKeyframe(kf_id=i, frame_index=3 * i,
                                          pose=p))
        tsys.keyframes.append(Keyframe(kf_id=i, frame_index=3 * i, pose=p))
    ei = rng.integers(0, n_kf, n_edges)
    ej = rng.integers(0, n_kf, n_edges)
    eT = np.stack([random_pose() for _ in range(n_edges)])
    info = rng.choice(np.float32([100.0, 1.0, 4.0, 37.5]), n_edges)
    for s in (jsys, tsys):
        s.graph.edge_i[:n_edges] = ei
        s.graph.edge_j[:n_edges] = ej
        s.graph.edge_T[:n_edges] = eT
        s.graph.edge_info[:n_edges] = info
        s.n_edges = n_edges
    pj, pt = tmp_path / "j.g2o", tmp_path / "t.g2o"
    jsys.save_g2o(str(pj))
    tsys.save_g2o(str(pt))
    text = pt.read_text()
    assert text == pj.read_text()
    assert text.count("VERTEX_SE3:QUAT") == n_kf
    assert text.count("EDGE_SE3:QUAT") == n_edges

    got, ref = load_g2o(str(pt)), jax_load_g2o(str(pj))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k
    np.testing.assert_allclose(got["poses"], np.stack(kf_poses), atol=1e-6)
    np.testing.assert_allclose(got["edge_T"], eT, atol=1e-6)
    assert np.array_equal(got["edge_info"], info.astype(np.float64))
    assert np.array_equal(got["edge_i"], ei)
