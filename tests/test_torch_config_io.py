"""The port's parameters.txt loader, ground-truth pose files and trajectory
metrics against the JAX package.

Test 1: ``load_parameters_file`` on a reference-format text with every key
of ``_KEY_MAP``, ``camera.d0..d4``, comments, a line without '=' and an
unknown key: the config equals JAX's field by field (``dataclasses.asdict``,
the multi-device section too) and the unknown key's warning is printed on
stderr; ``utils.convert.config_from_dict`` of JAX's config equals it too.

Test 2: the KITTI pose writer and reader round trip (within the written
10 significant digits, 1e-8 relative) and equal JAX's files and readings
exactly; the TUM trajectory reader equals JAX's; ``absolute_trajectory_
error`` (rigid and with scale) and ``relative_pose_error`` (deltas 1 and 3)
equal JAX's within 1e-9 on a seeded noisy trajectory.
"""

import dataclasses

import numpy as np

from semantic_slam_mapping_tpu import config as jcfg
from semantic_slam_mapping_tpu.io import gt_pose as jgt
from semantic_slam_mapping_tpu.utils import metrics as jmet
from semantic_slam_mapping_torch import config as tcfg
from semantic_slam_mapping_torch.io import gt_pose as tgt
from semantic_slam_mapping_torch.utils import convert
from semantic_slam_mapping_torch.utils import metrics as tmet


def _value(section, attr, typ, i):
    """A value of the key's type, different from the default."""
    if typ is str:
        return f"{attr}_{i}/"
    if typ is int:
        return str(getattr(tcfg.SlamConfig(), section).__dict__[attr] + i + 1)
    return repr(getattr(tcfg.SlamConfig(), section).__dict__[attr] * 1.5
                + 0.25 * i)


def test_parameters_file_matches_jax(tmp_path, capsys):
    assert tcfg._KEY_MAP == jcfg._KEY_MAP
    assert tcfg._DIST_KEYS == jcfg._DIST_KEYS
    lines = ["# reference parameters.txt", "", "no separator here"]
    for i, (key, (section, attr, typ)) in enumerate(tcfg._KEY_MAP.items()):
        lines.append(f"{key}={_value(section, attr, typ, i)}"
                     + ("  " if i % 3 == 0 else ""))
    lines += [f"camera.d{i} = {0.01 * (i + 1)}" for i in range(5)]
    lines += ["#camera.fx=1.0", "mystery_key=7"]
    path = tmp_path / "parameters.txt"
    path.write_text("\n".join(lines) + "\n")

    t = tcfg.load_parameters_file(path)
    err_t = capsys.readouterr().err
    j = jcfg.load_parameters_file(path)
    err_j = capsys.readouterr().err
    assert "unknown parameter 'mystery_key'" in err_t and err_t == err_j
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tcfg.ParallelConfig()) == dataclasses.asdict(
        jcfg.ParallelConfig())
    assert t.camera.d == (0.01, 0.02, 0.03, 0.04, 0.05)
    assert t.camera.fx != tcfg.CameraConfig().fx
    assert convert.config_from_dict(dataclasses.asdict(j)) == t
    assert (tcfg.parse_parameters_text(path.read_text())
            == jcfg.parse_parameters_text(path.read_text()))
    assert t.replace(dataset=tcfg.DatasetConfig()).dataset.end_index == 100


def _trajectory(rng, n, noise):
    from scipy.spatial.transform import Rotation
    T = np.tile(np.eye(4), (n, 1, 1))
    yaw = np.cumsum(rng.normal(0.02, 0.01, n))
    T[:, :3, :3] = Rotation.from_euler(
        "yxz", np.stack([yaw, rng.normal(0, noise, n),
                         rng.normal(0, noise, n)], -1)).as_matrix()
    T[:, :3, 3] = np.cumsum(rng.normal([0.3, 0.0, 0.8], 0.05, (n, 3)), 0)
    return T


def test_gt_poses_and_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    gt = _trajectory(rng, 40, 0.0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (40, 3))
    est[:, :3, :3] = _trajectory(rng, 40, 0.01)[:, :3, :3]

    pt, pj = tmp_path / "t.txt", tmp_path / "j.txt"
    tgt.write_kitti_poses(pt, est)
    jgt.write_kitti_poses(pj, est)
    assert pt.read_text() == pj.read_text()
    back = tgt.read_kitti_poses(pt)
    np.testing.assert_allclose(back, est, rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(back, jgt.read_kitti_poses(pt))

    lines = ["# timestamp tx ty tz qx qy qz qw", "1.0 2.0 3.0"]
    for i, T in enumerate(gt):
        q = rng.normal(size=4)   # un-normalised: the readers normalise
        lines.append(f"{100 + 0.1 * i:.4f} {T[0, 3]} {T[1, 3]} {T[2, 3]} "
                     f"{q[1]} {q[2]} {q[3]} {q[0]}")
    (tmp_path / "gt.txt").write_text("\n".join(lines) + "\n")
    ts_t, p_t = tgt.read_tum_trajectory(tmp_path / "gt.txt")
    ts_j, p_j = jgt.read_tum_trajectory(tmp_path / "gt.txt")
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_allclose(p_t[:, :3, :3] @ p_t[:, :3, :3].transpose(
        0, 2, 1), np.tile(np.eye(3), (40, 1, 1)), atol=1e-12)

    for scale in (False, True):
        a = tmet.absolute_trajectory_error(est, gt, with_scale=scale)
        b = jmet.absolute_trajectory_error(est, gt, with_scale=scale)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert abs(tmet.ate_rmse(est, gt)
               - jmet.absolute_trajectory_error(est, gt).rmse) < 1e-9
    for delta in (1, 3):
        for a, b in zip(tmet.relative_pose_error(est, gt, delta),
                        jmet.relative_pose_error(est, gt, delta)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert repr(tmet._stats(np.arange(4.0))) == repr(
        jmet._stats(np.arange(4.0)))
