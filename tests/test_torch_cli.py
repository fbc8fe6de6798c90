"""The port's command line (``--device cpu``) on the KITTI-layout and
TUM-layout directories of test_cli.py (128x384, 6 and 5 frames).

Test 1: ``make-vocab``, then ``slam --vocab --gt --parameters --plot``
(the pipelined loop) and ``tracker --no-pipeline`` (the serial one):
each writes ``trajectory.txt`` (equal to the port's own ``SlamSystem``
run on the reader's frames, ``process_stream`` with the same vocabulary
and ``process_frame`` of float tensors respectively, within the file's 10
significant digits: rtol 1e-8), ``traj.g2o`` (read back by ``load_g2o``:
one vertex a keyframe) and, for ``slam``, the plot with its caption chunk;
the fps line goes to stderr; the last stdout line is the accuracy JSON,
equal, keys and values, to what the JAX package's ``_report_accuracy``
prints for the same trajectory.

Test 2: ``make-vocab``, ``read-frames --dump`` and ``match-orb --dump``
print the same stdout lines as the JAX package's commands on the same
directories, times aside, and write the same PNGs (pixels equal).
"""

import json
import re
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from semantic_slam_mapping_tpu import cli as jcli
from semantic_slam_mapping_torch import cli
from semantic_slam_mapping_torch.backend.looper import load_vocabulary
from semantic_slam_mapping_torch.config import load_parameters_file
from semantic_slam_mapping_torch.io.gt_pose import read_kitti_poses
from semantic_slam_mapping_torch.io.kitti import KittiReader
from semantic_slam_mapping_torch.pipeline import SlamSystem, load_g2o

from tests.test_cli import kitti_dataset, tum_dataset  # noqa: F401

torch.set_num_threads(4)


def _json_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _jax_report(traj, gt_file, capsys) -> dict:
    jcli._report_accuracy(traj, str(gt_file))
    return _json_line(capsys.readouterr().out)


def test_cli_slam_and_tracker(kitti_dataset, tmp_path, capsys):  # noqa: F811
    root, gt_file, params = kitti_dataset
    cfg = load_parameters_file(params)
    frames = list(KittiReader(str(root), 0, 6))
    cli.main(["make-vocab", "--data", str(root), "--out", str(tmp_path),
              "--stride", "2", "--branching", "4", "--depth", "2",
              "--device", "cpu"])
    vocab_path = tmp_path / "vocab.npz"

    runs = {"slam": ["--vocab", str(vocab_path), "--plot"],
            "tracker": ["--no-pipeline"]}
    for cmd, extra in runs.items():
        out = tmp_path / cmd
        capsys.readouterr()
        cli.main([cmd, "--data", str(root), "--gt", str(gt_file),
                  "--parameters", str(params), "--out", str(out),
                  "--device", "cpu", *extra])
        captured = capsys.readouterr()
        assert re.search(r"^# 6 frames in [\d.]+s = [\d.]+ fps$",
                         captured.err, re.M), captured.err
        traj = read_kitti_poses(out / "trajectory.txt")

        if cmd == "slam":
            ref = SlamSystem(cfg, vocab=load_vocabulary(str(vocab_path)),
                             device="cpu")
            ref.process_stream((f.left, f.right, f.color, f.semantic)
                               for f in frames)
        else:
            ref = SlamSystem(cfg, device="cpu")
            for f in frames:
                ref.process_frame(torch.from_numpy(f.left),
                                  torch.from_numpy(f.right),
                                  color=f.color, semantic=f.semantic)
        expect = ref.finish()
        assert traj.shape == (6, 4, 4)
        np.testing.assert_allclose(traj, expect, rtol=1e-8, atol=1e-12)
        g2o = load_g2o(str(out / "traj.g2o"))
        assert len(g2o["vertex_ids"]) == len(ref.keyframes) >= 2
        assert len(g2o["edge_i"]) == ref.n_edges

        report = _json_line(captured.out)
        assert report == _jax_report(traj, gt_file, capsys)
        assert report["frames"] == 6 and report["ate_rmse_m"] < 1.0
    with Image.open(tmp_path / "slam" / "trajectory.png") as im:
        assert im.text == {"Comment": "green: estimated   red: ground truth"}


def _strip_times(text: str) -> list:
    return [re.sub(r", [\d.]+ ms$", "", line) for line in text.splitlines()]


def test_cli_probes_match_jax(kitti_dataset, tum_dataset,  # noqa: F811
                              tmp_path, capsys):
    root, _, _ = kitti_dataset
    commands = [
        ["make-vocab", "--data", str(root), "--out", str(tmp_path / "v"),
         "--stride", "2", "--branching", "4", "--depth", "2"],
        ["read-frames", "--data", str(root), "--frames", "3", "--dump", "2"],
        ["read-frames", "--data", str(tum_dataset), "--dataset", "tum",
         "--dump", "1"],
        ["match-orb", "--data", str(tum_dataset), "--dataset", "tum",
         "--frames", "3", "--dump", "2"],
        ["match-orb", "--data", str(root), "--dataset", "kitti",
         "--frames", "4"],
    ]
    for k, args in enumerate(commands):
        outs = {}
        for name, main, dev in (("jax", jcli.main, []),
                                ("torch", cli.main, ["--device", "cpu"])):
            dump = tmp_path / f"{name}{k}"
            capsys.readouterr()
            main(args + (["--out", str(dump)] if "--out" not in args
                         else []) + dev)
            captured = capsys.readouterr()
            outs[name] = (_strip_times(captured.out),
                          captured.err.splitlines()[-1:], dump)
        (jo, je, jd), (to, te, td) = outs["jax"], outs["torch"]
        assert to == jo, args
        assert te == je, args
        if args[0] != "make-vocab":
            pngs = sorted(p.name for p in Path(jd).glob("*.png"))
            assert pngs == sorted(p.name for p in Path(td).glob("*.png"))
            assert pngs or "--dump" not in args
            for name in pngs:
                np.testing.assert_array_equal(
                    np.asarray(Image.open(td / name)),
                    np.asarray(Image.open(jd / name)), err_msg=name)
