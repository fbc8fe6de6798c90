"""The port's ``cli train-segnet --mesh`` (the rank body is in
``torch_mesh_ranks.py``).

Test 1: ``train-segnet --mesh --device cpu --size 32 --width 0.25 --steps
3 --batch 2`` on two gloo ranks started as torchrun starts them (each
rank's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` set, the command joining the group itself): a (1, 2) mesh,
JAX's default for two devices. Rank 0 alone prints the ``training on
mesh`` line, the class weights, the step lines (steps 0 and 2), the
``trained`` line, the recall line and the ``saved`` line; rank 1 prints
none of them. Its ``segnet.pkl`` loads with ``load_checkpoint`` and holds
the keys and shapes of a meshless run's on the same batches (the same
command without ``--mesh``), each parameter within 2 lr per step taken of
it (bfloat16 rounds the split convolutions' partial gradients apart, and
Adam's first steps follow the sign of near-zero gradients), the same
``meta`` keys, and the meshless run's class weights line.

Test 2: the parser. The port's ``train-segnet`` options are the JAX
package's (``--mesh`` among them), each with JAX's default and type, and
the command's own ones with JAX's help text, plus ``--device``.
``train-segnet --mesh --device cuda`` raises where there is no card (no
CPU fallback).
"""

import argparse
import pickle
import socket

import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu import cli as jcli
from semantic_slam_mapping_torch import cli
from semantic_slam_mapping_torch.models import segnet as tseg

from torch_mesh_ranks import run_ranks

torch.set_num_threads(2)

LR = 3e-4
STEPS = 3
ARGV = ["train-segnet", "--device", "cpu", "--size", "32", "--width", "0.25",
        "--steps", str(STEPS), "--batch", "2", "--lr", str(LR)]
# train-segnet's own options (the others come from the common parent)
OWN = ("--lr", "--steps", "--batch", "--size", "--width", "--mesh")
LEAD_ONLY = ("training on mesh", "class weights:", "step 0:", "step 2:",
             "trained 3 steps", "per-class recall", "saved ")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_train_segnet_mesh_on_two_ranks(tmp_path, capsys):
    mesh_out = tmp_path / "mesh"
    np.savez(tmp_path / "inputs.npz", port=_free_port(),
             argv=np.array(ARGV + ["--out", str(mesh_out)]))
    ranks = run_ranks("train_cli_mesh", 2, tmp_path, init=False)
    lead, other = ranks
    text = str(lead["stderr"]) + str(lead["stdout"])
    assert "training on mesh {'data': 1, 'model': 2}" in text
    for line in LEAD_ONLY:
        assert line in text, line
        assert line not in str(other["stderr"]) + str(other["stdout"]), line

    cli.main(ARGV + ["--out", str(tmp_path / "single")])
    single_err = capsys.readouterr().err
    weights = [ln for ln in single_err.splitlines()
               if ln.startswith("class weights:")]
    assert weights and weights[0] in str(lead["stderr"])

    model, meta = tseg.load_checkpoint(mesh_out / "segnet.pkl")
    assert isinstance(model, tseg.SegNet) and model.width_mult == 0.25
    with open(mesh_out / "segnet.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "single" / "segnet.pkl", "rb") as f:
        want = pickle.load(f)
    assert set(got) == set(want) and set(got["meta"]) == set(want["meta"])
    assert (got["num_classes"], got["width_mult"], got["dtype"]) == (
        want["num_classes"], want["width_mult"], want["dtype"])
    g, w = _leaves(got["params"]), _leaves(want["params"])
    assert set(g) == set(w)
    for k, v in w.items():
        assert g[k].shape == v.shape, k
        assert np.abs(g[k] - v).max() <= 2 * LR * STEPS, k
    gs, ws = _leaves(got["batch_stats"]), _leaves(want["batch_stats"])
    assert {k: v.shape for k, v in gs.items()} == {
        k: v.shape for k, v in ws.items()}


class _Parsed(Exception):
    pass


def _train_segnet_actions(main, monkeypatch) -> dict:
    """{option: (default, type, help)} of ``main``'s ``train-segnet``
    parser, taken from the parser ``main`` builds."""
    grabbed = {}

    def grab(self, args=None, namespace=None):
        grabbed["ap"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            main(["train-segnet"])
    sub = next(a for a in grabbed["ap"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.option_strings[0]: (a.default, a.type, a.help)
            for a in sub.choices["train-segnet"]._actions
            if a.option_strings and a.option_strings[0] != "-h"}


def test_train_segnet_mesh_parser_and_no_card(monkeypatch, tmp_path):
    # JAX's main enables its compilation cache before it parses
    monkeypatch.setattr(jcli, "_enable_compilation_cache", lambda: None)
    jax_opts = _train_segnet_actions(jcli.main, monkeypatch)
    port_opts = _train_segnet_actions(cli.main, monkeypatch)
    assert "--mesh" in jax_opts
    assert set(port_opts) == set(jax_opts) | {"--device"}
    for k, v in jax_opts.items():
        # the common options' help texts name the port's own files
        n = 3 if k in OWN else 2
        assert port_opts[k][:n] == v[:n], k
    assert port_opts["--device"][0] == "cuda"
    args = cli.build_parser().parse_args(["train-segnet", "--mesh"])
    assert args.mesh and args.device == "cuda"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train-segnet", "--mesh", "--device", "cuda", "--steps",
                  "1", "--out", str(tmp_path)])
    assert not torch.distributed.is_initialized()
