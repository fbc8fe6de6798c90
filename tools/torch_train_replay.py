"""The port's ``train-segnet`` against the JAX package's at a small size, on
the CPU.

Runs, with the same ``--size --width --steps --batch``:

- the JAX package's own ``train-segnet``;
- the port's ``train-segnet`` from JAX's initial parameters on JAX-drawn
  batches (the command's hooks, with the batches of
  ``tests/test_torch_train_cli.py::JaxBatches``), in bfloat16 and, with
  ``--float32``, in float32 too;
- the port's ``train-segnet`` on its own draws (its ``create`` and
  ``TrainBatches``), and with one of the two from JAX: its own start on
  JAX's batches, JAX's start on its own batches.

Prints one JSON line: each run's final holdout and held-out world mIoU
and per-class recall, so that a gap between the port's own run and JAX's
can be told apart from the spread of the draws, and put on the start or
on the batches.

    python tools/torch_train_replay.py --size 128 --width 0.25 \\
        --steps 300 --batch 4 --float32
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pickle
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from semantic_slam_mapping_tpu import cli as jcli  # noqa: E402
from semantic_slam_mapping_tpu.models import segnet as jseg  # noqa: E402
from semantic_slam_mapping_torch import cli  # noqa: E402
from semantic_slam_mapping_torch.models import segnet as tseg  # noqa: E402
from semantic_slam_mapping_torch.utils import convert  # noqa: E402
from tests.test_torch_train_cli import JaxBatches  # noqa: E402


def _meta(path: Path) -> dict:
    with open(path, "rb") as f:
        meta = pickle.load(f)["meta"]
    return {k: meta[k] for k in ("miou", "miou_heldout_world",
                                 "per_class_recall_heldout_world")}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--float32", action="store_true",
                    help="also train the port from JAX's start in float32")
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "float32")
    argv = ["train-segnet", "--size", str(args.size), "--width",
            str(args.width), "--steps", str(args.steps), "--batch",
            str(args.batch)]
    hw = -(-args.size // 32) * 32
    report = {"args": vars(args)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with contextlib.redirect_stderr(io.StringIO()), \
                contextlib.redirect_stdout(io.StringIO()):
            jcli.main(argv + ["--out", str(tmp / "jax")])
        report["jax"] = _meta(tmp / "jax" / "segnet.pkl")

        model = jseg.SegNet(width_mult=args.width)
        var = jax.device_get(jax.jit(
            lambda k, x: model.init(k, x, train=False))(
                jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3))))
        dtypes = ["bfloat16"] + (["float32"] if args.float32 else [])
        # (name, dtype, start from JAX's init, JAX-drawn batches)
        runs = [(f"port_jax_start_{d}", d, True, True) for d in dtypes]
        runs += [("port_own_draws", "bfloat16", False, False),
                 ("port_own_start_jax_batches", "bfloat16", False, True),
                 ("port_jax_start_own_batches", "bfloat16", True, False)]
        for name, dtype, jax_start, jax_batches in runs:
            ns = cli.build_parser().parse_args(
                argv + ["--out", str(tmp / name), "--device", "cpu"])
            ns.device = torch.device("cpu")
            hooks = {}
            if jax_start:
                start = tseg.SegNet(width_mult=args.width,
                                    dtype=getattr(torch, dtype))
                start.load_state_dict(convert.segnet_state_from_flax(
                    var["params"], var["batch_stats"]))
                hooks["model"] = start.eval()
            if jax_batches:
                hooks["batches"] = JaxBatches(args.size, args.batch)
            with contextlib.redirect_stderr(io.StringIO()), \
                    contextlib.redirect_stdout(io.StringIO()):
                cli.cmd_train_segnet(ns, **hooks)
            report[name] = _meta(tmp / name / "segnet.pkl")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
