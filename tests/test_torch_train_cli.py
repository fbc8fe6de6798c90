"""The port's SegNet checkpoint writer and ``cli train-segnet`` against the
JAX package's.

Test 1: ``median_frequency_weights`` equals JAX's on three label batches
(exactly: both compute in float64 numpy and round to float32). A float32
network at ``width_mult=0.125`` crosses both ways, in float32 and with
``store_dtype=np.float16``: the port's ``save_checkpoint`` read by JAX's
``load_checkpoint``, and JAX's ``save_checkpoint`` read by the port's
``load_checkpoint``. The weights read equal the weights written (rounded
to float16 where stored so), the dtype, width and ``meta`` cross, and the
two packages' logits of the same weights on one (1, 64, 96, 3) input agree
within 1e-4 of the largest logit (float32 sums in other orders).

Test 2: ``cli train-segnet --device cpu --size 64 --width 0.125 --steps 3
--batch 2`` with JAX's initial parameters and JAX-drawn batches replayed
through the command's hooks: the batches of the JAX package's
``make_batch``, ``make_batch_loop`` and ``make_heldout_batch`` closures
(copied here, jitted as the command jits them) with the command's keys.
Without ``--device cpu`` and with no card, the port's command raises. The
JAX package's own ``train-segnet`` runs with the same arguments. Both
print the same class weights; their printed losses (steps 0 and 2, the
working dtype bfloat16) agree within 5e-3 at step 0 and 2e-2 at step 2
(relative; measured 8.9e-4 and 2.6e-3: the port rounds each op to
bfloat16 as Flax writes it, JAX's jitted step keeps some intermediates in
float32, and Adam's first steps follow the sign of near-zero gradients;
see test_torch_segnet_train.py).
The port's ``segnet.pkl`` has the JAX pickle's ``meta`` keys and is read
by JAX's ``load_checkpoint``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_mapping_tpu import cli as jcli
from semantic_slam_mapping_tpu.config import CameraConfig as JaxCameraConfig
from semantic_slam_mapping_tpu.config import SegNetConfig as JaxSegNetConfig
from semantic_slam_mapping_tpu.geometry import se3 as jse3
from semantic_slam_mapping_tpu.geometry.camera import Intrinsics as JaxK
from semantic_slam_mapping_tpu.io import synthetic as jsyn
from semantic_slam_mapping_tpu.models import segnet as jseg
from semantic_slam_mapping_torch import cli
from semantic_slam_mapping_torch.config import SegNetConfig
from semantic_slam_mapping_torch.models import segnet as tseg
from semantic_slam_mapping_torch.utils import convert

torch.set_num_threads(4)


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _logits_agree(jax_logits, port_logits):
    a = np.asarray(jax_logits, np.float64)
    b = port_logits.detach().numpy().astype(np.float64)
    assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


def test_class_weights_and_checkpoints_cross_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    labels = [rng.integers(0, k, (2, 32, 48)) for k in (5, 9, 12)]
    labels[0][0, :4] = 11
    np.testing.assert_array_equal(
        tseg.median_frequency_weights([torch.from_numpy(y) for y in labels],
                                      12).numpy(),
        np.asarray(jseg.median_frequency_weights(labels, 12)))

    cfg = SegNetConfig(width_mult=0.125, dtype="float32")
    jcfg = JaxSegNetConfig(width_mult=0.125, dtype="float32")
    x = rng.random((1, 64, 96, 3), dtype=np.float32)
    port = tseg.create(cfg, torch.Generator().manual_seed(1))
    # BatchNorm statistics that are not the identity
    for blk in port.blocks:
        blk.bn.mean.uniform_(-0.5, 0.5)
        blk.bn.var.uniform_(0.5, 2.0)
        blk.bn.scale.data.uniform_(0.5, 1.5)
    meta = {"miou": 0.5, "steps": 3}
    for store in (None, np.float16):
        cast = (lambda a: a) if store is None else (
            lambda a: a.astype(store).astype(np.float32))

        # port -> JAX
        path = tmp_path / f"port_{store}.pkl"
        tseg.save_checkpoint(path, cfg, port, meta=meta, store_dtype=store)
        jmodel, jvar, jmeta = jseg.load_checkpoint(path)
        assert jmeta == meta and jmodel.dtype == jnp.float32
        assert jmodel.width_mult == 0.125
        written = convert.segnet_state_to_flax(port.state_dict())
        for tree, got in zip(written, (jvar["params"], jvar["batch_stats"])):
            got = _leaves(got)
            for key, a in _leaves(tree).items():
                np.testing.assert_array_equal(got[key], cast(a))
        reread, _ = tseg.load_checkpoint(path)
        with torch.no_grad():
            _logits_agree(jmodel.apply(jvar, x, train=False),
                          reread(torch.from_numpy(x)))

        # JAX -> port
        path = tmp_path / f"jax_{store}.pkl"
        jseg.save_checkpoint(path, jcfg, jvar["params"], jvar["batch_stats"],
                             meta=meta, store_dtype=store)
        back, tmeta = tseg.load_checkpoint(path)
        assert tmeta == meta and back.dtype == torch.float32
        assert not back.training
        for k, v in reread.state_dict().items():
            np.testing.assert_array_equal(back.state_dict()[k].numpy(),
                                          cast(v.numpy()))
        jmodel, jvar, _ = jseg.load_checkpoint(path)
        with torch.no_grad():
            _logits_agree(jmodel.apply(jvar, x, train=False),
                          back(torch.from_numpy(x)))


class JaxBatches:
    """The batches of the JAX package's ``cmd_train_segnet``: its three
    batch closures, copied, with its keys."""

    def __init__(self, size: int, batch: int):
        h = w = -(-size // 32) * 32
        K = JaxK.from_config(JaxCameraConfig(fx=200.0, fy=200.0, cx=w / 2,
                                             cy=h / 2))

        def view(pose, world):
            img, _, sem, _ = jsyn.render(K, pose, world, h, w)
            return jnp.stack([img] * 3, -1), sem

        def street(k):
            k1, k2 = jax.random.split(k)
            world = jsyn.make_world(k1, n_boxes=10, with_moving_box=True,
                                    n_moving=9)
            pose = jse3.exp(jax.random.normal(k2, (6,)) * jnp.array(
                [0.5, 0.1, 0.5, 0.02, 0.05, 0.01]))
            return view(pose, world)

        def loop(k):
            k1, k2, k3 = jax.random.split(k, 3)
            world = jsyn.make_loop_world(k1, n_boxes=32, radius=28.0,
                                         n_moving=6)
            traj = jsyn.loop_trajectory(8, radius=28.0, laps=1.0)
            i = jax.random.randint(k2, (), 0, 8)
            pose = jse3.compose(traj[i], jse3.exp(
                jax.random.normal(k3, (6,))
                * jnp.array([0.3, 0.05, 0.3, 0.01, 0.03, 0.005])))
            return view(pose, world)

        def heldout(k):
            k1, k2, k3 = jax.random.split(k, 3)
            world = jsyn.make_loop_world(k1, n_boxes=32, radius=25.0,
                                         n_moving=6)
            th = jax.random.uniform(k2, (), maxval=2.0 * jnp.pi)
            traj = jsyn.loop_trajectory(8, radius=25.0, laps=1.0)
            pose = traj[(th / (2 * jnp.pi) * 7).astype(jnp.int32)]
            pose = jse3.compose(pose, jse3.exp(
                jax.random.normal(k3, (6,))
                * jnp.array([0.3, 0.05, 0.3, 0.01, 0.03, 0.005])))
            return view(pose, world)

        def batched(one):
            return jax.jit(lambda key: jax.vmap(one)(
                jax.random.split(key, batch)))

        self._street, self._loop = batched(street), batched(loop)
        self._heldout = batched(heldout)
        self._key = jax.random.PRNGKey(0)

    @staticmethod
    def _torch(xy):
        x, y = (np.asarray(a) for a in xy)
        return torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))

    def class_weight_batches(self):
        k = jax.random.split(jax.random.PRNGKey(77), 4)
        return [self._torch(f(key))[1] for f, key in
                zip((self._street, self._street, self._loop, self._loop), k)]

    def holdout(self):
        return self._torch(self._street(jax.random.PRNGKey(9999)))

    def heldout_world(self):
        return self._torch(self._heldout(jax.random.PRNGKey(424242)))

    def train(self, it: int):
        self._key, k = jax.random.split(self._key)
        return self._torch((self._street if it % 2 == 0 else self._loop)(k))


def _losses(stderr: str) -> dict:
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step (\d+): loss ([\d.]+) ", stderr, re.M)}


def _class_weights(stderr: str) -> str:
    return re.search(r"^class weights:.*$", stderr, re.M).group(0)


def test_cli_train_segnet_follows_jax(tmp_path, capsys):
    argv = ["train-segnet", "--size", "64", "--width", "0.125", "--steps",
            "3", "--batch", "2"]
    if not torch.cuda.is_available():
        # the card by default, and no falling back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv + ["--out", str(tmp_path / "no_card")])
    jcli.main(argv + ["--out", str(tmp_path / "jax")])
    jax_err = capsys.readouterr().err

    # JAX's start: segnet.create's init (PRNGKey(0), a 64x64 input)
    jmodel = jseg.SegNet(width_mult=0.125)
    var = jax.device_get(jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    start = tseg.SegNet(width_mult=0.125)
    start.load_state_dict(convert.segnet_state_from_flax(
        var["params"], var["batch_stats"]))
    args = cli.build_parser().parse_args(
        argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    cli.cmd_train_segnet(args, batches=JaxBatches(64, 2), model=start.eval())
    captured = capsys.readouterr()

    assert _class_weights(captured.err) == _class_weights(jax_err)
    ours, theirs = _losses(captured.err), _losses(jax_err)
    assert sorted(ours) == sorted(theirs) == [0, 2]
    assert abs(ours[0] - theirs[0]) <= 5e-3 * theirs[0]
    assert abs(ours[2] - theirs[2]) <= 2e-2 * theirs[2]
    assert captured.out.startswith(
        f"saved {tmp_path / 'port' / 'segnet.pkl'} (holdout mIoU ")

    model, variables, meta = jseg.load_checkpoint(
        tmp_path / "port" / "segnet.pkl")
    _, _, jax_meta = jseg.load_checkpoint(tmp_path / "jax" / "segnet.pkl")
    assert sorted(meta) == sorted(jax_meta)
    assert meta["steps"] == 3 and meta["train_size"] == 64
    assert model.width_mult == 0.125 and model.dtype == jnp.bfloat16
    assert sorted(variables["params"]) == sorted(var["params"])
