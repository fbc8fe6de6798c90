"""The port's dp x tp sharded SegNet training (``parallel/mesh.py``'s
shardings, ``parallel/sharded_segnet.py``) against the port's
single-device SegNet and the JAX package's sharded train step, over gloo
on the CPU (the rank bodies are in ``torch_mesh_ranks.py``).

The network starts from the JAX package's ``create(seed=0)`` parameters at
``width_mult=0.25`` and 32x32 px, carried across by
``utils/convert.segnet_state_from_flax``; images, labels, a
``label_valid`` mask and class weights come from a numpy seed. At this
width tp = 2 splits every kernel and keeps the 1-D parameters of the 16-
and 32-channel layers replicated: a rank uses them on its channel slice.

Test 1: ``param_shardings`` equals JAX's ``param_shardings`` tensor by
tensor at tp = 1, 2, 4, 8 for widths 0.25 and 1.0 (and on the ranks' own
(1, n) meshes at full width); ``batch_sharding`` gives each data rank its
``tensor_split`` rows and ``replicated`` the whole batch. Then the float64
sharded loss, batch statistics (the BatchNorm buffers after one
train-mode forward) and
gradients (gathered) on the meshes (1, 2), (2, 1), (2, 2) and (1, 4) with
a batch of 4, (2, 1) with a batch of 3 (ranks of 2 and 1 rows), (1, 3)
(every block replicated, the classifier split: a whole activation feeds a
split convolution) and (1, 2) with 11 classes (split blocks, a replicated
classifier: split activations feed a whole convolution), against the
port's single-device float64 path on the same inputs: the loss within
1e-12 (relative), each buffer and gradient within 1e-9 of its norm (the
all-reduces sum in another order than one device), the gradients of the
convolution biases ahead of BatchNorm (zero in exact arithmetic) under
1e-12 of their kernel's in both; every rank the same bits; and the
collectives counted: where every layer is split, 27 gathers over the model
axis (25 before block convolutions, one before the classifier, one of the
logits) and 26 reduce-scatters back, 26 statistics all-reduces forward
and 26 back, one for the loss, two gradient buckets.

Test 2: three Adam steps (lr 3e-4) on a (2, 2) mesh in float32, batches
of 4, against the JAX package's jitted ``make_train_step`` with
``optax.adam(3e-4)`` on a (2, 2) JAX mesh under ``shard_params``, the batch
under ``batch_sharding`` (as ``tests/test_parallel.py`` does), with the
tolerances ``tests/test_torch_segnet_train.py`` states: after the first
step the loss within 2e-5 (relative) and the buffers within 1e-4 of their
norm; each parameter within 2 lr per step taken; the later losses within
1e-2 and the later buffers within 0.1. Adam's first step is about ``lr *
sign(g)``, so a near-zero float32 gradient may step either way. In the
same test the float64 sharded run stays within 1e-9 of the single-device
float64 run after every step (loss, parameters and buffers, relative to
each tensor's norm), two float32 sharded runs are identical, and every
replicated parameter is the same on every rank.
"""

import copy
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from semantic_slam_mapping_tpu.config import SegNetConfig as JaxSegNetConfig
from semantic_slam_mapping_tpu.models import segnet as jseg
from semantic_slam_mapping_tpu.parallel import mesh as jmesh
from semantic_slam_mapping_torch.models import segnet as tseg
from semantic_slam_mapping_torch.parallel import mesh as tmesh
from semantic_slam_mapping_torch.utils import convert

import torch_mesh_ranks
from torch_mesh_ranks import grad_case_key, run_ranks

torch.set_num_threads(2)

WIDTH = 0.25
HW = 32
LR = 3e-4


@functools.cache
def _jax_start(width: float = WIDTH):
    """JAX's model and ``create(seed=0)`` variables (numpy), float32."""
    model, var = jseg.create(JaxSegNetConfig(
        input_height=HW, input_width=HW, width_mult=width, dtype="float32"),
        seed=0)
    return model, jax.device_get(var)


def _port_name(path) -> str:
    """A Flax parameter path -> the port's parameter name."""
    keys = [k.key for k in path]
    leaf = {"kernel": "weight", "bias": "bias", "scale": "scale"}[keys[-1]]
    if keys[0] == "Conv_0":
        return f"classifier.{leaf}"
    i = int(keys[0].rpartition("_")[2])
    return f"blocks.{i}.{'conv' if keys[1] == 'Conv_0' else 'bn'}.{leaf}"


def _inputs(seed: int, batch: int = 4):
    rng = np.random.default_rng(seed)
    x = rng.random((batch, HW, HW, 3), dtype=np.float32)
    y = rng.integers(0, 12, (batch, HW, HW)).astype(np.int64)
    valid = rng.random((batch, HW, HW)) > 0.2
    cw = (0.5 + rng.random(12)).astype(np.float32)
    return x, y, valid, cw


def _start_state() -> dict:
    var = _jax_start()[1]
    return {f"state.{k}": v.numpy() for k, v in
            convert.segnet_state_from_flax(var["params"],
                                           var["batch_stats"]).items()}


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(b), 1e-300))


def _is_pre_bn_bias(name: str) -> bool:
    return name.startswith("blocks.") and name.endswith(".conv.bias")


def test_param_shardings_and_sharded_grads_match(tmp_path):
    # the shardings against JAX's, tensor by tensor
    for width in (WIDTH, 1.0):
        jmodel = jseg.SegNet(dtype=jnp.float32, width_mult=width)
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)),
            train=False))["params"]
        port = tseg.SegNet(width_mult=width)
        for tp in (1, 2, 4, 8):
            jm = jmesh.make_mesh(8, dp=8 // tp, tp=tp)
            want = {_port_name(path): jmesh.MODEL_AXIS in str(s.spec)
                    for path, s in jax.tree_util.tree_leaves_with_path(
                        jmesh.param_shardings(shapes, jm))}
            got = tmesh.param_shardings(port, tp)
            assert set(got) == set(want)
            assert {k: v is not None for k, v in got.items()} == want, tp
            if tp == 2 and width == WIDTH:
                # both kinds of 1-D parameter at the tests' width
                assert not want["blocks.0.bn.scale"]
                assert want["blocks.12.bn.scale"]

    x, y, valid, cw = _inputs(0)
    np.savez(tmp_path / "inputs.npz", width=WIDTH, images=x, labels=y,
             valid=valid, class_weights=cw, **_start_state())
    inputs = dict(np.load(tmp_path / "inputs.npz"))
    ranks = {n: run_ranks("sharded_grads", n, tmp_path) for n in (2, 3, 4)}

    for n, outs in ranks.items():
        wide = tmesh.param_shardings(tseg.SegNet(width_mult=1.0), n)
        want_split = sorted(k for k, v in wide.items() if v is not None)
        for r, out in enumerate(outs):
            assert sorted(out["full_width_split"]) == want_split
            for (dp, tp), batch, classes in torch_mesh_ranks.GRAD_CASES[n]:
                # the data rank's rows, as tensor_split cuts them
                k = grad_case_key((dp, tp), batch, classes) + "/rows"
                np.testing.assert_array_equal(out[k], np.array_split(
                    inputs["images"][:batch], dp)[r // tp])
            for k, v in outs[0].items():
                if not k.endswith("/rows"):
                    np.testing.assert_array_equal(out[k], v, err_msg=k)
        for shape, batch, classes in torch_mesh_ranks.GRAD_CASES[n]:
            _check_grads(inputs, outs[0], shape, batch, classes)


def _check_grads(inputs, out, shape, batch, classes):
    key = grad_case_key(shape, batch, classes)
    ref = torch_mesh_ranks.segnet_start(inputs, torch.float64, classes)
    loss = tseg.loss_fn(ref, torch.from_numpy(inputs["images"][:batch]),
                        torch.from_numpy(inputs["labels"][:batch] % classes),
                        torch.from_numpy(inputs["valid"][:batch]),
                        torch.from_numpy(
                            inputs["class_weights"][:classes]).double())
    loss.backward()
    loss = float(loss.detach())
    assert abs(float(out[f"{key}/loss"]) - loss) <= 1e-12 * abs(loss), key
    for name, b in ref.named_buffers():
        assert _rel(out[f"{key}/buffer.{name}"], b.numpy()) < 1e-9, (
            key, name)
    for name, p in ref.named_parameters():
        g, want = out[f"{key}/grad.{name}"], p.grad.numpy()
        if _is_pre_bn_bias(name):
            kernel = name.replace(".bias", ".weight")
            for a, k in ((g, out[f"{key}/grad.{kernel}"]),
                         (want, ref.get_parameter(kernel).grad.numpy())):
                assert np.linalg.norm(a) < 1e-12 * np.linalg.norm(k), (
                    key, name)
            continue
        assert _rel(g, want) < 1e-9, (key, name, _rel(g, want))
    # collectives: at these widths tp = 3 splits no block, the others
    # split every block; the classifier splits where tp divides the classes
    tp = shape[1]
    blocks_split, cls_split = tp != 3, classes % tp == 0
    calls = {k: int(out[f"{key}/calls.{k}"])
             for k in ("all_gather", "reduce_scatter", "all_reduce_sum")}
    assert calls == {
        "all_gather": 26 * blocks_split + cls_split,
        "reduce_scatter": 25 * blocks_split + cls_split * blocks_split,
        # statistics forward and back, the loss, two gradient buckets,
        # and the backward of a whole activation into a split classifier
        "all_reduce_sum": 2 * 26 + 1 + 2 + (not blocks_split)}, (key, calls)


def test_three_sharded_adam_steps_match_jax(tmp_path):
    batches = [_inputs(10 + i)[:2] for i in range(3)]
    cw = _inputs(10)[3]
    np.savez(tmp_path / "inputs.npz", width=WIDTH, lr=LR, class_weights=cw,
             **{f"x{i}": b[0] for i, b in enumerate(batches)},
             **{f"y{i}": b[1] for i, b in enumerate(batches)},
             **_start_state())
    inputs = dict(np.load(tmp_path / "inputs.npz"))
    outs = run_ranks("sharded_adam", 4, tmp_path)

    # JAX's jitted step on a (2, 2) mesh of the conftest's devices
    model, var = _jax_start()
    m = jmesh.make_mesh(4, dp=2, tp=2)
    params = jmesh.shard_params(var["params"], m)
    stats = jax.device_put(var["batch_stats"], jmesh.replicated(m))
    opt = optax.adam(LR)
    opt_state = opt.init(params)
    jstep = jax.jit(jseg.make_train_step(model, opt,
                                         class_weights=jnp.asarray(cw)))

    # the single-device float64 run
    ref = torch_mesh_ranks.segnet_start(inputs, torch.float64)
    rstep = tseg.make_train_step(ref, tseg.adam(ref, LR),
                                 class_weights=torch.from_numpy(cw).double())

    out = outs[0]
    for other in outs[1:]:
        for k, v in out.items():
            if "/replica." in k:
                np.testing.assert_array_equal(other[k], v, err_msg=k)
    for i, (x, y) in enumerate(batches):
        params, stats, opt_state, jl = jstep(
            params, stats, opt_state,
            jax.device_put(jnp.asarray(x), jmesh.batch_sharding(m)),
            jax.device_put(jnp.asarray(y.astype(np.int32)),
                           jmesh.batch_sharding(m)))
        jstate = {f"state.{k}": v.numpy() for k, v in
                  convert.segnet_state_from_flax(
                      jax.device_get(params),
                      jax.device_get(stats)).items()}
        rl = float(rstep(torch.from_numpy(x).double(), torch.from_numpy(y)))
        rstate = {f"state.{k}": v.numpy()
                  for k, v in copy.deepcopy(ref).state_dict().items()}

        names = [k for k in out if k.startswith(f"f32a/{i}/state.")]
        for k in [f"f32a/{i}/loss"] + names:
            np.testing.assert_array_equal(
                out[k], out[k.replace("f32a", "f32b")], err_msg=k)

        loss_tol, stats_tol = (2e-5, 1e-4) if i == 0 else (1e-2, 0.1)
        tl = float(out[f"f32a/{i}/loss"])
        assert abs(tl - float(jl)) <= loss_tol * abs(float(jl)), i
        assert abs(float(out[f"f64/{i}/loss"]) - rl) <= 1e-9 * abs(rl), i
        for k in names:
            name = k.split("/")[-1]
            got, want = out[k], jstate[name]
            if re.search(r"\.bn\.(mean|var)$", name):
                assert _rel(got, want) < stats_tol, (i, name)
            else:
                assert np.abs(got - want).max() <= 2 * LR * (i + 1), (
                    i, name)
            got64, want64 = out[k.replace("f32a", "f64")], rstate[name]
            if _is_pre_bn_bias(name[len("state."):]):
                # Adam's steps on rounding noise: tiny in both
                assert max(np.abs(got64).max(), np.abs(want64).max()) < 1e-9
            else:
                assert _rel(got64, want64) < 1e-9, (i, name)
