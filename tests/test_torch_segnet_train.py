"""The port's SegNet training against the JAX package's.

Both tests use a float32 network at ``width_mult=0.125`` started from the
JAX package's initial parameters (``model.init`` with ``PRNGKey(0)``, as
its ``create`` draws them) carried across, on (2, 64, 96, 3) images, labels,
a ``label_valid`` mask and class weights made from a numpy seed. The JAX
side runs op by op (outside ``jit``).

A float32 gradient of this network is ill-conditioned by Flax's fast
BatchNorm variance ``E[y^2] - E[y]^2``. Against the port's float64
gradients (the same formula in float64), the port's float32 gradients
differ by up to 2.3e-3 of a tensor's norm, JAX's op-by-op float32
gradients by up to 3.8e-2 and JAX's jitted ones by up to 0.59; with a
two-pass variance the port's float32 gradients come within 3.6e-5 of
float64. The tolerances below are set from those spreads. The bias of a
convolution that feeds a train-mode BatchNorm has a zero gradient in exact
arithmetic (BatchNorm subtracts the channel's mean), so both packages'
are rounding noise, held to be tiny, not equal; Adam turns such noise into
steps of up to ``lr``, which move the BatchNorm running means.

Test 1:
  - the repaired ``create`` against JAX's ``create``: each kernel's
    standard deviation within 15% of JAX's (within 2% where a kernel has
    at least 20,000 weights; sampling error of the smallest, 216 weights,
    is about 5%), no weight past two of Flax's truncation sigmas
    (sqrt(1/fan_in) / 0.8796), zero biases, identity BatchNorm;
  - train-mode forward, ``loss_fn`` and its gradients against JAX's
    ``loss_fn`` and ``jax.grad``: the loss within 2e-5 of it (relative),
    the new batch statistics within 1e-4 of their norm, each gradient of
    the port in float32 and in float64 within 0.1 of JAX's norm (median
    over tensors within 0.05) and the float32 one within 1e-2 of the
    float64 one, the convolution biases ahead of BatchNorm under 1e-5 of
    their kernel's gradient in both packages;
  - the bfloat16 network's loss within 5e-3 (relative) and its batch
    statistics within 5e-2 of their norm (JAX op by op rounds each op to
    bfloat16 as the port does; the sums of the convolutions round apart).

Test 2:
  - the Adam update alone against ``optax.adam``: three steps with the
    same random gradients (magnitudes from 1e-4 to 10) on parameters of
    about 1e-3 move them as optax does within 1e-5 of the update (float32
    rounding of the sums; the two order the bias corrections apart);
  - three ``make_train_step`` steps against JAX's ``make_train_step`` with
    ``optax.adam(3e-4)`` on three batches from the same start: after the
    first step the loss within 2e-5 (relative) and the BatchNorm buffers
    within 1e-4 of their norm; after every step each parameter within
    2 lr per step taken of JAX's, the change that the steps so far made to
    the loss of the first batch (both parameter sets through the port's
    ``loss_fn``) within 40% of JAX's and of its sign (a skipped step, or
    an lr off by 2x, is 50-100% off); the later losses within 1e-2 and the
    later buffers within 0.1 of their norm. Adam's first step is about
    ``lr * sign(g)``, so every element whose float32 gradient is near
    zero takes a step of either sign: the port's first step moves that
    loss by 78% of JAX's, the third by 93%, and JAX's own jitted and
    op-by-op runs part by 3.3e-3 in the second step's loss, where the
    port and JAX part by 7.5e-4.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from semantic_slam_mapping_tpu.models import segnet as jseg
from semantic_slam_mapping_torch.config import SegNetConfig
from semantic_slam_mapping_torch.models import segnet as tseg
from semantic_slam_mapping_torch.utils import convert

torch.set_num_threads(4)

WIDTH = 0.125
SHAPE = (2, 64, 96, 3)
LR = 3e-4
_TRUNC_SIGMA = 1.0 / 0.87962566103423978


@functools.cache
def _jax_init(dtype: str = "float32"):
    """JAX's model and initial variables (numpy), as its ``create`` makes
    them (``model.init`` with ``PRNGKey(0)``) at this width and input
    size."""
    model = jseg.SegNet(dtype=jnp.float32 if dtype == "float32"
                        else jnp.bfloat16, width_mult=WIDTH)
    init = jax.jit(lambda k, x: model.init(k, x, train=False))
    var = jax.device_get(init(jax.random.PRNGKey(0),
                              jnp.zeros((1, *SHAPE[1:]))))
    return model, var


def _port(var, dtype=torch.float32):
    model = tseg.SegNet(width_mult=WIDTH, dtype=dtype)
    model.load_state_dict(convert.segnet_state_from_flax(
        var["params"], var["batch_stats"]))
    return model.eval()


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.random(SHAPE, dtype=np.float32)
    y = rng.integers(0, 12, SHAPE[:3]).astype(np.int32)
    valid = rng.random(SHAPE[:3]) > 0.2
    cw = (0.5 + rng.random(12)).astype(np.float32)
    return x, y, valid, cw


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b) -> float:
    """|a - b| relative to |b| (Frobenius norms)."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _is_pre_bn_bias(key: str) -> bool:
    return key.startswith("['ConvBNRelu") and key.endswith(
        "['Conv_0']['bias']")


def _flax_grads(model) -> dict:
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads.update(model.named_buffers())
    return _leaves(convert.segnet_state_to_flax(grads)[0])


def _flax_state(model):
    params, stats = convert.segnet_state_to_flax(model.state_dict())
    return _leaves(params), _leaves(stats)


def test_create_train_forward_loss_and_grads_match_jax():
    model, var = _jax_init()

    # the repaired create: Flax's init distribution
    port = tseg.create(SegNetConfig(input_height=SHAPE[1],
                                    input_width=SHAPE[2], width_mult=WIDTH,
                                    dtype="float32"),
                       torch.Generator().manual_seed(0))
    tp, tb = _flax_state(port)
    jp = _leaves(var["params"])
    for key, j in jp.items():
        t = tp[key]
        if key.endswith("['kernel']"):
            fan_in = np.prod(j.shape[:-1])
            share = abs(t.std() / j.std() - 1.0)
            assert share < (0.02 if j.size >= 20_000 else 0.15), (key, share)
            limit = _TRUNC_SIGMA * 2.0 / np.sqrt(fan_in) * (1 + 1e-6)
            assert np.abs(t).max() <= limit, key
            assert np.abs(j).max() <= limit, key
        elif key.endswith("['scale']"):
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_array_equal(t, 0.0)
    for key, j in _leaves(var["batch_stats"]).items():
        np.testing.assert_array_equal(tb[key], j)

    # float32: train-mode loss, new batch statistics, gradients
    x, y, valid, cw = _inputs(0)

    def jax_loss(p):
        return jseg.loss_fn(model, p, var["batch_stats"], jnp.asarray(x),
                            jnp.asarray(y), jnp.asarray(valid),
                            jnp.asarray(cw))

    (jl, jbs), jg = jax.value_and_grad(jax_loss, has_aux=True)(
        var["params"])
    port = _port(var)
    tl = tseg.loss_fn(port, torch.from_numpy(x), torch.from_numpy(y),
                      torch.from_numpy(valid), torch.from_numpy(cw))
    tl.backward()
    assert not port.training
    assert abs(float(tl.detach()) - float(jl)) <= 2e-5 * abs(float(jl))
    t_stats = _flax_state(port)[1]
    for key, j in _leaves(jax.device_get(jbs)).items():
        assert _rel(t_stats[key], j) < 1e-4, key
    port64 = _port(var, torch.float64).double()
    tseg.loss_fn(port64, torch.from_numpy(x).double(), torch.from_numpy(y),
                 torch.from_numpy(valid),
                 torch.from_numpy(cw).double()).backward()
    tg, tg64 = _flax_grads(port), _flax_grads(port64)
    jgl = _leaves(jax.device_get(jg))
    errors = []
    for key, j in jgl.items():
        if _is_pre_bn_bias(key):
            kernel = key.replace("['bias']", "['kernel']")
            for g in (tg, jgl):
                assert (np.linalg.norm(g[key])
                        < 1e-5 * np.linalg.norm(g[kernel])), key
            continue
        errors += [_rel(tg[key], j), _rel(tg64[key], j)]
        assert max(errors[-2:]) < 0.1, (key, errors[-2:])
        assert _rel(tg[key], tg64[key]) < 1e-2, key
    assert np.median(errors) < 0.05

    # bfloat16: loss and batch statistics, op by op
    model16, var16 = _jax_init("bfloat16")
    jl16, jbs16 = jseg.loss_fn(model16, var16["params"],
                               var16["batch_stats"], jnp.asarray(x),
                               jnp.asarray(y), jnp.asarray(valid),
                               jnp.asarray(cw))
    port16 = _port(var16, torch.bfloat16)
    with torch.no_grad():
        tl16 = tseg.loss_fn(port16, torch.from_numpy(x), torch.from_numpy(y),
                            torch.from_numpy(valid), torch.from_numpy(cw))
    assert abs(float(tl16) - float(jl16)) <= 5e-3 * abs(float(jl16))
    t_stats = _flax_state(port16)[1]
    for key, j in _leaves(jax.device_get(jbs16)).items():
        assert _rel(t_stats[key], j) < 5e-2, key


def test_adam_and_three_train_steps_match_jax():
    # the optimizer alone: identical gradients, three steps
    rng = np.random.default_rng(3)
    # small parameters, so that their float32 rounding stays far below
    # the lr-sized updates compared
    p0 = {"a": (1e-3 * rng.normal(size=(4, 5))).astype(np.float32),
          "b": (1e-3 * rng.normal(size=(7,))).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              * 10.0 ** rng.uniform(-4, 1) for k, v in p0.items()}
             for _ in range(3)]
    jopt = optax.adam(LR)
    jp, state = dict(p0), jopt.init(p0)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in p0.items()}
    topt = torch.optim.Adam(tparams.values(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8)
    for g in grads:
        upd, state = jopt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k, p in tparams.items():
            j = np.asarray(jp[k], np.float64)
            assert _rel(p.detach().numpy() - p0[k], j - p0[k]) < 1e-5, k

    # three train steps from JAX's start on three batches
    model, var = _jax_init()
    batches = [_inputs(10 + i)[:2] for i in range(3)]
    cw = _inputs(10)[3]
    jstep = jseg.make_train_step(model, jopt, class_weights=jnp.asarray(cw))
    params, stats = var["params"], var["batch_stats"]
    opt_state = jopt.init(params)
    port = _port(var)
    tstep = tseg.make_train_step(port, tseg.adam(port, LR),
                                 class_weights=torch.from_numpy(cw))
    x0, y0 = (torch.from_numpy(a) for a in batches[0])
    start = float(tseg.loss_fn(_port(var), x0, y0))
    for i, (x, y) in enumerate(batches):
        params, stats, opt_state, jl = jstep(params, stats, opt_state,
                                             jnp.asarray(x), jnp.asarray(y))
        tl = tstep(torch.from_numpy(x), torch.from_numpy(y))
        assert port.training is False
        tp, tb = _flax_state(port)
        jvar = jax.device_get({"params": params, "batch_stats": stats})
        jpl, jbl = _leaves(jvar["params"]), _leaves(jvar["batch_stats"])
        loss_tol, stats_tol = (2e-5, 1e-4) if i == 0 else (1e-2, 0.1)
        assert abs(float(tl) - float(jl)) <= loss_tol * abs(float(jl)), i
        for key, j in jbl.items():
            assert _rel(tb[key], j) < stats_tol, (i, key)
        for key, j in jpl.items():
            assert np.abs(tp[key] - j).max() <= 2 * LR * (i + 1), (i, key)
        # what the steps so far did to the loss of the first batch, both
        # parameter sets through the port's loss_fn
        with torch.no_grad():
            moved = [float(tseg.loss_fn(m, x0, y0)) - start
                     for m in (copy.deepcopy(port), _port(jvar))]
        assert moved[1] < 0 and abs(moved[0] - moved[1]) <= 0.4 * -moved[1]
