"""SegNet training: back-to-back steps of ``models/segnet.make_train_step``
with the port's Adam, on batches kept on the device and cycled.

Set-up builds one train step (model, optimizer state), drives it through
its first ``checked_steps`` steps on distinct batches and hands that same
object to the window. Checked against the float32 reference from the same
weights on the same batches: each of those steps' loss; the norm of each
leaf's first gradient, as the step left it on the parameter; and the norm
of each leaf's change (the parameters and the BatchNorm buffers) after
them. A leaf's gap is the gap between the two norms over the larger of the
reference's norm of that leaf and of the median leaf; the worst leaf
counts, and for the gradient the median leaf too (a whole batch's gradient
moves every leaf a little, which one leaf's noise hides: half a batch left
out moves the median leaf thirty times as far as bfloat16 rounding does).
Leaves whose reference gradient is under a thousandth of the median
leaf's (the biases of the convolutions before BatchNorm, whose gradient is
nought but for rounding) are left out of the gradient and change
comparisons.

Once the window has closed, the same step object takes ``post_steps``
more steps, warm as the window left it, from a copy of its state (the
parameters, the buffers and Adam's moments and count); the reference
follows them from that copy, and their losses (``post_loss_gap``) and the
median leaf's change over them (``post_change_norm_median_gap``) are
compared as above.
The reference takes the program's state there: it cannot work out again
the window's thousands of steps; the start is checked from the seed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from semantic_slam_mapping_torch.models import segnet
from slambench.core import weights
from slambench.core.result import Check, Context, Outcome
from slambench.core.window import run_window
from slambench.drivers.segnet_label import build_model
from slambench.reference import segnet as ref
from slambench.traffic import batches

_NOUGHT = 1e-3


def leaf_gaps(prog, refv, keep) -> np.ndarray:
    """Each kept leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    prog, refv = np.asarray(prog), np.asarray(refv)
    scale = np.maximum(refv, np.median(refv))
    return (np.abs(prog - refv) / scale)[keep]


def _norms(tensors) -> list:
    return [float(t.double().norm()) for t in tensors]


def ordered(model: segnet.SegNet):
    """The port's parameters and BatchNorm buffers in the reference's
    order: per layer w, b, scale, shift; then the buffers mean, var."""
    params, buffers = [], []
    for blk in model.blocks:
        params += [blk.conv.weight, blk.conv.bias, blk.bn.scale, blk.bn.bias]
        buffers += [blk.bn.mean, blk.bn.var]
    params += [model.classifier.weight, model.classifier.bias]
    return params, buffers


def leaf_names(model: segnet.SegNet, params, buffers) -> list:
    """The port's names of the leaves in ``ordered``'s order."""
    named = {id(t): n for n, t in list(model.named_parameters())
             + list(model.named_buffers())}
    return [named.get(id(t), "?") for t in params + buffers]


def ref_ordered(layers):
    params = ref.trainable(layers)
    buffers = []
    for layer in layers[:-1]:
        buffers += [layer["mean"], layer["var"]]
    return params, buffers


def layers_of(params, buffers) -> list:
    """The reference's layer list holding float32 copies of the program's
    leaves, given in ``ordered``'s order."""
    params = [t.detach().float().clone() for t in params]
    buffers = [t.detach().float().clone() for t in buffers]
    layers = []
    for i in range(len(buffers) // 2):
        w, b, scale, shift = params[4 * i:4 * i + 4]
        layers.append({"w": w, "b": b, "scale": scale, "shift": shift,
                       "mean": buffers[2 * i], "var": buffers[2 * i + 1]})
    layers.append({"w": params[-2], "b": params[-1]})
    return layers


def snapshot(model: segnet.SegNet, opt: torch.optim.Optimizer):
    """A copy of the train step's state: (parameters, buffers, Adam's first
    and second moments and its count, or None where the optimizer keeps no
    such state)."""
    params, buffers = ordered(model)
    index = {id(q): i for i, q in enumerate(
        q for g in opt.param_groups for q in g["params"])}
    state = opt.state_dict()["state"]
    try:
        got = [state[index[id(q)]] for q in params]
        adam = ([g["exp_avg"].detach().clone() for g in got],
                [g["exp_avg_sq"].detach().clone() for g in got],
                int(got[0]["step"]))
    except KeyError:
        adam = None
    return ([t.detach().clone() for t in params],
            [t.detach().clone() for t in buffers], adam)


def post_readings(state, batches, cw, lr: float, precision="float32"):
    """(losses, change norms) of the reference's steps on ``batches`` from
    a program ``snapshot`` (or, with ``precision``, of the control's)."""
    params, buffers, adam = state
    if adam is None:
        nan = [float("nan")] * len(batches)
        return nan, [float("nan")] * (len(params) + len(buffers)), None
    layers = layers_of(params, buffers)
    with ref.exact_float32():
        losses, grads = ref.train_steps(layers, batches, cw, lr, precision,
                                        adam_state=adam)
    p1, b1 = ref_ordered(layers)
    change = _norms([a - s.float() for a, s in zip(p1 + b1,
                                                   params + buffers)])
    return losses, change, _norms(grads)


def post_compare(prog, refr, ref_grads, n_params: int) -> dict:
    (pl, pc), (rl, rc) = prog, refr
    rg = np.asarray(ref_grads if ref_grads is not None else [np.nan])
    keep = rg >= _NOUGHT * np.median(rg)
    keep_change = (np.concatenate([keep, np.ones(len(rc) - n_params, bool)])
                   if ref_grads is not None else np.ones(len(rc), bool))
    change = leaf_gaps(pc, rc, keep_change)
    return {"post_loss_gap": max(abs(a - b) / abs(b)
                                 for a, b in zip(pl, rl)),
            "post_change_norm_median_gap": float(np.median(change)),
            "post_change_norm_worst_gap": float(change.max())}


def reference_readings(ctx: Context, images, labels, cw, precision="float32"):
    """(losses, first-gradient norms, change norms) of the reference (or,
    with ``precision``, of the control put in the program's place)."""
    n = ctx.traffic("checked_steps")
    layers = weights.segnet_layers(ctx.sub_seed("weights"),
                                   ctx.config("num_classes"), ctx.device)
    p0, b0 = ref_ordered(layers)
    start = [t.clone() for t in p0 + b0]
    with ref.exact_float32():
        losses, grads = ref.train_steps(
            layers, [(images[i], labels[i]) for i in range(n)], cw,
            ctx.traffic("lr"), precision)
    p1, b1 = ref_ordered(layers)
    change = _norms([a - s for a, s in zip(p1 + b1, start)])
    return losses, _norms(grads), change


def compare(prog, refr, n_params: int) -> dict:
    """The three numbers compared, from (losses, gradient norms, change
    norms) of the program and of the reference."""
    (pl, pg, pc), (rl, rg, rc) = prog, refr
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(pl, rl))
    rg = np.asarray(rg)
    keep = rg >= _NOUGHT * np.median(rg)
    # a buffer follows its layer's conv: it counts where the layer does
    keep_change = np.concatenate([keep, np.ones(len(rc) - n_params, bool)])
    grad = leaf_gaps(pg, rg, keep)
    return {"loss_gap": loss_gap,
            "grad_norm_gap": float(grad.max()),
            "grad_norm_median_gap": float(np.median(grad)),
            "change_norm_gap": float(leaf_gaps(pc, rc, keep_change).max())}


def run(ctx: Context) -> Outcome:
    dev = ctx.device
    B, H, W = ctx.traffic("batch"), ctx.traffic("height"), ctx.traffic("width")
    n, classes = ctx.traffic("distinct_batches"), ctx.config("num_classes")
    images, labels = batches.make(ctx.sub_seed("batches"), n, B, H, W,
                                  classes, dev)
    cw = batches.median_frequency_weights(labels, classes)
    model = build_model(ctx, weights.segnet_layers(
        ctx.sub_seed("weights"), classes, dev))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    opt = segnet.adam(model, ctx.traffic("lr"))
    step_fn = segnet.make_train_step(model, opt, cw)

    # the checked steps, through the window's own step
    params, buffers = ordered(model)
    names = leaf_names(model, params, buffers)
    start = [t.detach().clone() for t in params + buffers]
    k = ctx.traffic("checked_steps")
    losses = [step_fn(images[0], labels[0])]
    # the gradient as the step left it on each parameter (none: nothing
    # compares)
    grads = [_norms([p.grad])[0] if p.grad is not None else float("nan")
             for p in params]
    losses += [step_fn(images[i], labels[i]) for i in range(1, k)]
    prog_losses = [float(x) for x in losses]
    change = _norms([t.detach() - s for t, s in zip(params + buffers, start)])
    del start
    for i in range(ctx.traffic("warmup_steps")):
        step_fn(images[(k + i) % n], labels[(k + i) % n])
    done = {"images": 0}
    step_losses = []

    def step(i: int) -> int:
        b = (k + ctx.traffic("warmup_steps") + i) % n
        step_losses.append(step_fn(images[b], labels[b]))
        done["images"] += B
        return B

    res = run_window(step, ctx.seconds, trace=ctx.trace,
                     stretch_steps=ctx.traffic("stretch_steps"),
                     probe=lambda: dict(done), device=dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = res.trace()
    failed = int((~torch.isfinite(torch.stack(step_losses))).sum())

    # steps after the window through the same, warm step, from a copy
    state = snapshot(model, opt)
    after = [(k + ctx.traffic("warmup_steps") + res.steps + j) % n
             for j in range(ctx.traffic("post_steps"))]
    post_losses = [float(step_fn(images[b], labels[b])) for b in after]
    post_change = _norms([t.detach().float() - s.float() for t, s in zip(
        params + buffers, state[0] + state[1])])
    del model, opt, step_fn, params, buffers, step_losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    refr = reference_readings(ctx, images, labels, cw)
    nums = compare((prog_losses, grads, change), refr, len(refr[1]))
    post_batches = [(images[b], labels[b]) for b in after]
    ref_post = post_readings(state, post_batches, cw, ctx.traffic("lr"))
    post = post_compare((post_losses, post_change), ref_post[:2],
                        ref_post[2], len(refr[1]))
    # the worst leaf's change over the three steps after the window swings
    # from seed to seed (0.03-0.29 in bfloat16, 0.001-0.002 in float32):
    # rounding at a trained state, where gradients are small; the median
    # leaf's is compared, the worst kept in the notes
    post_worst = post.pop("post_change_norm_worst_gap")
    nums.update(post)
    control = {}
    if ctx.overrides.get("control_readings"):
        low = post_readings(state, post_batches, cw, ctx.traffic("lr"),
                            "float8")
        control = {f"control_{key}": v for key, v in post_compare(
            low[:2], ref_post[:2], ref_post[2], len(refr[1])).items()}
    worst = np.argmax(np.where(np.asarray(refr[1]) >= _NOUGHT * np.median(
        refr[1]), np.abs(np.asarray(grads) - refr[1]) / np.maximum(
            refr[1], np.median(refr[1])), -1.0))
    limits = ctx.traffic("limits")
    return Outcome(
        rates={"train_images_per_s": res.rate},
        setup_s=res.started - ctx.t_start,
        attempted=res.steps, failed=failed, memory_peak_bytes=peak,
        checks=[Check(name, v, limits[name] if limits[name] is not None
                      else float("nan")) for name, v in nums.items()],
        trace=trace,
        notes={"window_s": res.seconds, "steps": res.steps,
               "losses": prog_losses, "reference_losses": refr[0],
               "post_losses": post_losses, "reference_post_losses":
                   ref_post[0],
               "post_change_norm_worst_gap": post_worst,
               "grad_worst_leaf": names[worst],
               "grad_worst_leaf_norms": [grads[worst], refr[1][worst]],
               "reference_s": time.perf_counter() - t, **control})


def control(ctx: Context) -> dict:
    """The control's readings at the cell's size: the float8 reference put
    in the program's place, against the float32 reference."""
    n, classes = ctx.traffic("distinct_batches"), ctx.config("num_classes")
    images, labels = batches.make(ctx.sub_seed("batches"), n,
                                  ctx.traffic("batch"), ctx.traffic("height"),
                                  ctx.traffic("width"), classes, ctx.device)
    cw = batches.median_frequency_weights(labels, classes)
    low = reference_readings(ctx, images, labels, cw, precision="float8")
    refr = reference_readings(ctx, images, labels, cw)
    return compare(low, refr, len(refr[1]))
