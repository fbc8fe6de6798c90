"""Offline labelling: back-to-back ``models/segnet.infer`` on batches kept on
the device, each batch's labels copied to host memory.

Checked: the labels of a seeded sample of batches, from their last pass
through the window, against the float32 reference's logits on the same
images: the share of their pixels whose labelled class's logit lies more
than ``label_gap_spreads`` standard deviations of the logits below the
reference's best. (Neither the widest gap nor the share of labels unlike
the reference's argmax tells bfloat16 from float8 here: with drawn weights
the pooling indices of SegNet flip on rounding, and a fifth or more of
any bfloat16 run's labels differ from float32's by a small gap; the tail
beyond a few spreads is where the two precisions part.)
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
from slambench.reference import segnet as ref
from slambench.traffic import batches

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(ctx: Context, layers) -> segnet.SegNet:
    with torch.device(ctx.device):
        dtype = _DTYPES[ctx.config("precision")["network"]]
        model = segnet.SegNet(num_classes=ctx.config("num_classes"),
                              dtype=dtype, width_mult=ctx.config("width_mult"))
    model.load_state_dict(weights.port_state(layers))
    return model


def reference_gaps(ctx: Context, images: torch.Tensor, labels: dict,
                   precision: str = "float32") -> float:
    """The share (%) of the kept labels' pixels whose class's logit lies
    more than the traffic's ``label_gap_spreads`` below the reference's best
    (or, with ``precision``, of the control's labels)."""
    layers = weights.segnet_layers(ctx.sub_seed("weights"),
                                   ctx.config("num_classes"), ctx.device)
    wrong, count = 0, 0
    with ref.exact_float32(), torch.no_grad():
        for b, got in labels.items():
            for i in range(images.shape[1]):
                logits = ref.forward(layers, images[b, i:i + 1])[0]
                if got is None:         # the control labels the image
                    lab = ref.forward(layers, images[b, i:i + 1],
                                      precision=precision)[0].argmax(-1)
                else:
                    lab = got[i].to(ctx.device)
                gap = ref.logit_gap(logits, lab)
                wrong += int((gap > ctx.traffic("label_gap_spreads")).sum())
                count += gap.numel()
    return 100.0 * wrong / count


def run(ctx: Context) -> Outcome:
    dev = ctx.device
    B, H, W = ctx.traffic("batch"), ctx.traffic("height"), ctx.traffic("width")
    n = ctx.traffic("distinct_batches")
    images, _ = batches.make(ctx.sub_seed("batches"), n, B, H, W,
                             ctx.config("num_classes"), dev, labels=False)
    model = build_model(ctx, weights.segnet_layers(
        ctx.sub_seed("weights"), ctx.config("num_classes"), dev)).eval()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(ctx.traffic("warmup_batches")):
        segnet.infer(model, images[i % n]).cpu()
    rng = np.random.default_rng(ctx.sub_seed("sample"))
    sample = set(rng.choice(n, ctx.traffic("check_batches"),
                            replace=False).tolist())
    kept = {}
    done = {"images": 0}

    def step(i: int) -> int:
        b = i % n
        labels = segnet.infer(model, images[b]).cpu()
        if b in sample:
            kept[b] = labels
        done["images"] += B
        return B

    res = run_window(step, ctx.seconds, trace=ctx.trace,
                     stretch_steps=ctx.traffic("stretch_steps"),
                     probe=lambda: dict(done), device=dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = res.trace()
    setup_s = res.started - ctx.t_start
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    gap = reference_gaps(ctx, images, kept)
    limit = ctx.traffic("limits")["label_wrong_pct"]
    return Outcome(
        rates={"label_images_per_s": res.rate}, setup_s=setup_s,
        attempted=res.steps, failed=0, memory_peak_bytes=peak,
        checks=[Check("label_wrong_pct", gap, limit if limit is not None
                      else float("nan"))],
        trace=trace,
        notes={"window_s": res.seconds, "batches": res.steps,
               "checked_batches": sorted(kept), "reference_s":
               time.perf_counter() - t})


def control(ctx: Context) -> dict:
    """The control's reading at the cell's size: the float8 reference put
    in the program's place, on the batches the check would sample."""
    n = ctx.traffic("distinct_batches")
    images, _ = batches.make(ctx.sub_seed("batches"), n, ctx.traffic("batch"),
                             ctx.traffic("height"), ctx.traffic("width"),
                             ctx.config("num_classes"), ctx.device,
                             labels=False)
    rng = np.random.default_rng(ctx.sub_seed("sample"))
    sample = rng.choice(n, ctx.traffic("check_batches"), replace=False)
    return {"label_wrong_pct": reference_gaps(
        ctx, images, {int(b): None for b in sample}, precision="float8")}
