"""Faults planted under a cell's timed path, for the checks to catch.

Each fault is a context manager that breaks one piece of the program while
a run goes on as usual; ``test_slambench_faults.py`` rehearses every cell
with each of them on the CPU and sees ``correct`` come out false. On the
card, ``python3 slambench/tests/faults.py <cell> <fault> <seed>...`` reads
a fault at the cell's own size (the numbers that set a limit's upper
reading where no control separates).
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from semantic_slam_mapping_torch.frontend import tracker  # noqa: E402
from semantic_slam_mapping_torch.mapping import native  # noqa: E402
from semantic_slam_mapping_torch.models import segnet  # noqa: E402
from semantic_slam_mapping_torch.ops import sgbm  # noqa: E402
from semantic_slam_mapping_torch.pipeline import SlamSystem  # noqa: E402

# the keyframes that the stalled map takes before it stops
STALL_AFTER = 8


@contextlib.contextmanager
def patched(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _tree(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree(fn, v) for v in x))
    return x


# -- the stereo window ------------------------------------------------------

def window_state_unchanged():
    """The batched frontend hands back the state it was given."""
    def make(orig):
        def f(state, *a, **k):
            return state, orig(state, *a, **k)[1]
        return f
    return patched(tracker, "track_frames_batched", make)


def window_half_batch():
    """Only the first half of a window's pairs is tracked; the second half
    repeats its last result."""
    def make(orig):
        def f(state, lefts, rights, *a, **k):
            B = lefts.shape[0] - 1
            h = B // 2
            state, out = orig(state, lefts[:h + 1], rights[:h + 1], *a, **k)
            return state, _tree(lambda t: torch.cat(
                [t, t[-1:].expand(B - h, *t.shape[1:])]) if t.dim() and
                t.shape[0] == h else t, out)
        return f
    return patched(tracker, "track_frames_batched", make)


def disparity_altered():
    """SGBM's valid disparities come out 2 px too large."""
    def make(orig):
        def f(*a, **k):
            r = orig(*a, **k)
            return r._replace(disparity=torch.where(
                r.valid, r.disparity + 2.0, r.disparity))
        return f
    return patched(sgbm, "compute", make)


def labels_altered():
    """SegNet's labels come out one class over."""
    def make(orig):
        def f(model, images):
            return (orig(model, images) + 1) % model.num_classes
        return f
    return patched(segnet, "infer", make)


def map_altered():
    """The voxel map takes its points 1.2 m off along each axis."""
    def make(orig):
        def f(self, xyz, *a, **k):
            off = np.float32([1.2, -1.2, 1.2])
            return orig(self, (xyz + off).astype(np.float32), *a, **k)
        return f
    return patched(native.NativeVoxelMap, "insert", make)


def map_labels_dropped():
    """The voxel map takes its points without their labels."""
    def make(orig):
        def f(self, xyz, rgb, label=None, valid=None):
            return orig(self, xyz, rgb, None, valid)
        return f
    return patched(native.NativeVoxelMap, "insert", make)


def _map_skips(skip):
    def make(orig):
        def f(self, kf, *a, **k):
            if not skip(kf.kf_id):
                orig(self, kf, *a, **k)
        return f
    return patched(SlamSystem, "_insert_kf_into_map", make)


def map_stalled():
    """The map takes the clouds of its first ``STALL_AFTER`` keyframes and
    of none after them."""
    return _map_skips(lambda i: i >= STALL_AFTER)


def map_half_keyframes():
    """The map takes every second keyframe's cloud only."""
    return _map_skips(lambda i: i % 2 == 1)


# -- SegNet labelling -------------------------------------------------------

def labels_half_batch():
    """The second half of a batch gets the first half's labels."""
    def make(orig):
        def f(model, images):
            lab = orig(model, images)
            h = (lab.shape[0] + 1) // 2
            return torch.cat([lab[:h], lab[:lab.shape[0] - h]])
        return f
    return patched(segnet, "infer", make)


def labels_stale():
    """The labeller hands back the labels of its first batch for ever."""
    def make(orig):
        first = []

        def f(model, images):
            if not first:
                first.append(orig(model, images))
            return first[0]
        return f
    return patched(segnet, "infer", make)


# -- SegNet training --------------------------------------------------------

def train_state_unchanged():
    """The optimizer's step works out its update and leaves the parameters
    as they were."""
    def make(orig):
        def f(self, *a, **k):
            params = [p for g in self.param_groups for p in g["params"]]
            saved = [p.detach().clone() for p in params]
            out = orig(self, *a, **k)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return out
        return f
    return patched(torch.optim.Adam, "step", make)


def train_half_batch():
    """The loss is the mean over the first half of the batch."""
    def make(orig):
        def f(model, images, labels, *a, **k):
            h = (images.shape[0] + 1) // 2
            return orig(model, images[:h], labels[:h], *a, **k)
        return f
    return patched(segnet, "loss_fn", make)


def train_loss_altered():
    """The loss comes out 10% high (and its gradient with it)."""
    def make(orig):
        def f(*a, **k):
            return orig(*a, **k) * 1.1
        return f
    return patched(segnet, "loss_fn", make)


FAULTS = {
    "kitti_stereo.street_w32": {
        "state_unchanged": window_state_unchanged,
        "half_batch": window_half_batch,
        "disparity_altered": disparity_altered,
        "labels_altered": labels_altered,
        "map_altered": map_altered,
        "map_labels_dropped": map_labels_dropped,
        "map_stalled": map_stalled,
        "map_half_keyframes": map_half_keyframes,
    },
    "segnet_camvid.train_b12": {
        "state_unchanged": train_state_unchanged,
        "half_batch": train_half_batch,
        "loss_altered": train_loss_altered,
    },
    "segnet_camvid.label_b8": {
        "state_unchanged": labels_stale,
        "half_batch": labels_half_batch,
        "labels_altered": labels_altered,
    },
}


def run_with_fault(cell_name: str, fault: str, seed: int, seconds: float,
                   device="cuda", overrides=None):
    """One run of the cell with ``fault`` planted (``none``: a sound run)."""
    from slambench.core import registry
    from slambench.core.result import Context
    cell = registry.resolve(cell_name, registry.load_benchmark())
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                  device=torch.device(device), t_start=time.perf_counter(),
                  overrides=overrides or {})
    plant = (contextlib.nullcontext() if fault == "none"
             else FAULTS[cell_name][fault]())
    with plant:
        return registry.load_driver(cell).run(ctx)


if __name__ == "__main__":
    # faults.py <cell> <fault|none> <seconds> <seed>... [key=json ...]
    # [--exact]: the key=json words override keys of the configuration or
    # the traffic (control_readings=true adds the controls' readings to the
    # notes); --exact turns TF32 off for the program too
    words = [w for w in sys.argv[4:] if w != "--exact"]
    if "--exact" in sys.argv:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sets = dict(w.split("=", 1) for w in words if "=" in w)
    overrides = {k: json.loads(v) for k, v in sets.items()}
    cell, fault, seconds = sys.argv[1], sys.argv[2], float(sys.argv[3])
    for s in (w for w in words if "=" not in w):
        t = time.perf_counter()
        out = run_with_fault(cell, fault, int(s), seconds,
                             overrides=overrides)
        print(json.dumps({"cell": cell, "fault": fault, "seed": int(s),
                          "overrides": overrides, "correct": out.correct,
                          "rates": out.rates,
                          "checks": {c.name: c.value for c in out.checks},
                          "notes": out.notes,
                          "seconds": time.perf_counter() - t}, default=str),
              flush=True)
