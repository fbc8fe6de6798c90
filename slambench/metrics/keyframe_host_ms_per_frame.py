"""Host milliseconds a frame in the keyframe epoch: the pipeline's
top-level ``kf/*`` stages (features, BoW, SegNet, store, harvest, edges,
loops, optimise, map), as its stage timer reads them."""

from slambench.core.readers import stage_ms_per_frame

NAME = "keyframe.host_ms_per_frame"


def read(trace, cell):
    return stage_ms_per_frame(trace, lambda s: s.startswith("kf/"))
