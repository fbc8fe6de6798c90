"""Host milliseconds a frame in the batched frontend: the pipeline's
``window`` stage (``track_frames_batched``), as its stage timer reads it."""

from slambench.core.readers import stage_ms_per_frame

NAME = "frontend.host_ms_per_frame"


def read(trace, cell):
    return stage_ms_per_frame(trace, lambda s: s == "window")
