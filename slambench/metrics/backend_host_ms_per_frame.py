"""Host milliseconds a frame in the backend: the ``edges/*`` (PnP,
reverse PnP, VO re-measure, readback) and ``optimize/*`` stages."""

from slambench.core.readers import stage_ms_per_frame

NAME = "backend.host_ms_per_frame"


def read(trace, cell):
    return stage_ms_per_frame(
        trace, lambda s: s.startswith(("edges/", "optimize/")))
