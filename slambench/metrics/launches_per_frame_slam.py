"""Kernel launches that ran on the device in the stretch, a frame."""

NAME = "launches_per_frame.slam"


def read(trace, cell):
    frames = trace.counts.get("frames", 0)
    return trace.n_kernels / frames if frames else None
