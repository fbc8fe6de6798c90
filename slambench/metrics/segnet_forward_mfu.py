"""The forward pass's share of the bf16 peak (%): its counted operations
a labelled image, over the stretch's wall time."""

from slambench.core import roofline

NAME = "segnet_forward.mfu"


def read(trace, cell):
    images = trace.counts.get("images", 0)
    if not images or trace.window_s <= 0:
        return None
    p = cell.traffic
    flops = images * roofline.segnet_forward_flops(p["height"], p["width"])
    return 100.0 * roofline.flops_bound_s(flops) / trace.window_s
