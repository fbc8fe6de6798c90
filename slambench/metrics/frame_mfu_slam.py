"""The whole frame's share of the card's peak (%): the least time of the
stretch's counted work, the SGM aggregation's bytes of every frame and
SegNet's operations of every keyframe, over the stretch's wall time. The
work is counted from shapes, whatever kernels do it. It stands beside
``k1_roofline``, which moves the same metric: where a change takes K1 off
the path and its roofline falls silent, this share still bounds the gain.
KLT, RANSAC, ORB, PnP and the map are not counted yet, so it reads low."""

from slambench.core import roofline

NAME = "frame_mfu.slam"


def read(trace, cell):
    frames = trace.counts.get("frames", 0)
    if not frames or trace.window_s <= 0:
        return None
    cfg = cell.config
    least = (roofline.bytes_bound_s(frames * roofline.k1_bytes(
        1, cfg["height"], cfg["width"], cfg["sgbm"]["num_disparities"]))
        + roofline.flops_bound_s(trace.counts.get("keyframes", 0)
                                 * roofline.segnet_forward_flops(
                                     cfg["segnet_height"],
                                     cfg["segnet_width"])))
    return 100.0 * least / trace.window_s
