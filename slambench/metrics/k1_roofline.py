"""K1's share of its roofline (%): the bytes bound of the windows' SGM
aggregation (the (B, H, W, D) bf16 cost volume read once and the
aggregate written once, at the HBM bandwidth) over the device time of the
kernels named ``sgm_line_pair`` in the stretch."""

from slambench.core import roofline

NAME = "k1_roofline"


def read(trace, cell):
    t = trace.kernel_seconds("sgm_line_pair")
    windows = trace.counts.get("windows", 0)
    if t <= 0 or not windows:
        return None
    cfg, p = cell.config, cell.traffic
    n_bytes = windows * roofline.k1_bytes(
        p["window_pairs"], cfg["height"], cfg["width"],
        cfg["sgbm"]["num_disparities"])
    return 100.0 * roofline.bytes_bound_s(n_bytes) / t
