"""The yardstick's arithmetic: operation and byte counts, the union of
device intervals, and the per-layer readers."""

import pytest

from slambench.core import registry, roofline
from slambench.core.readers import STAGE, idle_share, stage_ms_per_frame
from slambench.core.trace import TraceData, union_length
from slambench.reference.segnet import plan


def test_k1_bytes_at_kitti_size():
    assert roofline.k1_bytes(1, 376, 1241, 80) == 149_317_120
    assert roofline.k1_bytes(32, 376, 1241, 80) == 32 * 149_317_120


def test_segnet_flops_at_camvid_size():
    assert roofline.segnet_forward_flops(384, 480) == 241_002_086_400
    assert roofline.segnet_train_flops(384, 480) == 3 * 241_002_086_400
    # the count follows the layer plan the reference runs
    sizes, h = [], 384
    for n, _ in ((2, 0), (2, 0), (3, 0), (3, 0), (3, 0)):
        sizes += [h] * n
        h //= 2
    for n, _ in ((3, 0), (3, 0), (3, 0), (2, 0), (2, 0)):
        h *= 2
        sizes += [h] * n
    sizes.append(384)
    total = sum(2 * s * (s * 480 // 384) * ci * co * 9
                for s, (ci, co) in zip(sizes, plan()))
    assert total == roofline.segnet_forward_flops(384, 480)


@pytest.mark.parametrize("intervals, busy, gaps", [
    ([(0, 10), (5, 15), (20, 30)], 25, [(15, 20), (30, 40)]),
    ([(2, 8), (3, 4), (7, 9)], 7, [(0, 2), (9, 40)]),
    ([(-5, 50)], 40, []),
    ([], 0, [(0, 40)]),
])
def test_union_counts_overlapping_work_once(intervals, busy, gaps):
    assert union_length(intervals, 0, 40) == (busy, gaps)


def _trace(**counts):
    return TraceData(window_s=2.0, busy_s=0.5, n_kernels=100,
                     kernel_s={"void sgm_line_pair<bf16>": 0.1,
                               "other": 0.4}, counts=counts)


def test_readers():
    t = _trace(frames=10, windows=2, keyframes=1, images=12,
               **{STAGE + "window": 0.5, STAGE + "kf/orb": 0.2,
                  STAGE + "kf/map": 0.1, STAGE + "edges/pnp": 0.05,
                  STAGE + "optimize/global": 0.05, STAGE + "frontend": 9.0})
    assert idle_share(t) == pytest.approx(75.0)
    assert stage_ms_per_frame(t, lambda s: s == "window") == pytest.approx(50)
    readers = registry.load_metric_readers()
    bench = registry.load_benchmark()
    street = registry.resolve("kitti_stereo.street_w32", bench)
    assert readers["keyframe.host_ms_per_frame"](t, street) == \
        pytest.approx(30.0)
    assert readers["backend.host_ms_per_frame"](t, street) == \
        pytest.approx(10.0)
    assert readers["launches_per_frame.slam"](t, street) == 10.0
    k1 = readers["k1_roofline"](t, street)
    assert k1 == pytest.approx(100 * 2 * 32 * 149_317_120 / 3.35e12 / 0.1)
    mfu = readers["frame_mfu.slam"](t, street)
    assert mfu == pytest.approx(100 * (10 * 149_317_120 / 3.35e12
                                       + 241_002_086_400 / 989e12) / 2.0)
    train = registry.resolve("segnet_camvid.train_b12", bench)
    assert readers["train_step.mfu"](t, train) == pytest.approx(
        100 * 12 * 3 * 241_002_086_400 / 989e12 / 2.0)
    # nothing to read: nothing reported, never a zero share
    empty = TraceData(window_s=2.0, busy_s=0.0, n_kernels=0, kernel_s={})
    assert readers["k1_roofline"](empty, street) is None
    assert readers["train_step.mfu"](empty, train) is None
    assert readers["idle_share.slam"](empty, street) is None
