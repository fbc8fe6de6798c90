"""Faults planted under each cell's timed path: the run goes on, and the
check comes out not correct, by the number that the fault moves past its
limit (rehearsed on the CPU at a small size)."""

import pytest
import torch

from slambench.tests import faults
from slambench.tests.faults import run_with_fault
from slambench.tests.rehearse import SMALL

CASES = [
    ("kitti_stereo.street_w32", "state_unchanged", "rpe_p90_pct"),
    ("kitti_stereo.street_w32", "half_batch", "rpe_p90_pct"),
    ("kitti_stereo.street_w32", "disparity_altered", "disp_bad_pct"),
    ("kitti_stereo.street_w32", "labels_altered", "label_wrong_pct"),
    ("kitti_stereo.street_w32", "map_altered", "map_median_off_m"),
    ("kitti_stereo.street_w32", "map_labels_dropped", "map_label_mix_pct"),
    ("kitti_stereo.street_w32", "map_stalled", "map_missing_pct"),
    ("segnet_camvid.train_b12", "state_unchanged", "change_norm_gap"),
    ("segnet_camvid.train_b12", "state_unchanged",
     "post_change_norm_median_gap"),
    ("segnet_camvid.train_b12", "half_batch", "grad_norm_median_gap"),
    ("segnet_camvid.train_b12", "loss_altered", "loss_gap"),
    ("segnet_camvid.label_b8", "state_unchanged", "label_wrong_pct"),
    ("segnet_camvid.label_b8", "half_batch", "label_wrong_pct"),
    ("segnet_camvid.label_b8", "labels_altered", "label_wrong_pct"),
]


@pytest.mark.parametrize("cell, fault, number", CASES)
def test_a_planted_fault_is_not_correct(cell, fault, number, monkeypatch):
    # the small drive holds a keyframe or two: the stalled map takes none
    monkeypatch.setattr(faults, "STALL_AFTER", 0)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        # the stereo rehearsal runs two windows at least: a state handed
        # back unchanged shows from the second on
        seconds = 8.0 if cell.startswith("kitti") else 1.0
        out = run_with_fault(cell, fault, 7, seconds, device="cpu",
                             overrides=SMALL[cell])
    finally:
        torch.set_num_threads(n)
    assert not out.correct
    check = {c.name: c for c in out.checks}[number]
    assert check.value > check.limit, (fault, check)
