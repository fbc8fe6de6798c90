"""Each driver rehearsed on the CPU at a small size, through the same code
as a run on the card (``rehearse.py``; ``run.py`` offers no such entry)."""

import math

import pytest
import torch

from slambench.core.result import Outcome
from slambench.tests.rehearse import SMALL, context, rehearse
from slambench.core import registry


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_rehearsal_runs_and_compares(cell):
    out = rehearse(cell, seconds=1.0)
    assert isinstance(out, Outcome)
    assert out.attempted > 0 and out.failed == 0
    assert all(math.isfinite(v) and v > 0 for v in out.rates.values())
    assert out.setup_s > 0
    names = set(context(cell).cell.traffic["limits"])
    assert {c.name for c in out.checks} == names
    assert all(math.isfinite(c.value) for c in out.checks)


def test_a_traced_rehearsal_reads_its_stretch():
    out = rehearse("segnet_camvid.label_b8", seconds=1.0, trace=True)
    t = out.trace
    assert t.window_s > 0 and t.counts["images"] == 2 * 2
    readers = registry.load_metric_readers()
    cell = context("segnet_camvid.label_b8").cell
    # no device in a CPU rehearsal: the device readers find nothing
    assert readers["idle_share.label"](t, cell) is None
    assert readers["segnet_forward.mfu"](t, cell) > 0
