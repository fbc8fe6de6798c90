"""The controls on the card at the cells' own sizes: the reference in the
precision below the configuration's, put in the program's place, has to
come out not correct on every seed."""

import pytest

from slambench.core import registry
from slambench.tests.controls import readings

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    limits = registry.resolve(cell, registry.load_benchmark()) \
        .traffic["limits"]
    for seed in (3100000011, 3100000012, 3100000013):
        got = readings(cell, seed)
        assert any(got[k] > limits[k] for k in got), (cell, seed, got)
