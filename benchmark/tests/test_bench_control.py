"""The control on the card: the plain reference put in the program's
place and computed in TF32 must come out not correct in each cell, at a
size a test run holds (fewer channels, one seed); and the program's own
readings at that size stay inside every limit. The full-size readings
are benchmark/readings.py's. Marked `cuda`: skips without a card.

    python -m pytest --noconftest -m cuda benchmark/tests -q
"""

import pytest

import registry
from readings import readings

pytestmark = pytest.mark.cuda

SMALL = {
    "baseband64.busy": {"config": {"channels": 16}, "traffic": {}},
    "wideband1500.subband": {"config": {}, "traffic": {}},
}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_and_program_passes(cuda, cell):
    limits = registry.cell(registry.benchmark(), cell)[1]["limits"]
    got = {r["kind"]: r["numbers"] for r in readings(
        cell, [2**31 + 21], [2**31 + 21], windows=2,
        overrides=SMALL[cell], log=lambda m: None)}
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(got["control"][k] > v for k, v in limits.items())
