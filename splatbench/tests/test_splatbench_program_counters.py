"""The readers of the program's binning and SH counters
(metrics/sh.unhit_share.py, metrics/bin.candidates_per_view.py): their
numbers from the counters at reading time, and None where the program
keeps no such counters (a program that lacks them)."""
import pytest

from splatbench import harness


@pytest.fixture
def counters(monkeypatch):
    from opensplat_tpu_torch.utils import metrics
    held = {}
    monkeypatch.setattr(metrics, "counts", lambda: dict(held))
    return held


@pytest.mark.parametrize("name, given, want", [
    ("sh.unhit_share", {"bin.rows": 200, "bin.rows_hit": 150}, 25.0),
    ("sh.unhit_share", {"bin.rows": 200, "bin.rows_hit": 0}, 100.0),
    ("sh.unhit_share", {"bin.rows": 200}, None),
    ("sh.unhit_share", {"bin.rows_hit": 150}, None),
    ("bin.candidates_per_view", {"bin.views": 4, "bin.candidates": 10}, 2.5),
    ("bin.candidates_per_view", {"bin.views": 4}, None),
    ("bin.candidates_per_view", {}, None),
])
def test_reader(counters, name, given, want):
    counters.update(given)
    got = harness.load_reader(name)(None)
    assert got == (None if want is None else pytest.approx(want))
