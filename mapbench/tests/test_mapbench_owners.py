"""`host.filter1_host_owner_pct` on two hand-built snapshots of the
untraced window: the share of filter 1's owners in it that the host
handled, and nothing where neither counter moved."""
import pytest

from mapbench.metrics import load

READ = load("host.filter1_host_owner_pct").read


def _ctx(before, after):
    return {"open": {"counts": before}, "close": {"counts": after}}


@pytest.mark.parametrize("before, after, want", [
    ({"filter1 device owners": 1000, "filter1 host owners": 10},
     {"filter1 device owners": 4600, "filter1 host owners": 410}, 10.0),
    ({"filter1 device owners": 500},
     {"filter1 device owners": 8692}, 0.0),
    ({}, {"filter1 host owners": 65536}, 100.0),
])
def test_share_of_the_window(before, after, want):
    assert READ(_ctx(before, after)) == pytest.approx(want)


@pytest.mark.parametrize("before, after", [
    ({}, {}),
    ({"filter1 device owners": 7, "filter1 host owners": 3},
     {"filter1 device owners": 7, "filter1 host owners": 3}),
])
def test_nothing_where_no_owner_moved(before, after):
    assert READ(_ctx(before, after)) is None


def test_snapshot_without_counts():
    assert READ({"open": {}, "close": {}}) is None
