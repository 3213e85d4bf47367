"""The reader of `frontend.graph_replay_pct` on recorded timer tables."""

import pytest

from portbench import run


def _read(timers):
    r = run.Readings()
    r.timers = timers
    return run.load_reader("metrics", "frontend.graph_replay_pct").read(r)


@pytest.mark.parametrize("timers,expected", [
    ({"frontend/dispatch": (200, 4.0), "frontend/replay": (200, 0.2)}, 100.0),
    ({"frontend/dispatch": (200, 4.0), "frontend/replay": (150, 0.2)}, 75.0),
    # a program that runs every pass eagerly, or has no graph at all
    ({"frontend/dispatch": (200, 4.0), "frontend/detect": (200, 3.0)}, None),
    ({}, None),
])
def test_replay_share(timers, expected):
    assert _read(timers) == expected
