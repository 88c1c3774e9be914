"""The readers of the program's ranges and of the idle time they name,
each on a hand-built trace, and on none."""

import types

import pytest

from sketchbench.catalog import Catalog

RANGES = {
    "sketchbench.flush": [(0.0, 0.1), (1.0, 1.1)],
    "lsketch.server.flush": [(0.0, 0.09), (1.0, 1.09)],
    "lsketch.server.group": [(0.05, 0.06), (0.06, 0.07), (1.05, 1.06)],
    "lsketch.ingest.dispatch": [(0.0, 0.03), (1.0, 1.02)],
    "lsketch.ingest.partition": [(0.5, 0.507)],
    "lsketch.planes.fold": [(0.03, 0.035), (0.035, 0.038)],
    "lsketch.planes.build": [(1.02, 1.05)],
    "lsketch.window_plan": [(0.0, 0.001), (1.0, 1.002)],
    "lsketch.addressing": [(0.001, 0.011), (1.002, 1.01)],
    "lsketch.insert_kernel": [(0.011, 0.012)],
    "lsketch.planes_delta": [(0.012, 0.013)],
}
TRACE = dict(busy_s=0.5, window_s=2.5, host_ranges=RANGES,
             breakdown=dict(idle_gaps=[
                 ["lsketch.planes.fold", 0.8], ["lsketch.server.flush", 0.3],
                 ["sketchbench.ingest", 0.1], ["host", 0.1],
                 ["lsketch.addressing", 0.4]]))


@pytest.mark.parametrize("metric,want", [
    ("engine.dispatch_ms", 25.0),
    ("engine.stage_ms_per_flush", 11.5),  # (1 + 10 + 1 + 1 + 2 + 8) / 2
    ("partition.ms_per_batch", 7.0),
    ("planes.fold_ms", 4.0),
    ("planes.build_ms", 30.0),
    ("server.groups_per_flush", 1.5),
    ("device_idle.unattributed", 25.0),  # (0.3 + 0.1 + 0.1) / 2.0
])
def test_each_reader_on_a_hand_built_trace(metric, want):
    read = Catalog().reader(metric)
    assert read(types.SimpleNamespace(trace=TRACE)) == pytest.approx(want)
    assert read(types.SimpleNamespace(trace=None)) is None
    # a program that marks none of the ranges: nothing, and no error
    bare = dict(TRACE, host_ranges={}, busy_s=0.0)
    assert read(types.SimpleNamespace(trace=bare)) is None
