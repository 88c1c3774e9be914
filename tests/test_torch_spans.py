"""The program's profiler ranges (``repro_torch.telemetry.spans``): none
is opened while no profiler runs, and under a profiler a tiny CPU sketch
server's two ingests and one flush mark every stage, nested as the
served path calls them, with the same answers as without one."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import sketch as tskt
from repro_torch.core.types import EdgeBatch, LSketchConfig
from repro_torch.launch.serve_sketch import SketchServer
from repro_torch.telemetry import spans

CFG = LSketchConfig(d=64, n_blocks=2, F=512, r=4, s=4, c=4, k=8,
                    window_size=800, pool_capacity=256, pool_probes=8)
SPANS = ("lsketch.server.ingest", "lsketch.server.flush",
         "lsketch.server.prewarm", "lsketch.server.group",
         "lsketch.server.readback", "lsketch.query.prepare",
         "lsketch.query.answer", "lsketch.planes.resolve",
         "lsketch.planes.fold", "lsketch.planes.build",
         "lsketch.ingest.partition", "lsketch.ingest.dispatch")


def _batch(rng, n, t0, t1):
    src, dst = rng.integers(0, 40, n), rng.integers(0, 40, n)
    return EdgeBatch(*[np.asarray(x, np.int32) for x in (
        src, dst, src % 3, dst % 3, rng.integers(0, 4, n),
        np.ones(n), np.sort(rng.integers(t0, t1, n)))])


def _requests():
    """Edge, vertex and label requests over nine group keys."""
    reqs = [("edge", dict(src=i, la=i % 3, dst=i + 1, lb=(i + 1) % 3,
                          le=i % 4 if i % 2 else None,
                          last=(None, 1, 8)[i % 3])) for i in range(6)]
    reqs += [("vertex", dict(v=1, lv=1, le=None, last=8, direction=d))
             for d in ("out", "in")]
    return reqs + [("label", dict(lv=1, le=2, last=None))]


def _serve():
    """Two ingests (one subwindow, so the flush folds) and one flush of
    every request: the answers and the distinct group keys."""
    rng = np.random.default_rng(3)
    server = SketchServer(tskt.SketchSpec(kind="lsketch", config=CFG,
                                          n_shards=2),
                          query_path="cuda", horizons=[1, 8], device="cpu")
    server.ingest(_batch(rng, 48, 0, 50))
    server.ingest(_batch(rng, 48, 50, 100))
    handles = [server.submit(kind, **args) for kind, args in _requests()]
    keys = {server._group_key(h) for h in handles}
    server.flush()
    return [h.answer for h in handles], keys


@pytest.fixture(scope="module")
def plain():
    """The served run with no profiler: the ranges it opened, its
    answers."""
    opened = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans, "record_function",
                   lambda name: opened.append(name))
        answers, _ = _serve()
    return opened, answers


@pytest.fixture(scope="module")
def traced():
    """The served run under a CPU profiler: its ``lsketch.*`` host ranges
    by name as ``(start, end)`` pairs, its answers and group keys."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        answers, keys = _serve()
    ranges = {}
    for e in prof.profiler.kineto_results.events():  # unbuilt: fast
        if e.name().startswith("lsketch."):
            ranges.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    return ranges, answers, keys


def test_no_range_is_opened_without_a_profiler(plain):
    with spans.span("lsketch.server.flush") as got:
        assert got is None
    assert spans.span("a") is spans.span("b")  # one shared no-op
    assert plain[0] == []


@pytest.mark.parametrize("name", SPANS)
def test_every_stage_is_marked(traced, name):
    assert traced[0].get(name)


@pytest.mark.parametrize("child,parent,every", [
    ("lsketch.ingest.dispatch", "lsketch.server.flush", False),  # drain
    ("lsketch.window_plan", "lsketch.ingest.dispatch", True),
    ("lsketch.addressing", "lsketch.ingest.dispatch", True),
    ("lsketch.ingest.partition", "lsketch.server.ingest", True),
    ("lsketch.planes.resolve", "lsketch.server.prewarm", False),
    ("lsketch.planes.fold", "lsketch.server.prewarm", False),
    ("lsketch.planes.build", "lsketch.server.prewarm", False),
    ("lsketch.server.prewarm", "lsketch.server.flush", False),
    ("lsketch.server.group", "lsketch.server.flush", True),
    ("lsketch.server.readback", "lsketch.server.flush", True),
    ("lsketch.query.prepare", "lsketch.server.group", True),
    ("lsketch.query.answer", "lsketch.server.group", True),
])
def test_ranges_nest_as_the_stages_call(traced, child, parent, every):
    outer = traced[0][parent]
    inside = [any(a <= c and d <= b for a, b in outer)
              for c, d in traced[0][child]]
    assert (all if every else any)(inside)


def test_one_group_range_a_group_key_and_the_same_answers(traced, plain):
    """A single handle's flush of nine group keys over three kinds: one
    ``server.group`` range a kind present (one pass each), one readback
    a flush, no range of one inside another of its name, and the answers
    of the run with no profiler."""
    ranges, answers, keys = traced
    assert len(keys) == 9
    assert len(ranges["lsketch.server.group"]) == \
        len({k[0] for k in keys}) == 3
    assert len(ranges["lsketch.server.flush"]) == 1
    assert len(ranges["lsketch.server.readback"]) == 1
    for name in ("lsketch.server.group", "lsketch.query.prepare",
                 "lsketch.query.answer"):
        got = sorted(ranges[name])
        assert all(b <= c for (_, b), (c, _) in zip(got, got[1:]))
    assert len(ranges["lsketch.query.answer"]) == 3
    assert answers == plain[1]
    assert all(isinstance(a, int) for a in answers)
