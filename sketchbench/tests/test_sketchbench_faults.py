"""The check on whole runs at a tiny size on the CPU (the harness's look
for a card skipped): a sound run is correct; the control (answers read
from before the round's batches, the stale read the server's guarantee
rules out) and each fault the cells can have, planted in the program,
come out not correct: a step that leaves the state unchanged, half of
each batch left out, an answer altered where it is produced."""

import pytest
import torch

from repro_torch.launch.serve_sketch import SketchServer
from sketchbench import harness

from . import tiny


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tiny.make_tree(tmp_path_factory.mktemp("bench"))
    torch.set_num_threads(n)


def run(cat, cell, **kw):
    return harness.run_cell(cat, cell, 3_000_000_019, 1.0, False, "cpu",
                            **kw)


@pytest.mark.parametrize("cell", ["tiny.ingest", "tiny.query"])
def test_a_sound_run_is_correct(cat, cell):
    out = run(cat, cell)
    assert out["correct"], str(out["checks"])
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["rounds_built"]["value"] >= 1


@pytest.mark.parametrize("cell", ["tiny.ingest", "tiny.query"])
def test_the_control_is_not_correct(cat, cell):
    out = run(cat, cell, control="stale")
    assert not out["correct"]
    assert out["checks"]["round_answer_mismatch"]["value"] > 0


def _half(batch):
    return batch.slice(0, len(batch) // 2)


FAULTS = {
    "state_unchanged": ("ingest", lambda inner: lambda self, b, **k: None),
    "half_batch": ("ingest", lambda inner: lambda self, b, **k:
                   inner(self, _half(b), **k)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_write_path_is_not_correct(cat, monkeypatch, fault):
    name, make = FAULTS[fault]
    monkeypatch.setattr(SketchServer, name, make(getattr(SketchServer,
                                                         name)))
    many = SketchServer.ingest_many
    if fault == "state_unchanged":
        monkeypatch.setattr(SketchServer, "ingest_many",
                            lambda self, pairs: None)
    else:
        monkeypatch.setattr(SketchServer, "ingest_many", lambda self, pairs:
                            many(self, [(t, _half(b)) for t, b in pairs]))
    for cell in ("tiny.ingest", "tiny.query"):
        out = run(cat, cell)
        assert not out["correct"], (cell, out["checks"])
        assert out["checks"]["round_state_mismatch"]["value"] > 0


def test_an_altered_answer_is_not_correct(cat, monkeypatch):
    flush = SketchServer.flush

    def altered(self):
        pending = list(self.pending)
        n = flush(self)
        if pending:
            pending[-1].answer += 1
        return n

    monkeypatch.setattr(SketchServer, "flush", altered)
    for cell in ("tiny.ingest", "tiny.query"):
        out = run(cat, cell)
        assert not out["correct"]
        assert out["checks"]["round_answer_mismatch"]["value"] > 0


def test_a_fault_inside_the_window_alone_is_seen_by_the_span(cat,
                                                              monkeypatch):
    """Half of each batch left out while the window runs, and no fault
    after it: the rounds after the window start from the program's own
    state and read 0, so the span, which the reference follows from the
    state where it begins, is what fails the run."""
    on = {"fault": False}
    ingest, many = SketchServer.ingest, SketchServer.ingest_many
    monkeypatch.setattr(SketchServer, "ingest", lambda self, b, **k: ingest(
        self, _half(b) if on["fault"] else b, **k))
    monkeypatch.setattr(SketchServer, "ingest_many", lambda self, pairs: many(
        self, [(t, _half(b) if on["fault"] else b) for t, b in pairs]))
    window = harness.window

    def faulty_window(*a, **k):
        on["fault"] = True
        try:
            return window(*a, **k)
        finally:
            on["fault"] = False

    monkeypatch.setattr(harness, "window", faulty_window)
    for cell in ("tiny.ingest", "tiny.query"):
        out = run(cat, cell)
        assert not out["correct"], (cell, out["checks"])
        assert out["checks"]["span_state_mismatch"]["value"] > 0
        assert out["checks"]["round_state_mismatch"]["value"] == 0
