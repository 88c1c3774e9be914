"""The benchmark's files: ``BENCHMARK.json`` within the contract's
shapes, every configuration, traffic file and metric reader found by the
name ``BENCHMARK.json`` gives it, and a cell, a configuration and a
metric added from a temporary directory with new files only."""

import ast
import json
import re
import shutil

import pytest

from sketchbench.catalog import HERE, ROOT, Catalog
from sketchbench.traffic import stream as ts

from . import tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["sketchbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    texts = [e[f] for k in ("configs", "workloads") for e in BENCH[k]
             for f in ("why", "source") if f in e]
    texts += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_by_name(cell):
    cat = Catalog()
    w = cat.workload(cell)
    cfg = cat.config(w["config"])
    assert cfg["name"] == w["config"] and w["traffic"]["name"] == cell
    assert w["chips"] == 1 and len(w["why"]) <= 200
    p = ts.StreamParams.from_config(cfg)
    assert p.subwindow * int(cfg["sketch"]["k"]) == p.window_size
    e2e = [m["name"] for m in cat.metrics(cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = cat.metrics(cell, True)
    assert per_layer
    for m in per_layer:
        assert callable(cat.reader(m["name"]))


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_each_config_file_states_its_cuts(cfg):
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    body = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("sketchbench/")
    assert body["source"] == entry["source"]
    assert body["reduced"] == entry["reduced"]
    for k in entry["reduced"]:
        assert k in body["source_values"]
    assert body["assumed"] and body["guarantees"]


def test_a_cell_config_and_metric_are_added_as_files_only(tmp_path):
    cat = tiny.make_tree(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "sketchbench").rglob(
        "*") if p.is_file()}
    # a new configuration and cell: two files and two entries
    cfg = dict(tiny.CONFIGS["tiny"], name="tiny-s4", shards=4)
    (tmp_path / "sketchbench/configs/tiny-s4.json").write_text(
        json.dumps(cfg))
    (tmp_path / "sketchbench/workloads/tiny.s4.json").write_text(
        json.dumps(tiny.WORKLOADS["tiny.ingest"][1]))
    bench["configs"].append({"name": "tiny-s4", "source": "a test",
                             "file": "sketchbench/configs/tiny-s4.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.s4", "config": "tiny-s4",
                               "traffic": "tiny.s4", "chips": 1,
                               "why": "a test"})
    # a new per-layer metric: a reader file and an entry
    (tmp_path / "sketchbench/metrics/server.flushes.py").write_text(
        "def read(obs):\n    return len(obs.spans.get('flush', ()))\n")
    bench["per_layer"].append({"name": "server.flushes", "unit": "flushes",
                               "better": "lower", "source": "host_clock",
                               "layer": "server", "moves": "query_p95_ms",
                               "workloads": ["tiny.s4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cat = Catalog(tmp_path, tmp_path / "sketchbench")
    assert cat.config(cat.workload("tiny.s4")["config"])["shards"] == 4
    names = [m["name"] for m in cat.metrics("tiny.s4", True)]
    assert "server.flushes" in names
    assert cat.reader("server.flushes")(
        type("O", (), {"spans": {"flush": [1, 2]}})) == 2
    for p, b in before.items():
        assert p.read_bytes() == b  # nothing edited


def _code_strings(path) -> list:
    """The string constants of a module's code (its docstrings left out)."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_the_harness_lists_no_cell_config_or_metric():
    strings = [s for p in list(HERE.glob("*.py")) + list(
        HERE.glob("*/*.py")) if "tests" not in p.parts
        for s in _code_strings(p)]
    for e in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        assert not any(e["name"] in s for s in strings), e["name"]


def test_the_checkout_keeps_the_repository_files_out(tmp_path):
    shutil.copytree(HERE, tmp_path / "sketchbench")
    assert not (tmp_path / "src").exists()
