"""Where the benchmark finds its parts, by name: ``BENCHMARK.json`` at the
root of the checkout, one file a configuration
(``sketchbench/configs/<name>.json``), one a traffic mix
(``sketchbench/workloads/<name>.json``) and one reader a per-layer metric
(``sketchbench/metrics/<name>.py``). Nothing here lists them: a new cell,
configuration or metric is a new file and a new entry in
``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Catalog:
    """The benchmark's entries and the files they name, read from the
    directory ``root`` (the checkout) and ``parts`` (the harness's own
    folder, where ``configs/``, ``workloads/`` and ``metrics/`` live)."""

    def __init__(self, root: Path = ROOT, parts: Path = HERE):
        self.root, self.parts = Path(root), Path(parts)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.bench[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        """The cell's entry with its traffic file's contents under
        ``traffic``."""
        entry = dict(self._entry("workloads", name))
        entry["traffic"] = json.loads(
            (self.parts / "workloads" / f"{name}.json").read_text())
        return entry

    def config(self, name: str) -> dict:
        """The configuration's file (the one its entry names)."""
        entry = self._entry("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a cell reports: its end-to-end metrics with
        ``trace`` off, its per-layer ones with it on. An entry without a
        ``workloads`` key applies to every cell that reports the
        end-to-end metric it moves."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell])
                and m["moves"] in names]

    def reader(self, metric: str):
        """The per-layer metric's reader: ``read(obs)`` of its file."""
        path = self.parts / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "sketchbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
