"""A benchmark tree at a size the CPU runs in seconds: the real
``BENCHMARK.json`` with its cells swapped for two tiny ones (a single
sharded handle and a pool of 3 tenants), their configuration and traffic
files, and the real metric readers, written under a temporary
directory."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from sketchbench.catalog import HERE, ROOT, Catalog

SKETCH = {"d": 64, "n_blocks": 2, "F": 1024, "r": 8, "s": 8, "c": 4, "k": 4,
          "window_size": 40, "pool_capacity": 64, "pool_probes": 8,
          "seed": 1234}
STREAM = {"n_vertices": 300, "n_vertex_labels": 3, "n_edge_labels": 5,
          "zipf_a": 1.2, "duplicate_rate": 0.2}
MIX = {"edge": 0.6, "vertex": 0.3, "label": 0.1, "edge_label_share": 0.5,
       "random_pair_share": 0.2, "lasts": [None, 1, 4]}
CONFIGS = {
    "tiny": {"shards": 2, "tenants": 0, "sketch": SKETCH,
             "stream": dict(STREAM, edges_per_window=400, base_windows=2)},
    "tinypool": {"shards": 2, "tenants": 3, "tenant_offset_subwindows": 1,
                 "sketch": SKETCH,
                 "stream": dict(STREAM, edges_per_window=200,
                                base_windows=1)},
}
WORKLOADS = {
    "tiny.ingest": ("tiny", {
        "ingest": {"mode": "closed", "max_batch": 64},
        "queries": {"loop": "open", "rate_per_s": 100,
                    "server_max_batch": 4096, "mix": MIX},
        "horizons": [1, 4], "prefill_windows": 1, "prefill_batch": 64,
        "warm_requests": 32, "check_requests": 32}),
    "tiny.query": ("tinypool", {
        "ingest": {"mode": "periodic", "period_ms": 50, "max_batch": 16},
        "queries": {"loop": "closed", "clients": 48, "tenant_zipf": 1.0,
                    "server_max_batch": 8192, "mix": MIX},
        "horizons": [1, 4], "prefill_windows": 1, "prefill_batch": 64,
        "warm_requests": 48, "check_requests": 48}),
}
STANDS_FOR = {"comfs.ingest": "tiny.ingest", "tenants.query": "tiny.query"}


def make_tree(tmp: Path) -> Catalog:
    parts = tmp / "sketchbench"
    for sub in ("configs", "workloads"):
        (parts / sub).mkdir(parents=True)
    shutil.copytree(HERE / "metrics", parts / "metrics")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = []
    for name, cfg in CONFIGS.items():
        f = f"sketchbench/configs/{name}.json"
        (tmp / f).write_text(json.dumps(dict(cfg, name=name)))
        bench["configs"].append({"name": name, "source": "a test",
                                 "file": f, "reduced": [], "why": "a test"})
    bench["workloads"] = []
    for name, (cfg, traffic) in WORKLOADS.items():
        (parts / "workloads" / f"{name}.json").write_text(
            json.dumps(traffic))
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": name, "chips": 1,
                                   "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [STANDS_FOR[w] for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Catalog(tmp, parts)
