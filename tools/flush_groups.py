"""What a sketch-server flush costs by request group, on the card.

    PYTHONPATH=src python3 tools/flush_groups.py [--seed N] [--reps R]

Builds the ``comfs.ingest`` cell's system through the benchmark's own
harness (``sketchbench.harness.System``: the ``comfs-d2048-s4`` sketch, 4
shards, ``horizons`` [1, 8]) and prefills one window from ``--seed``.
Then, with no ingest between flushes (the planes stay cached, so a flush
is its query work alone), it times ``SketchServer.flush`` on the host
clock with the card synchronised before and after (median of ``--reps``):

  * one group alone: a flush of one request of each group key the cell's
    mix draws (kind, edge label or not, ``last``, direction);
  * mixed flushes: ``--requests`` requests drawn from the cell's mix, a
    fresh draw each flush, with the distinct group keys a flush holds.

It uses only ``SketchServer.submit``/``flush`` and the harness, so it runs
on an older tree too: unpack one under ``experiments/`` and run this file
with ``PYTHONPATH=<tree>/src`` (the first ``repro_torch`` on the path is
the one measured; the line names it). Prints one JSON line last. Needs
one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CELL = "comfs.ingest"


def _sync():
    torch.cuda.synchronize()


def _timed_flush(server, reqs) -> float:
    """Seconds of one flush of ``reqs`` (``(tenant, kind, args)``)."""
    handles = [server.submit(kind, **args) for _, kind, args in reqs]
    _sync()
    t = time.perf_counter()
    server.flush()
    _sync()
    dt = time.perf_counter() - t
    if any(h.answer is None for h in handles):
        raise AssertionError("a request was left unanswered")
    return dt


def _key(server, kind, args):
    from repro_torch.launch.serve_sketch import QueryRequest
    return server._group_key(QueryRequest(kind, args))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2147493301)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--requests", type=int, default=14,
                    help="requests a mixed flush (the cell's ~71 ms "
                         "period at 200/s)")
    ap.add_argument("--flushes", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.append(str(ROOT))
    import repro_torch
    from sketchbench import harness
    from sketchbench.catalog import Catalog
    from sketchbench.trace import Observer
    from sketchbench.traffic import queries as tq

    cat = Catalog(ROOT)
    cell = cat.workload(CELL)
    traffic = cell["traffic"]
    system = harness.System(cat.config(cell["config"]), traffic, args.seed,
                            "cuda")
    obs = Observer(False)
    harness.prefill(system, traffic, obs)
    server = system.server
    server.state  # drains the ingest pipeline
    _sync()
    mix = traffic["queries"]["mix"]
    rng = np.random.default_rng([args.seed, 9])

    def draw(n):
        return system.requests(mix, tq.draws(rng, n), [None] * n)

    pool = draw(4096)
    by_key = {}
    for r in pool:
        by_key.setdefault(_key(server, r[1], r[2]), []).append(r)
    for r in pool[:512]:  # warm every key's path
        _timed_flush(server, [r])
    alone = {}
    for key in sorted(by_key, key=str):
        reqs = by_key[key]
        ts = [_timed_flush(server, [reqs[i % len(reqs)]])
              for i in range(args.reps)]
        alone[str(key)] = 1e3 * statistics.median(ts)
    mixed, keys = [], []
    for _ in range(args.flushes):
        reqs = draw(args.requests)
        keys.append(len({_key(server, k, a) for _, k, a in reqs}))
        mixed.append(_timed_flush(server, reqs))
    q = statistics.quantiles([1e3 * t for t in mixed], n=4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    by_kind = {}
    for k, ms in alone.items():
        by_kind.setdefault(k.split("'")[1], []).append(ms)
    out = {"tree": str(Path(repro_torch.__file__).resolve().parents[2]),
           "card": smi, "seed": args.seed,
           "group_alone_ms": alone,
           "group_alone_ms_by_kind": {k: [min(v), statistics.median(v),
                                          max(v)]
                                      for k, v in by_kind.items()},
           "mixed_requests": args.requests,
           "mixed_keys_mean": float(np.mean(keys)),
           "mixed_flush_ms": [q[0], statistics.median(
               [1e3 * t for t in mixed]), q[2]]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
