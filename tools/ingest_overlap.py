"""Whether ``AsyncIngestor`` overlaps the host partition with the dispatch,
on the card.

    python3 tools/ingest_overlap.py

Feeds phase S's batches of ``chip_smoke.py`` (the deployment's config at
4 shards, COMFS at 500,000 edges, batches of <= 16,384 cut at subwindow
boundaries) into fresh handles on one card, in rotation, ``ROUNDS`` times
each way after one warm-up pass (pure ingest, no queries; every final
state equal to the warm-up's, leaf for leaf):

  * ``sync``: ``sketch.ingest`` batch by batch;
  * ``async``: ``sketch.AsyncIngestor``, the reference's one-thread
    stagger (dispatch batch N, then partition batch N+1 while the card
    finishes what the dispatch enqueued last);
  * ``thread``: the partition of batch N+1 on a worker thread while the
    calling thread dispatches batch N (the shape ``AsyncIngestor`` did not
    take);
  * ``thread-si``: the same with the interpreter's switch interval at
    0.5 ms instead of 5 ms during the pass (how long a thread that wants
    the interpreter lock waits for the other to hand it over).

It also times the partition alone (``_stage``) per batch. Prints edges/s
per pass and one JSON line last. Needs one card and nvcc.
"""
from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("ingest_overlap: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import dataclasses

    import chip_smoke as cs
    from repro_torch import sketch as skt
    from repro_torch.data.stream import generate
    from repro_torch.kernels import build
    from repro_torch.sketch.ingest import _dispatch_stacked, _stage

    build.build()
    build.load_library()
    card = cs.card_line()
    spec = skt.make_spec("lsketch", n_shards=cs.N_SHARDS, config=cs.CFG)
    stream = generate(dataclasses.replace(cs.COMFS,
                                          n_edges=cs.STREAM_EDGES),
                      seed=cs.SEED, weighted=True)
    batches, _ = cs.stream_batches(cs.CFG, stream)
    n = len(stream)

    def sync(st):
        for b in batches:
            st = skt.ingest(spec, st, b, path="cuda")
        return st

    def pipelined(st):
        ing = skt.AsyncIngestor(spec, st, path="cuda")
        for b in batches:
            ing.submit(b)
        return ing.flush()

    def threaded(st):
        with ThreadPoolExecutor(max_workers=1) as pool:
            staged = None
            for b in batches + [None]:
                nxt = None if b is None else pool.submit(_stage, spec, b)
                if staged is not None:
                    st = _dispatch_stacked(spec, st, *staged.result(),
                                           "cuda")
                staged = nxt
        return st

    def switch_interval(st):
        old = sys.getswitchinterval()
        sys.setswitchinterval(5e-4)
        try:
            return threaded(st)
        finally:
            sys.setswitchinterval(old)

    ways = {"sync": sync, "async": pipelined, "thread": threaded,
            "thread-si": switch_interval}
    rates = {w: [] for w in ways}
    # a warm-up pass (the first flushes of a process load the kernels and
    # fill the allocator), whose state every timed pass must equal
    ref = sync(skt.create(spec, device="cuda")).live().leaves()
    for r in range(ROUNDS):
        for way, fn in (ways.items() if r % 2 == 0 else
                        reversed(list(ways.items()))):
            st = skt.create(spec, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = fn(st)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rates[way].append(n / sec)
            if not all(torch.equal(x, y)
                       for x, y in zip(ref, st.live().leaves())):
                raise AssertionError(f"{way} pass {r}: the state differs")
            print(f"{way} pass {r}: {n / sec:.0f} edges/s "
                  f"({1e3 * sec:.1f} ms, {len(batches)} batches) [{card}]",
                  flush=True)
            del st
            torch.cuda.empty_cache()
    part = []
    for b in batches:
        t0 = time.perf_counter()
        _stage(spec, b)
        part.append(time.perf_counter() - t0)
    out = dict(card=card, batches=len(batches), edges=n,
               partition_ms_per_batch=1e3 * float(np.median(part)),
               **{f"{w}_edges_per_s": v for w, v in rates.items()})
    print(f"partition alone: median {out['partition_ms_per_batch']:.3f} ms "
          f"a batch; medians of edges/s: " + ", ".join(
              f"{w} {np.median(v):.0f}" for w, v in rates.items()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
