"""Heterogeneous graph-stream generators and exact ground truth (port of
``repro.data.stream``: ``StreamSpec``, ``SPECS``, ``GraphStream``,
``generate``, ``GroundTruth``, ``edge_batches``). Pure numpy and seeded:
the same spec and seed give the reference's stream bit for bit.

``GroundTruth`` replays a stream exactly (dict of dicts) under the
sketch's window semantics, so an estimate can be held to the true answer
as the paper does.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.types import EdgeBatch


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    name: str
    n_edges: int
    n_vertices: int
    n_vertex_labels: int
    n_edge_labels: int
    window_size: int  # time units
    subwindow_size: int
    zipf_a: float = 1.2  # degree skew
    duplicate_rate: float = 0.3  # chance an item repeats an earlier edge
    label_skew: Optional[Tuple[float, ...]] = None  # vertex-label mixture


# Scaled-down analogs of the paper's Table 2 (same label cardinalities and
# window ratios as the reference package)
PHONE = StreamSpec("phone", 60_765, 94 * 20, 2, 9, 7 * 24 * 60, 60,
                   zipf_a=1.4, duplicate_rate=0.5)
ROAD = StreamSpec("road", 120_000, 4_000, 1, 6, 24 * 60, 5,
                  zipf_a=1.05, duplicate_rate=0.8)
ENRON = StreamSpec("enron", 150_000, 20_000, 11, 4096, 7 * 24 * 60, 60,
                   zipf_a=1.3, duplicate_rate=0.4)
COMFS = StreamSpec("comfs", 500_000, 100_000, 20, 100, 24 * 60, 10,
                   zipf_a=1.2, duplicate_rate=0.2)

SPECS = {s.name: s for s in (PHONE, ROAD, ENRON, COMFS)}

_FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label",
           "weight", "time")


@dataclasses.dataclass
class GraphStream:
    """A generated stream: its spec and seven host int32 columns, the
    fields of an ``EdgeBatch`` (every ingest entry takes either)."""

    spec: StreamSpec
    src: np.ndarray
    dst: np.ndarray
    src_label: np.ndarray
    dst_label: np.ndarray
    edge_label: np.ndarray
    weight: np.ndarray
    time: np.ndarray

    def __len__(self):
        return len(self.src)

    def slice(self, a, b) -> "GraphStream":
        return GraphStream(self.spec, self.src[a:b], self.dst[a:b],
                           self.src_label[a:b], self.dst_label[a:b],
                           self.edge_label[a:b], self.weight[a:b],
                           self.time[a:b])


def _zipf_nodes(rng, n_vertices, n, a):
    z = rng.zipf(a, n)
    return ((z - 1) % n_vertices).astype(np.int32)


def generate(spec: StreamSpec, seed: int = 0,
             weighted: bool = False) -> "GraphStream":
    """A time-ordered stream of ``spec.n_edges`` items: a ``GraphStream``
    of host int32 arrays."""
    rng = np.random.default_rng(seed)
    n = spec.n_edges
    src = _zipf_nodes(rng, spec.n_vertices, n, spec.zipf_a)
    dst = _zipf_nodes(rng, spec.n_vertices, n, spec.zipf_a)
    dup = rng.random(n) < spec.duplicate_rate
    back = np.maximum(0, np.arange(n) - rng.integers(1, 500, n))
    src = np.where(dup, src[back], src)
    dst = np.where(dup, dst[back], dst)
    if spec.label_skew is not None:
        probs = np.asarray(spec.label_skew) / np.sum(spec.label_skew)
        vlab = rng.choice(len(probs), size=spec.n_vertices, p=probs)
    else:
        vlab = rng.integers(0, spec.n_vertex_labels, spec.n_vertices)
    vlab = vlab.astype(np.int32)
    edge_label = rng.integers(0, spec.n_edge_labels, n).astype(np.int32)
    weight = (rng.integers(1, 5, n) if weighted else np.ones(n)).astype(
        np.int32)
    tmax = 2 * spec.window_size  # roughly uniform rate over 2 windows
    time = np.sort(rng.integers(0, tmax, n)).astype(np.int32)
    return GraphStream(spec, src, dst, vlab[src], vlab[dst], edge_label,
                       weight, time)


class GroundTruth:
    """Exact replay of a stream with the same sliding-window semantics.

    ``no_window=True`` gives the paper's "ignoring timestamps" mode (every
    item counts forever) used by the Fig. 14/15 benchmarks."""

    def __init__(self, spec: StreamSpec, k: int, no_window: bool = False):
        self.spec = spec
        self.k = k
        self.no_window = no_window
        self.ws = max(1, spec.window_size // k)
        # edges[(a,b)][le][widx] = weight
        self.edges: Dict[Tuple[int, int], Dict[int, Dict[int, int]]] = \
            defaultdict(lambda: defaultdict(lambda: defaultdict(int)))
        self.out_adj = defaultdict(set)
        self.cur_widx = -1 << 30

    def insert_stream(self, st: GraphStream):
        for i in range(len(st)):
            w_idx = int(st.time[i]) // self.ws
            self.cur_widx = max(self.cur_widx, w_idx)
            key = (int(st.src[i]), int(st.dst[i]))
            self.edges[key][int(st.edge_label[i])][w_idx] += int(st.weight[i])
            self.out_adj[key[0]].add(key[1])
        return self

    def _valid(self, widx, last=None) -> bool:
        if self.no_window and last is None:
            return True
        horizon = self.k if last is None else min(last, self.k)
        return widx > self.cur_widx - horizon

    def edge_weight(self, a, b, le=None, last=None) -> int:
        tot = 0
        for lab, wins in self.edges.get((a, b), {}).items():
            if le is not None and lab != le:
                continue
            tot += sum(w for widx, w in wins.items() if self._valid(widx, last))
        return tot

    def vertex_weight(self, v, le=None, direction="out", last=None) -> int:
        tot = 0
        for (a, b), labs in self.edges.items():
            if (a if direction == "out" else b) != v:
                continue
            for lab, wins in labs.items():
                if le is not None and lab != le:
                    continue
                tot += sum(w for widx, w in wins.items()
                           if self._valid(widx, last))
        return tot

    def reachable(self, a, b, max_hops=64) -> bool:
        """BFS over currently-live edges."""
        frontier, seen = {a}, {a}
        for _ in range(max_hops):
            if not frontier:
                return False
            nxt = set()
            for u in frontier:
                for v in self.out_adj.get(u, ()):  # check liveness
                    if self.edge_weight(u, v) > 0:
                        if v == b:
                            return True
                        nxt.add(v)
            frontier = nxt - seen
            seen |= nxt
        return False

    def subgraph_count(self, edges, last=None) -> int:
        vals = [self.edge_weight(a, b, le, last) for (a, b, le) in edges]
        return min(vals) if vals else 0


def edge_batches(st: GraphStream, batch_size: int):
    """Yield a stream as ``EdgeBatch``es of ``batch_size`` items, the last
    one short. Each is time-ordered and may span subwindow boundaries
    (the ingest takes either route for it). The port's batches hold host
    int32 arrays, where the ingest partition reads them; the handle they
    feed was created on its device explicitly (``sketch.create``)."""
    for a in range(0, len(st), batch_size):
        b = min(a + batch_size, len(st))
        yield EdgeBatch(*[np.ascontiguousarray(getattr(st, f)[a:b], np.int32)
                          for f in _FIELDS])
