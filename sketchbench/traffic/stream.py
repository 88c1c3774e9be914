"""The benchmark's edge streams: the generator the cells run
(``StreamParams``, ``make_base``, ``Replay``), seeded, and a frozen copy
of the repository's exact ground truth (``GroundTruth``), so the
yardstick does not move with ``repro_torch/data/stream.py``.

``make_base`` is that module's ``generate`` frozen and extended: a
stream of the generator's shape (Zipf endpoints over the vertex
universe, a share of items repeating a recent edge, one label a vertex,
uniform edge labels, unit weights) at a fixed event-time density,
``edges_per_window`` items per ``window_size`` time units spread over the
units by one multinomial draw, so every seed gives the same number of
edges and the same span, over the same labelled vertices (the labels are
the graph's, drawn from ``label_seed``). ``Replay`` serves a base as an
endless stream: lap ``j`` repeats it ``j`` spans later with every vertex
id shifted by ``j * LAP_SHIFT`` (mod the universe), so later laps bring
new keys at the same skew. ``next_cut`` cuts micro-batches at subwindow
boundaries, so no batch spans two subwindows.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
          "time")
LAP_SHIFT = 7_919_089  # vertex-id shift a lap (odd, coprime to the sizes)


# --------------------------------------------------------------------------
# the repository's exact ground truth, frozen
# --------------------------------------------------------------------------

def _zipf_nodes(rng, n_vertices, n, a):
    z = rng.zipf(a, n)
    return ((z - 1) % n_vertices).astype(np.int32)


class GroundTruth:
    """Exact replay of a stream with the same sliding-window semantics."""

    def __init__(self, window_size: int, k: int):
        self.k = k
        self.ws = max(1, window_size // k)
        # edges[(a, b)][le][widx] = weight
        self.edges: Dict[Tuple[int, int], Dict[int, Dict[int, int]]] = \
            defaultdict(lambda: defaultdict(lambda: defaultdict(int)))
        self.cur_widx = -1 << 30

    def insert(self, cols: dict):
        for i in range(len(cols["src"])):
            w_idx = int(cols["time"][i]) // self.ws
            self.cur_widx = max(self.cur_widx, w_idx)
            key = (int(cols["src"][i]), int(cols["dst"][i]))
            self.edges[key][int(cols["edge_label"][i])][w_idx] += \
                int(cols["weight"][i])
        return self

    def _valid(self, widx, last=None) -> bool:
        horizon = self.k if last is None else min(last, self.k)
        return widx > self.cur_widx - horizon

    def edge_weight(self, a, b, le=None, last=None) -> int:
        tot = 0
        for lab, wins in self.edges.get((a, b), {}).items():
            if le is not None and lab != le:
                continue
            tot += sum(w for widx, w in wins.items()
                       if self._valid(widx, last))
        return tot


# --------------------------------------------------------------------------
# the cells' streams
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamParams:
    """A stream's shape and event-time density (from a configuration's
    ``stream`` object)."""

    n_vertices: int
    n_vertex_labels: int
    n_edge_labels: int
    zipf_a: float
    duplicate_rate: float
    edges_per_window: int
    window_size: int
    subwindow: int
    base_windows: int
    label_seed: int = 0

    @classmethod
    def from_config(cls, cfg: dict) -> "StreamParams":
        s, sk = cfg["stream"], cfg["sketch"]
        return cls(n_vertices=int(s["n_vertices"]),
                   n_vertex_labels=int(s["n_vertex_labels"]),
                   n_edge_labels=int(s["n_edge_labels"]),
                   zipf_a=float(s["zipf_a"]),
                   duplicate_rate=float(s["duplicate_rate"]),
                   edges_per_window=int(s["edges_per_window"]),
                   window_size=int(sk["window_size"]),
                   subwindow=int(sk["window_size"]) // int(sk["k"]),
                   base_windows=int(s["base_windows"]),
                   label_seed=int(s.get("label_seed", 0)))


def make_base(p: StreamParams, seed: int, t0: int = 0, graph: int = 0
              ) -> dict:
    """``base_windows`` windows of stream at ``edges_per_window`` items a
    window, event times from ``t0``: host int32 columns ``FIELDS``. The
    vertices' labels belong to the graph, not to the traffic: they come
    from ``label_seed + graph``, so every seed's stream runs over the same
    labelled vertices (the hottest ones land on the same shards and label
    blocks) and the seed draws the edges and their times."""
    rng = np.random.default_rng(seed)
    n = p.base_windows * p.edges_per_window
    span = p.base_windows * p.window_size
    src = _zipf_nodes(rng, p.n_vertices, n, p.zipf_a)
    dst = _zipf_nodes(rng, p.n_vertices, n, p.zipf_a)
    dup = rng.random(n) < p.duplicate_rate
    back = np.maximum(0, np.arange(n) - rng.integers(1, 500, n))
    src = np.where(dup, src[back], src)
    dst = np.where(dup, dst[back], dst)
    vlab = np.random.default_rng(p.label_seed + graph).integers(
        0, p.n_vertex_labels, p.n_vertices, dtype=np.int8)
    per_unit = rng.multinomial(n, np.full(span, 1.0 / span))
    time = (np.repeat(np.arange(span), per_unit) + t0).astype(np.int32)
    return dict(src=src, dst=dst, src_label=vlab[src].astype(np.int32),
                dst_label=vlab[dst].astype(np.int32),
                edge_label=rng.integers(0, p.n_edge_labels, n,
                                        dtype=np.int32),
                weight=np.ones(n, np.int32), time=time)


class Replay:
    """A base stream served as an endless one (laps shifted in time and in
    vertex ids). Positions are global item indices."""

    def __init__(self, p: StreamParams, base: dict):
        self.p = p
        self.base = base
        self.n = len(base["src"])
        self.span = p.base_windows * p.window_size
        widx = base["time"].astype(np.int64) // p.subwindow
        # the base's subwindow boundaries (a lap's end is one too)
        self.bounds = np.append(np.flatnonzero(np.diff(widx)) + 1, self.n)

    def next_cut(self, pos: int, max_batch: int) -> int:
        """The end of the batch that starts at ``pos``: at most
        ``max_batch`` items, stopping at the next subwindow boundary."""
        lap, local = divmod(pos, self.n)
        b = self.bounds[np.searchsorted(self.bounds, local, side="right")]
        return min(pos + max_batch, lap * self.n + int(b))

    def columns(self, a: int, b: int) -> dict:
        """Items ``[a, b)`` as host int32 columns (one lap at most)."""
        lap, la = divmod(a, self.n)
        lb = b - lap * self.n
        if lb > self.n:
            raise ValueError("a slice of the replay spans two laps")
        out = {f: self.base[f][la:lb] for f in FIELDS}
        if lap:
            nv = self.p.n_vertices
            shift = (lap * LAP_SHIFT) % nv
            for f in ("src", "dst"):
                x = out[f] + shift
                x[x >= nv] -= nv
                out[f] = x
            out["time"] = out["time"] + lap * self.span
        return out

    def at(self, idx: np.ndarray) -> dict:
        """Items at the positions ``idx`` (any laps) as int64 columns."""
        idx = np.asarray(idx, np.int64)
        lap, local = np.divmod(idx, self.n)
        out = {f: self.base[f][local].astype(np.int64) for f in FIELDS}
        shift = (lap * LAP_SHIFT) % self.p.n_vertices
        for f in ("src", "dst"):
            out[f] = (out[f] + shift) % self.p.n_vertices
        out["time"] = out["time"] + lap * self.span
        return out
