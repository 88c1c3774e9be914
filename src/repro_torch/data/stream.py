"""Heterogeneous graph-stream generators (port of ``repro.data.stream``:
``StreamSpec``, ``SPECS``, ``generate``). Pure numpy and seeded: the same
spec and seed give the reference's stream bit for bit."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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


def _zipf_nodes(rng, n_vertices, n, a):
    z = rng.zipf(a, n)
    return ((z - 1) % n_vertices).astype(np.int32)


def generate(spec: StreamSpec, seed: int = 0,
             weighted: bool = False) -> EdgeBatch:
    """A time-ordered stream of ``spec.n_edges`` items as an ``EdgeBatch``
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
    return EdgeBatch.from_arrays(src, dst, vlab[src], vlab[dst], edge_label,
                                 weight, time)
