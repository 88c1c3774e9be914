"""LSketch as training telemetry (port of
``repro.telemetry.router_sketch``: ``RouterTelemetry`` and
``CapacityController``).

A MoE layer's routing step is a ``[n_buckets, n_experts]`` count matrix.
``RouterTelemetry`` turns it into graph-stream items

    (token_bucket --expert octile--> expert, weight=count, t=step)

and feeds them to a sharded LSketch whose sliding window runs over
training steps, so the paper's queries become telemetry reads: an
expert's in-weight is its windowed load (``expert_load``,
``load_vector``), an edge weight a routing affinity, ``last=j`` the most
recent ``j`` subwindows. ``CapacityController`` raises or lowers a
capacity factor from the windowed imbalance (max over mean load).

With ``mesh=`` (a ``sketch.MeshContext`` or a process group) the handle
is placed over the group's ranks and the reads default to the
``"collective"`` query path: each rank answers against its block of
planes and one all-reduce of the answers gives every rank the fleet's
load. The alternative, ``core.merge.psum_sketch``, all-reduces the whole
``[d, d, 2, k(, c)]`` planes per read; it is the tool when a plain merged
state is wanted. Every rank must feed the same counts in the same order.
The handle lives on ``device`` (the card unless the caller names the
CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch import sketch as skt
from repro_torch.core.types import EdgeBatch, LSketchConfig, \
    resolve_device


@dataclasses.dataclass
class RouterTelemetry:
    """Sliding-window sketch over the MoE routing stream."""

    n_experts: int
    n_buckets: int = 256
    window_steps: int = 64  # sliding window = last 64 training steps
    subwindows: int = 8
    d: int = 128
    n_shards: int = 1  # hash-partitioned sketch shards
    query_path: str = "auto"  # "scan" | "cuda" | "collective" | default
    mesh: Any = None  # lay the shard axis over this group's ranks
    axis: str = "data"
    device: Any = None

    def __post_init__(self):
        self.cfg = LSketchConfig(
            d=self.d, n_blocks=4, F=1024, r=4, s=8, c=8, k=self.subwindows,
            window_size=self.window_steps, pool_capacity=4096,
            pool_probes=16, seed=2024)
        self.spec = skt.SketchSpec(kind="lsketch", config=self.cfg,
                                   n_shards=self.n_shards)
        self.state = skt.create(self.spec, resolve_device(self.device))
        if self.mesh is not None:
            ctx = self.mesh if isinstance(self.mesh, skt.MeshContext) else \
                skt.MeshContext(group=self.mesh, axis=self.axis)
            self.state = skt.place(self.spec, self.state, ctx)
            if self.query_path == "auto" and ctx.divides(self.n_shards):
                # a replicated layout (place warned) keeps the host-path
                # default: collective would refuse it at every read
                self.query_path = "collective"
        # vertex ids: buckets [0, n_buckets); experts [n_buckets, ...)
        self._expert_base = self.n_buckets

    def ingest(self, counts: np.ndarray, step: int, min_count: int = 1):
        """counts: [n_buckets, n_experts] int (summed over layers), turned
        into weighted edges and inserted."""
        counts = np.asarray(counts)
        bk, ex = np.nonzero(counts >= min_count)
        if len(bk) == 0:
            return self
        n = len(bk)
        batch = EdgeBatch(
            src=bk.astype(np.int32),
            dst=(ex + self._expert_base).astype(np.int32),
            # vertex labels: token band (bucket / 64) vs the expert class
            src_label=(bk // 64).astype(np.int32),
            dst_label=np.full(n, 3, np.int32),
            # edge label: the expert octile, so queries can restrict by it
            edge_label=(ex % 8).astype(np.int32),
            weight=counts[bk, ex].astype(np.int32),
            time=np.full(n, step, np.int32))
        self.state = skt.ingest(self.spec, self.state, batch)
        return self

    def checkpoint(self, directory, step: int = 0, blocking: bool = True):
        """Persist the telemetry sketch (the sketch checkpoint format)."""
        return skt.save(self.spec, self.state, directory, step=step,
                        blocking=blocking)

    # ---- queries the controller uses ----
    def expert_load(self, expert: int, last: int | None = None) -> int:
        q = skt.QueryBatch.vertices([self._expert_base + expert], [3],
                                    direction="in", last=last)
        return int(skt.query(self.spec, self.state, q,
                             path=self.query_path)[0])

    def routing_affinity(self, bucket: int, expert: int,
                         last: int | None = None) -> int:
        q = skt.QueryBatch.edges([bucket], [bucket // 64],
                                 [self._expert_base + expert], [3], last=last)
        return int(skt.query(self.spec, self.state, q,
                             path=self.query_path)[0])

    def load_vector(self, last: int | None = None) -> np.ndarray:
        """Windowed load of every expert in one batched query: on the
        kernel paths it reuses the plane cache between ingests."""
        experts = self._expert_base + np.arange(self.n_experts,
                                                dtype=np.int32)
        q = skt.QueryBatch.vertices(experts, 3, direction="in", last=last)
        return skt.query(self.spec, self.state, q,
                         path=self.query_path).cpu().numpy()

    def imbalance(self, last: int | None = None) -> float:
        """max/mean windowed expert load — the controller signal."""
        v = self.load_vector(last).astype(np.float64)
        mean = v.mean()
        return float(v.max() / mean) if mean > 0 else 1.0


class CapacityController:
    """Adjusts the MoE capacity factor from windowed sketch imbalance: hot
    (imbalance > hi) raises it (fewer drops), cold (< lo) lowers it (less
    padding compute)."""

    def __init__(self, telemetry: RouterTelemetry, lo=1.1, hi=2.0,
                 cf_min=1.0, cf_max=4.0, gain=0.25):
        self.t = telemetry
        self.lo, self.hi = lo, hi
        self.cf_min, self.cf_max = cf_min, cf_max
        self.gain = gain

    def update(self, cf: float, last: int = 2) -> float:
        imb = self.t.imbalance(last=last)
        if imb > self.hi:
            cf = min(self.cf_max, cf * (1 + self.gain))
        elif imb < self.lo:
            cf = max(self.cf_min, cf * (1 - self.gain / 2))
        return cf
