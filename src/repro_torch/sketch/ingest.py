"""Hash-partitioned sharded ingest (port of ``repro.sketch.ingest``:
``_shard_bucket``, ``_partition_stack``, ``ingest``, ``AsyncIngestor``,
``_degenerate_batch``, ``_ingest_stacked_lgs``, ``ingest_single``).

``ingest(spec, state, batch)``:
  1. the host partitions the time-ordered batch by the shard hash of its
     source endpoint, or by the spec's routing table for split hot keys
     (``routing.routed_assignment``; numpy, stable, so every shard's rows
     stay in stream order), pads every shard's row to one bucketed
     length (replicate-last, masked by a per-shard ``n_valid``) and
     records the round in ``telemetry.stream_stats.PARTITION_STATS``;
  2. one stacked insert (``engine.insert.insert_stacked_fused_impl``)
     updates the handle's tensors in place — the CUDA kernel route for a
     single-subwindow flush on ``path="cuda"``, the stream-order scan
     otherwise.

The call returns a new handle over the updated tensors and marks the input
handle spent (see ``sketch/state.py``). When the spent handle held query
planes, or a pending chain of flush deltas, the insert also records this
flush's ``PlanesDelta`` and the new handle carries ``(the parent's
planes, chain + [delta])``, so its first query folds instead of
rebuilding (``sketch/query.py``); a handle that was never queried
ingests with no delta work. A ``gss`` batch loses its labels and times
first (``_degenerate_batch``); an ``lgs`` flush is a count-min
scatter-add per shard.

``AsyncIngestor`` staggers the two halves by one batch, as the
reference does: each ``submit`` dispatches the staged batch, then
partitions its own while the card finishes the dispatch's last kernels.
Dispatches keep submission order, and ``flush()``/``.state`` give exactly
the handle synchronous ``ingest`` of the same batches gives, each batch
partitioned under the spec it was submitted with. With
``heat_threshold`` set, a ``HeavyKeyDetector`` rides the host half and
splits a source endpoint that crosses the threshold from that batch on.

A mesh-resident handle (``place``) keeps its residency: every rank
partitions the whole batch (a pure function of the batch and the spec),
keeps its block of rows and inserts only those, and the new handle
carries the ``MeshContext`` forward; the flush takes the route the whole
partition would take, so the rows end as unplaced ingest leaves them. A
replicated handle ingests every row on every rank.

``ingest_single`` is the unstacked one-shard path the objects (``LSketch``,
``GSS``, ``LGS``) ride: no partition, the engine's path choice on the
plain state, in place.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lgs import lgs_insert_impl
from repro_torch.core.types import EdgeBatch
from repro_torch.engine import insert as eng_insert
from repro_torch.engine.window import pad_to_bucket

from repro_torch.telemetry.spans import span
from repro_torch.telemetry.stream_stats import PARTITION_STATS

from . import query as _query
from .routing import HeavyKeyDetector, routed_assignment
from .spec import SketchSpec
from .state import ShardedState, create, mesh_context, split_context, \
    with_mesh

_FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
           "time")


class StackedBatch:
    """int32 ``[n_shards, L]`` tensors, one per ``EdgeBatch`` field, and
    optionally the host copy of the time column (``time_host``, which lets
    the insert choose its route without reading the card)."""

    def __init__(self, time_host=None, **cols):
        for f in _FIELDS:
            setattr(self, f, cols[f])
        self.time_host = time_host


def _degenerate_batch(batch: EdgeBatch) -> EdgeBatch:
    """GSS ignores labels and timestamps: normalize them away."""
    z = np.zeros(len(batch), np.int32)
    return EdgeBatch(src=batch.src, dst=batch.dst, src_label=z, dst_label=z,
                     edge_label=z, weight=batch.weight, time=z)


def ingest_single(spec: SketchSpec, state, batch: EdgeBatch,
                  path: str = "auto"):
    """Insert a batch into one plain (unstacked) state, in place; returns
    it. The path the objects ride: the engine's path choice for lsketch
    and gss, the count-min insert (bucket-padded, inert pad weights) for
    lgs."""
    n = len(batch)
    if n == 0:
        return state
    if spec.kind == "gss":
        batch = _degenerate_batch(batch)
    if spec.kind == "lgs":
        dev = state.C.device
        cols = [pad_to_bucket(np.asarray(getattr(batch, f), np.int32))
                for f in _FIELDS]
        cols[5] = cols[5].copy()
        cols[5][n:] = 0  # padded weights are inert
        t = [torch.from_numpy(np.ascontiguousarray(c)).to(dev)
             for c in cols]
        return lgs_insert_impl(spec.config, state, *t)
    return eng_insert.insert_batch(spec.config, state, batch, path=path)


def _shard_bucket(n: int, floor: int = 64) -> int:
    """Per-shard row-length bucket: powers of two plus the 1.5x midpoints
    (64, 96, 128, 192, 256, ...)."""
    b = floor
    while b < n:
        if n <= b + b // 2:
            return b + b // 2
        b *= 2
    return b


def _partition_stack(spec: SketchSpec, batch: EdgeBatch):
    """Host-side stable partition under the spec's routing -> (dict of
    int32 ``[n_shards, L]`` numpy arrays, n_valid int32 ``[n_shards]``);
    the round's shard counts go to ``PARTITION_STATS``."""
    with span("lsketch.ingest.partition"):
        fields = {f: np.asarray(getattr(batch, f), np.int32) for f in _FIELDS}
        sid = routed_assignment(spec, fields["src"], fields["dst"],
                                fields["src_label"])
        n_sh = spec.n_shards
        index = [np.flatnonzero(sid == s) for s in range(n_sh)]
        counts = np.array([len(ix) for ix in index], np.int32)
        L = _shard_bucket(max(int(counts.max()), 1), floor=64)
        PARTITION_STATS.record(counts, L)
        out = {f: np.zeros((n_sh, L), np.int32) for f in _FIELDS}
        for s, ix in enumerate(index):
            m = len(ix)
            if m == 0:
                continue  # all-zero row, fully masked by n_valid == 0
            for f in _FIELDS:
                row = out[f][s]
                row[:m] = fields[f][ix]
                # replicate-last keeps time non-decreasing
                row[m:] = row[m - 1]
        return out, counts


def _ingest_stacked_lgs(cfg, shards, batch: StackedBatch, n_valid) -> None:
    """Each shard's row of an ``[S, L]`` flush into its LGS, in place; rows
    at or past ``n_valid`` are padding (no weight, no ring claim)."""
    L = batch.src.shape[1]
    for s in range(batch.src.shape[0]):
        valid = torch.arange(L, device=batch.src.device) < int(n_valid[s])
        lgs_insert_impl(cfg, shards.map(lambda x: x[s]), batch.src[s],
                        batch.dst[s], batch.src_label[s], batch.dst_label[s],
                        batch.edge_label[s],
                        batch.weight[s] * valid.to(torch.int32),
                        batch.time[s], valid=valid)


def _dispatch_stacked(spec: SketchSpec, state: ShardedState, cols,
                      counts, path: str) -> ShardedState:
    """One stacked insert of a host partition ``(cols, counts)`` into the
    handle (shared by ``ingest`` and ``AsyncIngestor``): spends ``state``
    and returns the new handle, which carries the flush delta when
    ``state`` held planes or a pending chain, and the ``MeshContext``
    (a split handle inserts its block of the partition's rows)."""
    with span("lsketch.ingest.dispatch"):
        shards = state.live()
        dev = state.device
        split = split_context(spec, state)
        route_cols, route_counts = cols, counts
        if split is not None:
            sl = split.block(spec.n_shards)
            cols = {f: v[sl] for f, v in cols.items()}
            counts = counts[sl]
        stacked = StackedBatch(time_host=cols["time"],
                               **{f: torch.from_numpy(cols[f]).to(dev)
                                  for f in _FIELDS})
        carry = None
        if spec.kind == "lgs":
            _ingest_stacked_lgs(spec.config, shards, stacked, counts)
        else:
            path = eng_insert.resolve_path(spec.config, path, dev)
            if path == "chunked":
                raise ValueError("the stacked ingest has no chunked path")
            carry = _query.planes_delta_base(state)
            use_kernel = path == "cuda"
            # a split handle takes the whole partition's route, not the
            # block's
            if split is not None:
                use_kernel = use_kernel and bool(eng_insert.one_segment(
                    spec.config, route_cols["time"], route_counts).all())
            out = eng_insert.insert_stacked_fused_impl(
                spec.config, shards, stacked, counts, use_kernel=use_kernel,
                emit_delta=carry is not None)
        state.spent = True
        new = with_mesh(ShardedState(shards), mesh_context(state))
        if carry is not None:
            _query.attach_planes_delta(new, carry[0], carry[1], out[1])
        return new


def _stage(spec: SketchSpec, batch: EdgeBatch):
    """The host half of a flush: the ``gss`` normalisation and the hash
    partition. Returns ``(cols, counts)``."""
    if spec.kind == "gss":
        batch = _degenerate_batch(batch)
    return _partition_stack(spec, batch)


def ingest(spec: SketchSpec, state: ShardedState, batch: EdgeBatch,
           path: str = "auto") -> ShardedState:
    """Insert a time-ordered batch into a sharded handle, in place; returns
    the new handle and marks ``state`` spent. ``path``: "auto" (the kernel
    route on a CUDA state, the scan on a CPU state), "scan" or "cuda"
    (lgs has one route and ignores it)."""
    state.live()
    if len(batch) == 0:
        return state
    cols, counts = _stage(spec, batch)
    return _dispatch_stacked(spec, state, cols, counts, path)


class AsyncIngestor:
    """Pipelined ingest over one sharded handle.

    A flush has a host half (the numpy hash partition) and a device half
    (the stacked insert). ``submit(batch)`` first dispatches the
    previously staged batch, then partitions this one on the host while
    the card runs what that dispatch enqueued last; ``flush()`` dispatches
    whatever is staged and returns the handle. After it the state
    reflects every submitted batch, in submission order (each dispatch
    consumes the previous handle, so nothing reorders across subwindow
    boundaries). ``.state`` flushes implicitly, so reading it always gives
    synchronous ``ingest``'s handle; ``dispatched`` gives the handle
    without collapsing the one-batch stagger.

    The overlap is small: the dispatch waits on the card a few times a
    flush, and the partition is under a millisecond a batch. Partitioning
    on a worker thread instead lost a quarter of the edges/s on an H100's
    host, the interpreter lock shared with the dispatch's ~440 launches a
    flush (``tools/ingest_overlap.py`` measures every variant).

    Like ``ingest``, every dispatch spends the previous handle: query the
    handle ``flush()`` returns before the next ``submit``.

    Skew-aware routing: with ``heat_threshold`` set, a
    ``HeavyKeyDetector`` (``detector``, or a fresh one) sees every
    batch's source endpoints before it is partitioned, and a key past
    ``heat_threshold`` of the stream so far is split over
    ``split_replicas`` shards (default: all) from this batch on, by
    ``self.spec = spec.with_splits(...)``. The spec keeps its identity,
    history stays where it was placed (queries sum every shard), and
    ``.spec.routing`` holds the live table."""

    def __init__(self, spec: SketchSpec, state: ShardedState | None = None,
                 path: str = "auto", heat_threshold: float | None = None,
                 detector: HeavyKeyDetector | None = None,
                 split_replicas: int | None = None, device=None):
        self.spec = spec
        self.path = path
        self.heat_threshold = heat_threshold
        self.detector = detector
        if detector is None and heat_threshold is not None:
            self.detector = HeavyKeyDetector()
        self.split_replicas = split_replicas
        self._state = state if state is not None else create(spec, device)
        self._staged = None  # (cols, counts) awaiting dispatch

    def _observe(self, batch: EdgeBatch) -> None:
        """Update the heavy-key summary and apply any new splits before
        this batch is partitioned."""
        self.detector.update(np.asarray(batch.src),
                             np.asarray(batch.src_label))
        split = {(s, l) for s, l, _ in self.spec.routing.splits} \
            if self.spec.routing else set()
        reps = self.split_replicas or self.spec.n_shards
        new = [(s, l, reps) for s, l, _ in
               self.detector.hot_keys(self.heat_threshold)
               if (s, l) not in split]
        if new:
            self.spec = self.spec.with_splits(new)

    def submit(self, batch: EdgeBatch) -> None:
        """Enqueue a time-ordered batch: partition it now, dispatch it on
        the next ``submit``/``flush``."""
        if len(batch) == 0:
            return
        if self.spec.kind == "gss":
            batch = _degenerate_batch(batch)
        if self.detector is not None and self.heat_threshold is not None \
                and self.spec.n_shards > 1:
            self._observe(batch)
        self._dispatch_staged()  # the card takes batch N ...
        self._staged = _partition_stack(self.spec, batch)  # ... host N+1

    def flush(self) -> ShardedState:
        """Dispatch any staged batch; returns the fully applied handle."""
        self._dispatch_staged()
        return self._state

    @property
    def state(self) -> ShardedState:
        """The handle with every submitted batch applied (implicit
        flush)."""
        return self.flush()

    @property
    def dispatched(self) -> ShardedState:
        """The live handle with every dispatched batch applied; unlike
        ``state`` this does not flush the staged batch."""
        return self._state

    @property
    def pending(self) -> int:
        """Number of staged, not yet dispatched batches (0 or 1)."""
        return int(self._staged is not None)

    def _dispatch_staged(self) -> None:
        if self._staged is None:
            return
        (cols, counts), self._staged = self._staged, None
        self._state = _dispatch_stacked(self.spec, self._state, cols, counts,
                                        self.path)
