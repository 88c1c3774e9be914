"""Skew-aware shard routing (port of ``repro.sketch.routing``; numpy, as
the reference's): heavy-key detection, hot-vertex splitting and
workload-aware shard sizing.

The ingest partition routes an edge by its source endpoint entity
``(src, src_label)``, so a power-law stream lands a hot vertex's whole
traffic on one shard: that shard's rows pad every shard's bucket, and its
distinct neighbours crowd the same ``r`` candidate rows and then the pool.

  * ``HeavyKeyDetector`` — a space-saving summary of the source-endpoint
    stream; a tracked count never under-counts its key, so a threshold
    test never misses a key hotter than ``threshold * total`` once the
    capacity covers the head.
  * ``RoutingTable`` — a frozen set of split keys ``(src, src_label,
    n_replicas)`` carried on the ``SketchSpec``. A split key's edges
    scatter over ``n_replicas`` consecutive shards from its base shard by
    a salted hash of ``(src, dst)``; unsplit keys route as before, so an
    empty table gives the plain partition bit for bit.
  * ``recommend_budget`` / ``prune_routing`` — a routing table that levels
    the per-shard load a detector (and a query log) saw, and the table
    without the keys that cooled.

Queries probe every shard and sum the partials, so they need no routing
knowledge: each edge occurrence lives on one shard, and every shard's
estimate is one-sided over what it holds. Shard ids equal the
reference's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .spec import (SketchSpec, _SHARD_SALT, _hash31_np, shard_assignment,
                   shard_assignment_vids)

# salt for the replica-index hash: distinct from shard routing (_SHARD_SALT)
# and the reshard vid routing (^0x7E5) so the three hash uses are independent
_REPLICA_SALT = 0x5EED


def _pack_endpoints(src, src_label) -> np.ndarray:
    """(src, src_label) -> one int64 sort/search key."""
    src = np.asarray(src, np.int64)
    lab = np.asarray(src_label, np.int64)
    return (src << np.int64(32)) | (lab & np.int64(0xFFFFFFFF))


@dataclass(frozen=True)
class RoutingTable:
    """Frozen, hashable set of split keys: ``(src, src_label, n_replicas)``.

    Entries are normalized to a sorted tuple (construction order never
    changes identity) and must be unique per ``(src, src_label)``;
    ``n_replicas >= 2`` (1 would be a no-op entry). Numpy lookup arrays
    are precomputed once — the per-batch membership test is a single
    ``searchsorted`` over the packed endpoint keys.
    """

    splits: tuple = ()

    def __post_init__(self):
        norm = tuple(sorted((int(s), int(l), int(r)) for s, l, r
                            in self.splits))
        keys = [(s, l) for s, l, _ in norm]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate split keys in {norm}")
        if any(r < 2 for _, _, r in norm):
            raise ValueError("n_replicas must be >= 2 (1 is the unsplit "
                             f"state — drop the entry instead): {norm}")
        object.__setattr__(self, "splits", norm)
        object.__setattr__(self, "_keys", _pack_endpoints(
            [s for s, _, _ in norm], [l for _, l, _ in norm]))
        object.__setattr__(self, "_reps", np.asarray(
            [r for _, _, r in norm], np.int32))

    def __bool__(self) -> bool:
        return bool(self.splits)

    def merged(self, entries) -> "RoutingTable":
        """New table with ``entries`` added; an existing key's replica
        count is replaced (the split/unsplit state machine's only
        transition — split wider — keeps old entries stable)."""
        table = {(s, l): r for s, l, r in self.splits}
        table.update({(int(s), int(l)): int(r) for s, l, r in entries})
        return RoutingTable(tuple((s, l, r) for (s, l), r in table.items()))

    def replicas(self, src, src_label) -> np.ndarray:
        """Per-row replica counts (1 where unsplit) — vectorized."""
        keys = _pack_endpoints(src, src_label)
        if not self.splits:
            return np.ones(keys.shape, np.int32)
        pos = np.minimum(np.searchsorted(self._keys, keys),
                         len(self._keys) - 1)
        hit = self._keys[pos] == keys
        return np.where(hit, self._reps[pos], np.int32(1)).astype(np.int32)

    # ---- JSON round-trip (checkpoint manifests, via SketchSpec) -----------

    def to_json(self) -> dict:
        return {"splits": [list(e) for e in self.splits]}

    @classmethod
    def from_json(cls, d: dict) -> "RoutingTable":
        return cls(tuple(tuple(e) for e in d["splits"]))


def routed_assignment(spec: SketchSpec, src, dst,
                      src_label=None) -> np.ndarray:
    """Shard id of every edge under the spec's routing table.

    Unsplit keys: the plain ``shard_assignment`` hash (bit-identical to a
    table-free spec). A split key's edges spread over ``n_replicas``
    consecutive shards from its base shard: ``(base + h(src, dst) % reps)
    % n_shards`` with a salted secondary hash — a pure function of
    (seed, src, dst), so the placement is stable across processes and
    replays, and both endpoints' entropy feeds the spread (a hot vertex's
    distinct neighbors are exactly what must scatter).
    """
    base = shard_assignment(spec, src, src_label)
    table = getattr(spec, "routing", None)
    if not table or spec.n_shards == 1:
        return base
    src = np.asarray(src, np.int64)
    lab = np.zeros_like(src) if src_label is None \
        else np.asarray(src_label, np.int64)
    reps = np.minimum(table.replicas(src, lab), np.int32(spec.n_shards))
    if not (reps > 1).any():
        return base
    dst = np.asarray(dst, np.int64)
    mixed = (src.astype(np.uint32) * np.uint32(2654435761)) ^ \
        (dst.astype(np.uint32) * np.uint32(0x27D4EB2F))
    h = _hash31_np(mixed, spec.seed ^ _SHARD_SALT ^ _REPLICA_SALT)
    return ((base + h % reps) % np.int32(spec.n_shards)).astype(np.int32)


def routed_assignment_vids(spec: SketchSpec, vid_src,
                           vid_dst) -> np.ndarray:
    """Key-space twin of ``routed_assignment`` (what a reshard re-places
    decoded records by): packed vertex identities, with split keys mapped
    to vid space through the port's own ``precompute``. It need not agree
    with the ingest-time raw-id hash; replica partials sum under every
    query, so answers keep their one-sided bound.
    """
    base = shard_assignment_vids(spec, vid_src)
    table = getattr(spec, "routing", None)
    if not table or spec.n_shards == 1:
        return base
    import torch
    from repro_torch.core.lsketch import precompute
    vid_src = np.asarray(vid_src, np.int64)
    vid_dst = np.asarray(vid_dst, np.int64)
    srcs = torch.tensor([s for s, _, _ in table.splits], dtype=torch.int32)
    labs = torch.tensor([l for _, l, _ in table.splits], dtype=torch.int32)
    split_vids = precompute(spec.config, srcs, labs).vid.numpy().astype(
        np.int64)
    reps = np.ones(vid_src.shape, np.int32)
    for vid, (_, _, r) in zip(split_vids, table.splits):
        reps[vid_src == vid] = r
    reps = np.minimum(reps, np.int32(spec.n_shards))
    if not (reps > 1).any():
        return base
    mixed = (vid_src.astype(np.uint32) * np.uint32(2654435761)) ^ \
        (vid_dst.astype(np.uint32) * np.uint32(0x27D4EB2F))
    h = _hash31_np(mixed, spec.seed ^ _SHARD_SALT ^ 0x7E5 ^ _REPLICA_SALT)
    return ((base + h % reps) % np.int32(spec.n_shards)).astype(np.int32)


class HeavyKeyDetector:
    """Space-saving heavy-key summary over the source-endpoint stream.

    Capacity-bounded counter table: a new key either takes a free slot or
    replaces the current minimum, inheriting its count (the classic
    space-saving overestimate — a tracked count never undercounts the
    key's true frequency, so ``hot_keys`` never misses a genuinely hot
    key once the head fits in ``capacity``). ``update`` is batch-oriented:
    one ``np.unique`` over the packed endpoints, then per-distinct-key
    table maintenance — O(distinct) python work per batch, riding the
    same host pass the partition already pays for.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.total = 0
        self.counts: dict = {}  # (src, src_label) -> count

    def update(self, src, src_label=None) -> None:
        src = np.atleast_1d(np.asarray(src, np.int64))
        lab = np.zeros_like(src) if src_label is None \
            else np.atleast_1d(np.asarray(src_label, np.int64))
        packed, cnts = np.unique(_pack_endpoints(src, lab),
                                 return_counts=True)
        self.total += int(cnts.sum())
        for key, c in zip(packed.tolist(), cnts.tolist()):
            pair = (key >> 32, key & 0xFFFFFFFF)
            if pair in self.counts:
                self.counts[pair] += c
            elif len(self.counts) < self.capacity:
                self.counts[pair] = c
            else:
                victim = min(self.counts, key=self.counts.get)
                floor = self.counts.pop(victim)
                self.counts[pair] = floor + c

    def hot_keys(self, threshold: float):
        """Keys whose (one-sided) count reaches ``threshold * total``,
        hottest first — ``[(src, src_label, count), ...]``."""
        cut = threshold * max(self.total, 1)
        hot = [(s, l, c) for (s, l), c in self.counts.items() if c >= cut]
        return sorted(hot, key=lambda e: (-e[2], e[0], e[1]))


def prune_routing(table: RoutingTable, detector: HeavyKeyDetector,
                  threshold: float) -> RoutingTable:
    """The un-split transition: a new table keeping only the split keys
    the detector still rates hot (count >= ``threshold * total``); keys it
    no longer tracks count as cooled. Removal is the fold-back to the
    plain hash (``RoutingTable`` forbids ``n_replicas < 2``). Live ingest
    must not apply a pruned table: the pressure the split relieved would
    return while the history stays where it is. It is applied where the
    records are re-placed: ``reshard(..., detector=, heat_threshold=)``.
    """
    if not table:
        return table
    cut = threshold * max(detector.total, 1)
    keep = [(s, l, r) for s, l, r in table.splits
            if detector.counts.get((s, l), 0) >= cut]
    return RoutingTable(tuple(keep))


@dataclass(frozen=True)
class BudgetReport:
    """Per-shard workload fractions and the routing table that levels
    them (new ingest applies it by carrying
    ``spec.replace(routing=report.routing)``)."""

    ingest_load: tuple   # per-shard ingest fraction (detector-derived)
    query_load: tuple    # per-shard query-endpoint fraction (serving log)
    combined: tuple      # the blended load recommend_budget leveled
    routing: "RoutingTable"

    def to_json(self) -> dict:
        return {"ingest_load": list(self.ingest_load),
                "query_load": list(self.query_load),
                "combined": list(self.combined),
                "routing": self.routing.to_json()}


def recommend_budget(spec: SketchSpec, detector: HeavyKeyDetector,
                     query_counts=None, *, alpha: float = 0.5,
                     slack: float = 1.25) -> BudgetReport:
    """gSketch-style workload-aware sizing as a routing recommendation.

    Per-shard shares can't literally differ in size (shards are one
    stacked pytree — uniform by construction), so "more room for hot
    shards" is realized the only constant-memory way there is: split the
    keys that overload a shard across replica shards, giving their rows
    ``n_replicas``x the matrix rows and pool capacity at unchanged total
    bytes. The blend: ``combined = alpha * ingest + (1-alpha) * query``
    per-shard load fractions — ingest from the detector's tracked counts
    (untracked tail spread uniformly), query from a serving endpoint log
    (``SketchServer.query_shard_counts``; uniform when absent). Every
    tracked key whose home shard's combined load exceeds ``slack /
    n_shards`` is split with ``n_replicas = min(n_shards,
    ceil(combined[home] * n_shards))`` — enough replicas to dilute that
    shard to parity. Existing splits are kept (``merged``).
    """
    n = spec.n_shards
    ingest = np.zeros(n, np.float64)
    keys = list(detector.counts.items())
    tracked = 0
    if keys:
        srcs = np.asarray([k[0] for k, _ in keys], np.int64)
        labs = np.asarray([k[1] for k, _ in keys], np.int64)
        cnts = np.asarray([c for _, c in keys], np.float64)
        homes = shard_assignment(spec, srcs, labs)
        np.add.at(ingest, homes, cnts)
        tracked = float(cnts.sum())
    tail = max(float(detector.total) - tracked, 0.0)
    ingest += tail / n
    ingest /= max(ingest.sum(), 1e-9)
    if query_counts is None:
        query = np.full(n, 1.0 / n)
    else:
        query = np.asarray(query_counts, np.float64)
        query /= max(query.sum(), 1e-9)
    combined = alpha * ingest + (1.0 - alpha) * query
    combined /= max(combined.sum(), 1e-9)

    entries = []
    if keys and n > 1:
        cut = slack / n
        # only keys that are themselves a load (>= half a fair shard's
        # worth of tracked traffic): splitting a cold key that merely
        # shares a hot shard spends routing-table entries for nothing
        heavy = max(float(detector.total), 1.0) / (2 * n)
        for (s, l), c in sorted(keys, key=lambda kv: -kv[1]):
            if c < heavy:
                break
            home = int(shard_assignment(spec, np.asarray([s]),
                                        np.asarray([l]))[0])
            if combined[home] > cut:
                reps = int(min(n, max(2, np.ceil(combined[home] * n))))
                entries.append((s, l, reps))
    base = spec.routing if getattr(spec, "routing", None) else RoutingTable()
    return BudgetReport(ingest_load=tuple(ingest.tolist()),
                        query_load=tuple(query.tolist()),
                        combined=tuple(combined.tolist()),
                        routing=base.merged(entries))
