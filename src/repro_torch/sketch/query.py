"""Batched queries over a sharded handle (port of ``repro.sketch.query``).

``query(spec, state, QueryBatch, path=...)`` answers a batch against every
shard and sums the shard partials (hash partitioning makes them disjoint):

  * ``path="scan"`` — the dense reference (``core/queries.py``) on each
    shard, re-reducing the counter planes under the window mask per call;
  * ``path="cuda"`` — the kernel route (the counterpart of JAX's
    ``"pallas"``): the edge-probe and vertex-scan CUDA kernels on cached
    window-reduced ``QueryPlanes``; label aggregates reduce the same planes
    in plain PyTorch. On a CPU state the same wrappers take each kernel's
    plain version.
  * ``"auto"`` is ``"cuda"`` for a CUDA state and ``"scan"`` for a CPU one.

Every shard queries under the fleet-wide newest subwindow index (a
lagging shard must not count ring slots the combined stream expired).
The planes are memoized on the handle object, keyed by the clamped
horizon ``min(last or k, k)``, in a small LRU (``PLANES_CACHE_CAP``);
ingest returns a new handle, so the cache is never stale. Query batches
are padded to power-of-two buckets with the ``EMPTY`` sentinel; pad rows
are sliced off.

A ``gss`` query drops its labels and its window (``normalize_query``); an
``lgs`` query always takes the scan (count-min cells: no keyed walk, no
planes), and an ``lgs`` label aggregate raises. A plain single-shard
state (an object's ``.state``) is accepted and lifted to a fresh 1-shard
handle over views of its tensors, so its planes live for one call; the
objects pass their own handle, whose cache lives until their next insert.
``PLANES_BUILD_COUNTS["build"]`` counts the plane builds (cache misses)
in the process.

A list ``last`` is a horizon sweep: ``int32 [H, B]`` out, row ``i`` equal
to ``last=lasts[i]``. ``"scan"`` loops the single-horizon reference;
``"cuda"`` answers every row from one horizon-stacked ``MultiPlanes``
build (one cache entry keyed ``("multi", horizons)``) through the same
kernels: an edge sweep in one launch of the fused edge kernel, the other
kinds one horizon at a time. The reference's flush-delta plane
maintenance is not ported: every new handle rebuilds its planes.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import queries as _q
from repro_torch.core.lgs import _lgs_edge_query, _lgs_vertex_query
from repro_torch.core.types import EMPTY
from repro_torch.engine.window import bucket_size

from .spec import SketchSpec
from .state import ShardedState

PLANES_CACHE_CAP = 8
_PLANES_ATTR = "_query_planes_cache"
PLANES_BUILD_COUNTS = {"build": 0}


@dataclass(frozen=True)
class QueryBatch:
    """One homogeneous batch of queries (one kind / window / direction)."""

    kind: str  # "edge" | "vertex" | "label"
    src: Any = None
    src_label: Any = None
    dst: Any = None
    dst_label: Any = None
    vertex: Any = None
    vertex_label: Any = None
    edge_label: Any = None
    direction: str = "out"
    last: Any = None

    @classmethod
    def edges(cls, src, src_label, dst, dst_label, edge_label=None,
              last=None) -> "QueryBatch":
        return cls(kind="edge", src=src, src_label=src_label, dst=dst,
                   dst_label=dst_label, edge_label=edge_label, last=last)

    @classmethod
    def vertices(cls, vertex, vertex_label, edge_label=None,
                 direction: str = "out", last=None) -> "QueryBatch":
        return cls(kind="vertex", vertex=vertex, vertex_label=vertex_label,
                   edge_label=edge_label, direction=direction, last=last)

    @classmethod
    def labels(cls, vertex_label, edge_label=None, direction: str = "out",
               last=None) -> "QueryBatch":
        return cls(kind="label", vertex_label=vertex_label,
                   edge_label=edge_label, direction=direction, last=last)


def resolve_query_path(path: str = "auto", device=None,
                       kind: str = "lsketch") -> str:
    """Normalize a query path name to "scan" | "cuda"; an ``lgs`` sketch
    always takes "scan"."""
    if path == "auto":
        path = "cuda" if torch.device(device or "cpu").type == "cuda" \
            else "scan"
    if path not in ("scan", "cuda"):
        raise ValueError(f"unknown query path {path!r}")
    return "scan" if kind == "lgs" else path


def as_i32(x, n: int | None = None, device=None) -> torch.Tensor:
    """int32 1-D tensor on ``device``, broadcast to length ``n``."""
    a = torch.as_tensor(np.atleast_1d(np.asarray(
        x.cpu() if isinstance(x, torch.Tensor) else x, np.int32)))
    if n is not None and a.shape[0] != n:
        a = a.expand(n)
    return a.contiguous().to(device)


def pad_all(n: int, *arrays, floor: int = 32):
    """Pad every [n] tensor to the common bucket size with ``EMPTY``."""
    to = bucket_size(n, floor=floor)
    if to == n:
        return arrays
    return tuple(torch.cat([a, torch.full((to - a.shape[0],), EMPTY,
                                          dtype=a.dtype, device=a.device)])
                 for a in arrays)


def normalize_query(q: QueryBatch, device=None, kind: str = "lsketch"):
    """int32 tensors on ``device``, broadcast and bucket-padded. Returns
    ``(arrays, with_le, last, n)``: ``(src, dst, la, lb, les)`` for edges,
    ``(v, lv, les)`` for vertices, ``(lv, les)`` for labels; ``n`` is the
    unpadded row count. A ``gss`` sketch (``kind``) drops the labels, the
    edge label and the window; an ``lgs`` sketch has no label
    aggregate."""
    gss = kind == "gss"
    le, last = (None, None) if gss else (q.edge_label, q.last)
    with_le = le is not None

    def labels(x, n):
        return torch.zeros(n, dtype=torch.int32, device=device) if gss \
            else as_i32(x, n, device)

    if q.kind == "edge":
        src, dst = as_i32(q.src), as_i32(q.dst)
        n = max(src.shape[0], dst.shape[0])
        src, dst = as_i32(src, n, device), as_i32(dst, n, device)
        la, lb = labels(q.src_label, n), labels(q.dst_label, n)
        les = as_i32(le, n, device) if with_le else torch.zeros_like(src)
        return pad_all(n, src, dst, la, lb, les), with_le, last, n
    if q.kind == "vertex":
        v = as_i32(q.vertex, None, device)
        n = v.shape[0]
        lv = labels(q.vertex_label, n)
        les = as_i32(le, n, device) if with_le else torch.zeros_like(v)
        return pad_all(n, v, lv, les), with_le, last, n
    if q.kind == "label":
        if kind == "lgs":
            raise NotImplementedError(
                "LGS stores no label blocks; label aggregates need "
                "LSketch/GSS")
        n = as_i32(q.vertex_label).shape[0]
        lv = labels(q.vertex_label, n)
        les = as_i32(le, n, device) if with_le else torch.zeros_like(lv)
        return pad_all(n, lv, les), with_le, last, n
    raise ValueError(f"unknown query kind {q.kind!r}")


def _with_global_window(shards):
    """A view of the stack in which every shard carries the fleet-wide
    newest subwindow index (the handle's own tensors are not touched)."""
    g = shards.cur_widx.max().expand(shards.cur_widx.shape)
    return dataclasses.replace(shards, cur_widx=g)


def query_planes(spec: SketchSpec, state: ShardedState, last=None):
    """The window-reduced ``QueryPlanes`` for ``(state, last)``, memoized on
    the handle object in an LRU of ``PLANES_CACHE_CAP`` entries keyed by
    the clamped horizon (``last=None`` and ``last>=k`` share one entry)."""
    shards = state.live()
    k = spec.config.effective_k
    horizon = k if last is None else min(int(last), k)
    return _cached(state, horizon, lambda: _q.build_query_planes(
        spec.config, _with_global_window(shards), horizon))


def _cached(state: ShardedState, ckey, build):
    """The handle's LRU entry ``ckey``, made by ``build()`` on a miss."""
    cache = getattr(state, _PLANES_ATTR, None)
    if cache is None:
        cache = OrderedDict()
        setattr(state, _PLANES_ATTR, cache)
    if ckey in cache:
        cache.move_to_end(ckey)
        return cache[ckey]
    while len(cache) >= PLANES_CACHE_CAP:
        cache.popitem(last=False)
    PLANES_BUILD_COUNTS["build"] += 1
    cache[ckey] = planes = build()
    return planes


def _normalize_horizons(spec: SketchSpec, lasts):
    """A horizon sweep's sorted unique clamped horizons (``None -> k``,
    ``min(int(h), k)``) and, per user position, its row among them.
    Returns ``(uniq, sel)``."""
    k = spec.config.effective_k
    hs = [k if h is None else min(int(h), k) for h in lasts]
    uniq = tuple(sorted(set(hs)))
    return uniq, [uniq.index(h) for h in hs]


def query_planes_multi(spec: SketchSpec, state: ShardedState, lasts):
    """The horizon-stacked ``MultiPlanes`` for every horizon in ``lasts``,
    built in one pass over the ring and memoized as one LRU entry keyed
    ``("multi", uniq)``. Returns ``(planes, uniq)``: row ``i`` is horizon
    ``uniq[i]`` (``_normalize_horizons``)."""
    shards = state.live()
    uniq, _ = _normalize_horizons(spec, lasts)
    return _cached(state, ("multi", uniq), lambda: _q.build_query_planes_multi(
        spec.config, _with_global_window(shards), uniq)), uniq


def clear_plane_cache(state: ShardedState) -> None:
    """Drop the planes memoized on a handle (frees their device memory;
    never needed for correctness)."""
    setattr(state, _PLANES_ATTR, None)


def _per_shard(shards, fn):
    """Sum of ``fn(one shard's state)`` over the stack (the scan path)."""
    S = shards.leaves()[0].shape[0]
    total = None
    for s in range(S):
        part = fn(shards.map(lambda x: x[s])).to(torch.int64)
        total = part if total is None else total + part
    return total.to(torch.int32)


def _answer_planes(cfg, planes, q: QueryBatch, arrays, with_le: bool):
    """The kernel route on one horizon's planes: int32 [B] (padded)."""
    from repro_torch.kernels.sketch_query.ops import edge_query_planes
    from repro_torch.kernels.vertex_scan.ops import (
        label_aggregate_planes, vertex_query_planes)
    if q.kind == "edge":
        src, dst, la, lb, les = arrays
        w, wl = edge_query_planes(cfg, planes, src, dst, (la, lb, les),
                                  with_le=with_le)
    elif q.kind == "vertex":
        v, lv, les = arrays
        w, wl = vertex_query_planes(cfg, planes, v, (lv, les),
                                    direction=q.direction, with_le=with_le)
    else:
        lv, les = arrays
        w, wl = label_aggregate_planes(cfg, planes, lv, edge_label=les,
                                       direction=q.direction,
                                       with_le=with_le)
    return (wl if with_le else w).sum(0, dtype=torch.int64).to(torch.int32)


def _query_multi(spec: SketchSpec, state: ShardedState, q: QueryBatch,
                 path: str) -> torch.Tensor:
    """A horizon sweep: int32 [H, B], rows in the order the user listed
    the horizons (duplicates and ``None`` allowed)."""
    lasts = list(q.last)
    if not lasts:
        raise ValueError("multi-horizon query needs at least one horizon")
    path = resolve_query_path(path, state.device, spec.kind)
    if spec.kind == "gss":  # no window: one answer serves every horizon
        out = query(spec, state, dataclasses.replace(q, last=None),
                    path=path)
        return out[None].expand((len(lasts),) + out.shape)
    if path == "scan":
        return torch.stack([query(spec, state, dataclasses.replace(
            q, last=None if h is None else int(h)), path=path)
            for h in lasts])
    _, sel = _normalize_horizons(spec, lasts)
    planes, uniq = query_planes_multi(spec, state, lasts)
    arrays, with_le, _, n = normalize_query(
        dataclasses.replace(q, last=None), state.device, spec.kind)
    if q.kind == "edge":  # every horizon in one launch: [H, B]
        from repro_torch.kernels.sketch_query.ops import edge_query_planes
        src, dst, la, lb, les = arrays
        w, wl = edge_query_planes(spec.config, planes, src, dst,
                                  (la, lb, les), with_le=with_le)
        rows = wl if with_le else w
    else:
        rows = [_answer_planes(spec.config, _q.slice_horizon(planes, i), q,
                               arrays, with_le) for i in range(len(uniq))]
    return torch.stack([rows[i][:n] for i in sel])


def query(spec: SketchSpec, state: ShardedState, q: QueryBatch,
          path: str = "auto") -> torch.Tensor:
    """Answer a QueryBatch against a sharded handle (or a plain
    single-shard state): int32 [B] on the state's device, or int32 [H, B]
    for a list ``last`` (row ``i`` equal to ``last=q.last[i]``)."""
    if not isinstance(state, ShardedState):
        state = ShardedState.lift(state)
    if isinstance(q.last, (list, tuple)):
        return _query_multi(spec, state, q, path)
    shards = state.live()
    cfg = spec.config
    path = resolve_query_path(path, state.device, spec.kind)
    arrays, with_le, last, n = normalize_query(q, state.device, spec.kind)

    if path == "cuda":
        planes = query_planes(spec, state, last)
        return _answer_planes(cfg, planes, q, arrays, with_le)[:n]

    glob = _with_global_window(shards)
    if spec.kind == "lgs":
        if q.kind == "edge":
            src, dst, la, lb, les = arrays

            def one(st):
                return _lgs_edge_query(cfg, st, src, dst, la, lb, les,
                                       with_le, last)
        else:
            v, lv, les = arrays

            def one(st):
                return _lgs_vertex_query(cfg, st, v, lv, les, with_le,
                                         q.direction, last)
    elif q.kind == "edge":
        src, dst, la, lb, les = arrays

        def one(st):
            w, wl = _q.edge_query(cfg, st, src, dst, (la, lb, les),
                                  with_le, last)
            return wl if with_le else w
    elif q.kind == "vertex":
        v, lv, les = arrays

        def one(st):
            w, wl = _q.vertex_query(cfg, st, v, (lv, les),
                                    direction=q.direction,
                                    with_edge_label=with_le, last=last)
            return wl if with_le else w
    else:
        lv, les = arrays

        def one(st):
            w, wl = _q.vertex_label_aggregate(
                cfg, st, lv, direction=q.direction, with_edge_label=with_le,
                last=last, edge_label=les if with_le else None)
            return wl if with_le else w
    return _per_shard(glob, one)[:n]
