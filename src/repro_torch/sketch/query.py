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
  * ``path="collective"`` — the mesh-resident path: on a handle ``place``
    laid over a process group that divides its shard count, each rank
    answers against its own block of window-reduced planes (a plane cache
    of its own, keyed ``("collective", h)``) through the same kernels, and
    the shard partials reduce across the ranks (``core.merge.psum_partials``
    for counts, an ``all_gather`` of rows for top-k). Every rank gets the
    fleet answer.
  * ``"auto"`` is ``"cuda"`` for a CUDA state and ``"scan"`` for a CPU one;
    ``"pallas"``, the reference's name, is ``"cuda"``.

On a mesh-resident handle ``"scan"`` and ``"cuda"`` answer the fleet on
every rank too, through the same reduction. Every plane build, delta fold
and scan answer on such a handle runs under the fleet's newest subwindow
index, max-reduced across the ranks first, and a delta chain folds only
when every link held on every rank. Every rank must then ask the same
queries in the same order, as it ingests the same batches.

Every shard queries under the fleet-wide newest subwindow index (a
lagging shard must not count ring slots the combined stream expired); a
pooled handle's planes (``groups=``) lift it per tenant block instead.
The planes are memoized on the handle object, keyed by the clamped
horizon ``min(last or k, k)``, in a small LRU (``PLANES_CACHE_CAP``);
ingest returns a new handle, so the cache is never stale. A miss is
served, in this order, by a horizon-stacked entry that covers the
horizon (a slice, no build), by folding the flush deltas that ingest
hung on the handle into the parent handle's planes (``PlanesDelta``, up
to ``MAX_DELTA_CHAIN`` links, one device read a link), and only then by
a build. Query batches are padded to power-of-two buckets with the
``EMPTY`` sentinel; pad rows are sliced off.

A ``gss`` query drops its labels and its window (``normalize_query``); an
``lgs`` query always takes the scan (count-min cells: no keyed walk, no
planes), and an ``lgs`` label aggregate raises. A plain single-shard
state (an object's ``.state``) is accepted and lifted to a fresh 1-shard
handle over views of its tensors, so its planes live for one call; the
objects pass their own handle, whose cache lives until their next insert.
``PLANES_BUILD_COUNTS`` counts the cache misses in the process.

A list ``last`` is a horizon sweep: ``int32 [H, B]`` out, row ``i`` equal
to ``last=lasts[i]``. ``"scan"`` loops the single-horizon reference;
``"cuda"`` answers every row from one horizon-stacked ``MultiPlanes``
build (one cache entry keyed ``("multi", horizons)``) through the same
kernels: an edge sweep in one launch of the fused edge kernel, the other
kinds one horizon at a time. One flush delta folds into every horizon
of such an entry at once.
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
from repro_torch.core.merge import pmax, psum
from repro_torch.core.types import EMPTY
from repro_torch.engine.window import bucket_size
from repro_torch.telemetry.spans import span

from .spec import SketchSpec
from .state import ShardedState, mesh_context, split_context

PLANES_CACHE_CAP = 8
# the longest chain of un-queried flushes a handle folds before it
# rebuilds instead: N links cost N folds at the next query, and past a few
# one build is cheaper and frees the links' buffers
MAX_DELTA_CHAIN = 8
_PLANES_ATTR = "_query_planes_cache"
_PENDING_ATTR = "_planes_pending"
# plane-cache misses in the process: "build" full builds, "delta" misses
# served by folding pending flush deltas into the parent's planes,
# "evict" LRU drops; "build-multi" and "delta-multi" are the
# horizon-stacked entries' share of the first two
PLANES_BUILD_COUNTS = {"build": 0, "delta": 0, "evict": 0,
                       "build-multi": 0, "delta-multi": 0}


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


def default_query_path(device=None) -> str:
    """The kernel route for a state on the card, the dense scan on the
    CPU."""
    return "cuda" if torch.device(device or "cpu").type == "cuda" \
        else "scan"


def resolve_query_path(path: str = "auto", device=None,
                       kind: str = "lsketch") -> str:
    """Normalize a query path name to "scan" | "cuda" | "collective"
    ("pallas" is "cuda"); an ``lgs`` sketch always takes "scan". A
    collective query's handle is checked where it is in hand
    (``_collective_ctx``)."""
    if path == "auto":
        path = default_query_path(device)
    if path == "pallas":
        path = "cuda"
    if path not in ("scan", "cuda", "collective"):
        raise ValueError(f"unknown query path {path!r}")
    return "scan" if kind == "lgs" else path


def _collective_ctx(spec: SketchSpec, state):
    """The ``MeshContext`` a collective query runs under; raises unless
    the handle is mesh-resident and its group divides the shard count."""
    ctx = mesh_context(state) if isinstance(state, ShardedState) else None
    if ctx is None:
        raise ValueError(
            "path='collective' needs a mesh-resident handle: lay the shard "
            "axis over a process group with repro_torch.sketch.place(...) "
            "(or attach an existing layout with with_mesh(...)) first")
    if not ctx.divides(spec.n_shards):
        raise ValueError(
            f"path='collective' needs the mesh axis to divide the shard "
            f"count (the rank blocks must be uniform): n_shards="
            f"{spec.n_shards} over {ctx.n_devices} devices on axis "
            f"{ctx.axis!r} is replicated, not sharded — use the host "
            "fan-out paths (scan/cuda) or repartition")
    return ctx


def _group_of(ctx):
    """The process group a split handle's answers reduce over, or None."""
    return None if ctx is None else ctx.group


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


def _with_group_window(shards, groups: int = 1, group=None):
    """A view of the stack in which every shard carries its window group's
    newest subwindow index (the handle's own tensors are not touched).
    One group is a plain sharded handle: the fleet reconciles to one
    ``cur_widx``, max-reduced over the ranks of ``group`` when the stack
    is one rank's block of a split handle. A pooled handle
    (``sketch.tenant``) stacks ``groups`` tenants' shard blocks; each
    block reconciles only within itself, as ``groups`` independent
    handles would."""
    cw = shards.cur_widx
    per = cw.shape[0] // groups
    g = cw.reshape(groups, per).amax(dim=1, keepdim=True)
    if group is not None:
        g = pmax(g.contiguous(), group)
    return dataclasses.replace(shards,
                               cur_widx=g.expand(groups, per).reshape(-1))


def _with_global_window(shards, group=None):
    """Every shard under the fleet-wide newest subwindow index."""
    return _with_group_window(shards, 1, group)


def _cache(state: ShardedState) -> OrderedDict:
    cache = getattr(state, _PLANES_ATTR, None)
    if cache is None:
        cache = OrderedDict()
        setattr(state, _PLANES_ATTR, cache)
    return cache


def _cache_put(cache: OrderedDict, ckey, planes) -> None:
    """Insert as most recent; evict the least recent past the cap."""
    cache.pop(ckey, None)
    while len(cache) >= PLANES_CACHE_CAP:
        cache.popitem(last=False)
        PLANES_BUILD_COUNTS["evict"] += 1
    cache[ckey] = planes


def _multi_horizons_of(ckey, mkey):
    """The horizons of stacked entry ``mkey`` if it is the family of the
    single-horizon key ``ckey``, else None. The families pair ``horizon``
    with ``("multi", hs)``, ``("collective", h)`` with
    ``("multi-collective", hs)`` and ``("pooled", g, h)`` with
    ``("multi-pooled", g, hs)``."""
    if not isinstance(mkey, tuple):
        return None
    if isinstance(ckey, int):
        return mkey[1] if mkey[0] == "multi" else None
    if ckey[0] == "collective":
        return mkey[1] if mkey[0] == "multi-collective" else None
    if ckey[0] == "pooled" and mkey[0] == "multi-pooled" \
            and mkey[1] == ckey[1]:
        return mkey[2]
    return None


def _multi_slice_hit(cache: OrderedDict, ckey, horizon: int):
    """A single-horizon miss served by the most recent stacked entry of
    its family that covers ``horizon``: its row, with no build and no fold
    (neither count moves); the hit refreshes the entry's recency."""
    for mkey in reversed(list(cache)):
        hs = _multi_horizons_of(ckey, mkey)
        if hs is not None and horizon in hs:
            cache.move_to_end(mkey)
            return _q.slice_horizon(cache[mkey], hs.index(horizon))
    return None


def planes_delta_base(state: ShardedState):
    """The ``(base planes, prior delta chain)`` the next flush into
    ``state`` should extend, or None when the handle holds nothing a delta
    could keep warm (then the flush records no delta at all: a handle
    that was never queried ingests with no delta work). Called by
    ``sketch.ingest`` on the handle it is about to consume."""
    cache = getattr(state, _PLANES_ATTR, None)
    if cache:  # resolved planes on this handle: one fresh link suffices
        return dict(cache), []
    pend = getattr(state, _PENDING_ATTR, None)
    if pend is not None and len(pend[1]) < MAX_DELTA_CHAIN:
        return pend
    return None


def attach_planes_delta(state: ShardedState, base: dict, chain: list,
                        delta) -> None:
    """Hang ``(base planes, chain + [delta])`` on a fresh ingest handle;
    ``query_planes`` folds it on the handle's first miss."""
    setattr(state, _PENDING_ATTR, (base, chain + [delta]))


def _resolve_pending(state: ShardedState, ckey, apply_one, group=None):
    """Serve a miss by folding the handle's pending flush deltas into the
    parent's cached entry ``ckey``: the planes, or None when the parent
    never cached ``ckey`` or a link's flush moved the ring on some row
    (reset a slot, advanced the window or spanned subwindows; the chain is
    then useless for every horizon and is dropped). One device read for
    the chain (its links' ``ok``), paid on the first query of the handle;
    on a split handle ``ok`` is min-reduced over the ranks of ``group``
    first, so every rank folds or every rank builds. The base's counter
    planes own their storage; its key planes are never read."""
    pend = getattr(state, _PENDING_ATTR, None)
    if pend is None:
        return None
    base, deltas = pend
    if ckey not in base:
        return None
    with span("lsketch.planes.resolve"):
        moved = (~torch.stack([d.ok.all() for d in deltas]).all()).to(
            torch.int32).reshape(1)
        if group is not None:  # one rank's moved ring moves the fleet's
            moved = pmax(moved, group)
        moved = bool(moved)
    if moved:
        setattr(state, _PENDING_ATTR, None)
        return None
    planes = base[ckey]
    # every link ok: the ring never moved across the chain, so every
    # link's mask is the final state's; fold them all under it
    for d in deltas:
        with span("lsketch.planes.fold"):
            planes = apply_one(planes, d)
    PLANES_BUILD_COUNTS["delta"] += 1
    return planes


def _lookup(state: ShardedState, ckey, fold, build,
            hit=lambda cache: None, group=None):
    """The handle's entry ``ckey``: a hit; else, on a miss, ``hit(cache)``
    (a covering stacked entry's row), then the pending chain folded by
    ``fold(planes, delta)``, then ``build()``. Returns ``(planes, how)``,
    ``how`` in "hit", "slice", "delta", "build"."""
    cache = _cache(state)
    if ckey in cache:
        cache.move_to_end(ckey)
        return cache[ckey], "hit"
    how, planes = "slice", hit(cache)
    if planes is None:
        how, planes = "delta", _resolve_pending(state, ckey, fold, group)
    if planes is None:
        PLANES_BUILD_COUNTS["build"] += 1
        with span("lsketch.planes.build"):
            how, planes = "build", build()
    _cache_put(cache, ckey, planes)
    return planes, how


def _planes_ctx(spec: SketchSpec, state: ShardedState, collective: bool,
                groups: int):
    """The context a plane build of this handle reduces its window over
    (None when this rank holds every row), checked for the path."""
    if collective and groups != 1:
        raise ValueError("pooled (grouped) planes are host-resident: "
                         "collective=True requires groups=1")
    if collective:
        return _collective_ctx(spec, state)
    return split_context(spec, state)


def query_planes(spec: SketchSpec, state: ShardedState, last=None, *,
                 collective: bool = False, groups: int = 1):
    """The window-reduced ``QueryPlanes`` for ``(state, last)``, memoized on
    the handle object in an LRU of ``PLANES_CACHE_CAP`` entries keyed by
    the clamped horizon (``last=None`` and ``last>=k`` share one entry).
    A miss takes a covering horizon-stacked entry's row, then the pending
    delta chain, then a build. With ``groups > 1`` (a pooled handle) each
    of the ``groups`` blocks of rows lifts its window on its own, and the
    entry is keyed ``("pooled", groups, horizon)``. With
    ``collective=True`` (a mesh-resident handle) the planes are this
    rank's block's, under the fleet window, keyed ``("collective",
    horizon)`` apart from the host entries; on a split handle the host
    entries are the rank's block's too."""
    shards = state.live()
    ctx = _planes_ctx(spec, state, collective, groups)
    group = _group_of(ctx)
    k = spec.config.effective_k
    horizon = k if last is None else min(int(last), k)
    ckey = ("collective", horizon) if collective else \
        horizon if groups == 1 else ("pooled", groups, horizon)
    return _lookup(
        state, ckey,
        lambda pl, d: _q.apply_planes_delta(
            spec.config, _with_group_window(shards, groups, group), pl, d,
            horizon),
        lambda: _q.build_query_planes(
            spec.config, _with_group_window(shards, groups, group), horizon),
        lambda cache: _multi_slice_hit(cache, ckey, horizon), group)[0]


def _normalize_horizons(spec: SketchSpec, lasts):
    """A horizon sweep's sorted unique clamped horizons (``None -> k``,
    ``min(int(h), k)``) and, per user position, its row among them.
    Returns ``(uniq, sel)``."""
    k = spec.config.effective_k
    hs = [k if h is None else min(int(h), k) for h in lasts]
    uniq = tuple(sorted(set(hs)))
    return uniq, [uniq.index(h) for h in hs]


def query_planes_multi(spec: SketchSpec, state: ShardedState, lasts, *,
                       collective: bool = False, groups: int = 1):
    """The horizon-stacked ``MultiPlanes`` for every horizon in ``lasts``,
    built in one pass over the ring and memoized as one LRU entry keyed
    ``("multi", uniq)`` (``("multi-pooled", groups, uniq)`` with the
    per-group window lift of a pooled handle, ``("multi-collective",
    uniq)`` with ``collective=True``); a miss folds the pending delta
    chain into every horizon at once before it builds. Returns
    ``(planes, uniq)``: row ``i`` is horizon ``uniq[i]``
    (``_normalize_horizons``)."""
    shards = state.live()
    ctx = _planes_ctx(spec, state, collective, groups)
    group = _group_of(ctx)
    uniq, _ = _normalize_horizons(spec, lasts)
    ckey = ("multi-collective", uniq) if collective else \
        ("multi", uniq) if groups == 1 else ("multi-pooled", groups, uniq)
    planes, how = _lookup(
        state, ckey,
        lambda pl, d: _q.apply_planes_delta_multi(
            spec.config, _with_group_window(shards, groups, group), pl, d,
            uniq),
        lambda: _q.build_query_planes_multi(
            spec.config, _with_group_window(shards, groups, group), uniq),
        group=group)
    if how in ("build", "delta"):
        PLANES_BUILD_COUNTS[how + "-multi"] += 1
    return planes, uniq


def clear_plane_cache(state: ShardedState) -> None:
    """Drop the planes memoized on a handle and any pending delta chain
    (frees their device memory; never needed for correctness)."""
    setattr(state, _PLANES_ATTR, None)
    setattr(state, _PENDING_ATTR, None)


def _per_shard(shards, fn):
    """Sum of ``fn(one shard's state)`` over the stack (the scan path)."""
    S = shards.leaves()[0].shape[0]
    total = None
    for s in range(S):
        part = fn(shards.map(lambda x: x[s])).to(torch.int64)
        total = part if total is None else total + part
    return total.to(torch.int32)


def _answer_planes(cfg, planes, q: QueryBatch, arrays, with_le: bool,
                   group=None):
    """The kernel route on one horizon's planes: int32 [B] (padded), this
    rank's rows' sum, reduced over ``group`` when it is given."""
    from repro_torch.kernels.sketch_query.ops import edge_query_planes
    from repro_torch.kernels.vertex_scan.ops import (
        label_aggregate_planes, vertex_query_planes)
    if q.kind == "edge":
        src, dst, la, lb, les = arrays
        w, wl = edge_query_planes(cfg, planes, src, dst, (la, lb, les),
                                  with_le=with_le, group=group)
    elif q.kind == "vertex":
        v, lv, les = arrays
        w, wl = vertex_query_planes(cfg, planes, v, (lv, les),
                                    direction=q.direction, with_le=with_le,
                                    group=group)
    else:
        lv, les = arrays
        w, wl = label_aggregate_planes(cfg, planes, lv, edge_label=les,
                                       direction=q.direction,
                                       with_le=with_le, group=group)
    out = wl if with_le else w
    if group is not None:  # already reduced over the rows and the ranks
        return out
    return out.sum(0, dtype=torch.int64).to(torch.int32)


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
    collective = path == "collective"
    planes, uniq = query_planes_multi(spec, state, lasts,
                                      collective=collective)
    group = _group_of(_collective_ctx(spec, state) if collective
                      else split_context(spec, state))
    arrays, with_le, _, n = normalize_query(
        dataclasses.replace(q, last=None), state.device, spec.kind)
    if q.kind == "edge":  # every horizon in one launch: [H, B]
        from repro_torch.kernels.sketch_query.ops import edge_query_planes
        src, dst, la, lb, les = arrays
        w, wl = edge_query_planes(spec.config, planes, src, dst,
                                  (la, lb, les), with_le=with_le,
                                  group=group)
        rows = wl if with_le else w
    else:  # one horizon at a time, the [H, B] rows reduced at once
        rows = torch.stack([_answer_planes(
            spec.config, _q.slice_horizon(planes, i), q, arrays, with_le)
            for i in range(len(uniq))])
        if group is not None:
            rows = psum(rows, group)
    return torch.stack([rows[i][:n] for i in sel])


def _host_i32(x, n: int | None = None) -> np.ndarray:
    """``as_i32`` on the host: an int32 numpy array, broadcast to ``n``."""
    a = np.atleast_1d(np.asarray(
        x.cpu() if isinstance(x, torch.Tensor) else x, np.int32))
    return a if n is None or a.shape[0] == n else np.broadcast_to(a, (n,))


def _horizon_index(spec: SketchSpec, q: QueryBatch, uniq) -> int:
    """The row of ``q``'s clamped horizon among ``uniq`` (a ``gss``
    query has no window: the full one)."""
    k = spec.config.effective_k
    last = None if spec.kind == "gss" else q.last
    return uniq.index(k if last is None else min(int(last), k))


def _rows(spec: SketchSpec, q: QueryBatch):
    """One batch's ``normalize_query`` columns on the host, unpadded, the
    edge label 0 where it has none: ``(columns, with_le, n)``."""
    gss = spec.kind == "gss"
    if q.kind == "edge":
        src, dst = _host_i32(q.src), _host_i32(q.dst)
        n = max(src.shape[0], dst.shape[0])
        main, lab = [_host_i32(src, n), _host_i32(dst, n)], \
            [q.src_label, q.dst_label]
    elif q.kind == "vertex":
        main = [_host_i32(q.vertex)]
        n, lab = main[0].shape[0], [q.vertex_label]
    elif q.kind == "label":
        if spec.kind == "lgs":
            raise NotImplementedError(
                "LGS stores no label blocks; label aggregates need "
                "LSketch/GSS")
        main, lab = [], [q.vertex_label]
        n = _host_i32(q.vertex_label).shape[0]
    else:
        raise ValueError(f"unknown query kind {q.kind!r}")
    with_le = q.edge_label is not None and not gss
    lab = [np.zeros(n, np.int32) if gss else _host_i32(x, n) for x in lab]
    le = _host_i32(q.edge_label, n) if with_le else np.zeros(n, np.int32)
    return main + lab + [le], with_le, n


def _pack_pass(spec: SketchSpec, qs, uniq, H: int, device):
    """Every row of the batches ``qs`` (one kind), in their order, on the
    device in one copy. Returns ``(host, columns, sel, has, counts)``:
    ``columns`` as ``normalize_query`` makes them, bucket-padded with
    ``EMPTY`` over the whole pass; ``sel`` each row's index into the
    pass's flattened ``[2, H, B]`` (edges: w then w_label, horizon,
    padded row) or ``[2, rows]`` (w then w_label) answers; ``host`` the
    columns on the host, unpadded; ``has`` (host) whether a row carries
    an edge label; ``counts`` each batch's rows."""
    got = [_rows(spec, q) for q in qs]
    counts = [n for _, _, n in got]
    n = sum(counts)
    has = np.concatenate([np.full(c, w) for _, w, c in got])
    to = bucket_size(n, floor=32)
    if qs[0].kind == "edge":
        hi = np.concatenate([np.full(c, _horizon_index(spec, q, uniq))
                             for q, c in zip(qs, counts)])
        sel = (has * H + hi) * to + np.arange(n)
    else:
        sel = has * n + np.arange(n)
    packed = np.full((len(got[0][0]) + 1, to), EMPTY, np.int32)
    for j in range(len(got[0][0])):
        packed[j, :n] = np.concatenate([cols[j] for cols, _, _ in got])
    packed[-1, :n] = sel
    dev = torch.from_numpy(packed).to(device)
    return packed[:-1, :n], list(dev[:-1]), dev[-1, :n], has, counts


def _runs(spec: SketchSpec, qs, uniq):
    """The batches ``qs`` (vertex or label) stably ordered by (direction,
    horizon), and that order's runs: ``(order, [(direction, h, first,
    end)])`` in positions of the order."""
    key = [(q.direction, _horizon_index(spec, q, uniq)) for q in qs]
    order = sorted(range(len(qs)), key=lambda i: key[i])
    runs = []
    for j, i in enumerate(order):
        if runs and runs[-1][:2] == list(key[i]):
            runs[-1][3] = j + 1
        else:
            runs.append([*key[i], j, j + 1])
    return order, runs


def _answer_pass(spec: SketchSpec, planes_of, H: int, qs, uniq,
                 device) -> list:
    """One kind's pass over the batches ``qs``: each batch's answers, int32
    ``[n]`` views of the pass's one answer tensor."""
    from repro_torch.core import hashing as hsh
    from repro_torch.kernels.sketch_query.ops import edge_query_planes
    from repro_torch.kernels.vertex_scan.ops import (
        label_aggregate_planes, label_weight_planes, scan_lines,
        vertex_scan_planes)
    cfg, kind = spec.config, qs[0].kind
    order, runs = (list(range(len(qs))), None) if kind == "edge" else \
        _runs(spec, qs, uniq)
    qs = [qs[i] for i in order]
    with span("lsketch.query.prepare"):
        host, cols, sel, has, counts = _pack_pass(spec, qs, uniq, H,
                                                  device)
        at = np.cumsum([0] + counts)
        planes = planes_of(None) if kind == "edge" else \
            {h: planes_of(h) for _, h, _, _ in runs}
    with span("lsketch.query.answer"):
        if kind == "edge":  # every row at every horizon: [2, H, B]
            src, dst, la, lb, le = cols
            both = torch.stack(edge_query_planes(
                cfg, planes, src, dst, (la, lb, le),
                with_le=bool(has.any())))
            if H == 1:  # [2, S, B] shard partials
                both = both.sum(1, dtype=torch.int64).to(torch.int32)
        else:  # one addressing, then a scan or a reduction a run
            if kind == "vertex":
                pre, lines = scan_lines(cfg, cols[0], cols[1])
                le_idx = hsh.edge_label_bucket(cols[-1], cfg.c, cfg.seed) \
                    if has.any() else None
            parts = []
            for direction, h, a, b in runs:
                r = slice(int(at[a]), int(at[b]))
                if kind == "vertex":
                    parts.append(vertex_scan_planes(
                        cfg, planes[h], lines[r], pre.f[r], pre.vid[r],
                        None if le_idx is None else le_idx[r], direction))
                else:
                    w, wl = label_aggregate_planes(cfg, planes[h],
                                                   cols[0][r],
                                                   direction=direction)
                    if has[r].any():  # unlabelled rows borrow a labelled
                        # row's labels: their w_label is not read
                        i = np.where(has[r], np.arange(r.stop - r.start),
                                     has[r].argmax())
                        wl = label_weight_planes(
                            cfg, planes[h], host[0][r][i], host[-1][r][i],
                            direction)
                    parts.append((w, wl))
            both = torch.stack([torch.cat(x, 1) for x in zip(*parts)]).sum(
                1, dtype=torch.int64).to(torch.int32)  # [2, rows]
        ans = both.reshape(-1).index_select(0, sel)
    got = [ans[at[j]:at[j + 1]] for j in range(len(qs))]
    back = [None] * len(qs)
    for j, i in enumerate(order):
        back[i] = got[j]
    return back


def query_many(spec: SketchSpec, state: ShardedState, batches,
               path: str = "auto", horizons=()) -> list:
    """Answer several ``QueryBatch``es against one handle: one device
    tensor a batch, each equal to ``query(spec, state, batch, path)``.

    On the ``"cuda"`` route of a handle this process holds whole, the
    batches are answered by kind, in one pass a kind whatever their edge
    labels, horizons and directions, from the planes of every horizon
    they ask plus ``horizons`` (one horizon-stacked entry, the one a
    server's prewarm builds for the same list):

      * edges: one launch of the edge kernel over every row at every
        horizon (the edge label 0 where a batch has none), then each row
        picks its (horizon, ``w`` or ``w_label``) in one gather;
      * vertices: one addressing of every row, then one scan and pool
        lookup a (direction, horizon) present;
      * labels: one reduction of the weight planes a (direction,
        horizon) present, and, for the rows with an edge label, one
        block of one label plane a distinct (block, bucket) pair.

    Each pass marks ``query.prepare`` (its rows on the device in one
    copy, the plane lookup) and ``query.answer``. On the other paths, on
    a split handle and for a horizon sweep, each batch takes ``query``."""
    if not isinstance(state, ShardedState):
        state = ShardedState.lift(state)
    path = resolve_query_path(path, state.device, spec.kind)
    whole = path == "cuda" and split_context(spec, state) is None
    out = [None] * len(batches)
    fused = {}
    for i, q in enumerate(batches):
        if whole and not isinstance(q.last, (list, tuple)):
            fused.setdefault(q.kind, []).append(i)
        else:
            out[i] = query(spec, state, q, path=path)
    if not fused:
        return out
    gss = spec.kind == "gss"
    lasts = [None if gss else batches[i].last
             for ids in fused.values() for i in ids] + list(horizons)
    uniq, _ = _normalize_horizons(spec, lasts)
    H = len(uniq)
    multi = {}

    def planes_of(h):
        """Horizon index ``h``'s planes; None: every horizon's, stacked
        where there are several."""
        if H == 1:
            return query_planes(spec, state, uniq[0])
        if "p" not in multi:
            multi["p"] = query_planes_multi(spec, state, list(uniq))[0]
        return multi["p"] if h is None else \
            _q.slice_horizon(multi["p"], h)

    for ids in fused.values():
        got = _answer_pass(spec, planes_of, H, [batches[i] for i in ids],
                           uniq, state.device)
        for i, x in zip(ids, got):
            out[i] = x
    return out


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
    with span("lsketch.query.prepare"):
        arrays, with_le, last, n = normalize_query(q, state.device,
                                                   spec.kind)
        planes = None
        if path == "collective":
            group = _collective_ctx(spec, state).group
            planes = query_planes(spec, state, last, collective=True)
        else:
            group = _group_of(split_context(spec, state))
            if path == "cuda":
                planes = query_planes(spec, state, last)
    if planes is not None:
        with span("lsketch.query.answer"):
            return _answer_planes(cfg, planes, q, arrays, with_le,
                                  group)[:n]

    glob = _with_global_window(shards, group)
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
    with span("lsketch.query.answer"):
        out = _per_shard(glob, one)
        return (out if group is None else psum(out, group))[:n]
