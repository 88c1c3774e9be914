"""TenantPool — many same-spec sketches behind one stacked handle (port of
``repro.sketch.tenant``: ``TenantPool`` and ``PoolFullError``).

``n_slots`` tenants' shard stacks are packed on the leading axis of one
``ShardedState`` with ``n_slots * n_shards`` rows::

    pooled row = slot * n_shards + routed_assignment(tenant_spec, ...)

so a tenant's block of rows receives exactly the rows a standalone
``n_shards`` handle would hold, in the same order, and every pooled answer
equals the tenant's standalone sketch bit for bit. Tenants run on their
own clocks: the planes lift ``cur_widx`` per tenant block
(``query._with_group_window``), never across tenants.

Ingest reuses ``ingest._dispatch_stacked`` on the pool spec: one stacked
insert a round for every tenant, and the flush deltas keep the pooled
planes (keys ``("pooled", n_slots, h)`` / ``("multi-pooled", ...)``).
The kernel route needs every row's valid items in one subwindow of that
row's own clock; a round with a row that straddles a boundary takes the
scan. ``submit``/``flush`` keep ``AsyncIngestor``'s one-round stagger.
Within a tenant, batches apply in submission order; across tenants rows
are disjoint, and tenants are laid out by slot so the dispatch does not
depend on the caller's order.

Reads are one dispatch for many tenants: ``query_many`` packs each
tenant's queries into row ``slot`` of host ``[n_slots, Lq]`` grids
(``EMPTY`` padding) and copies each field to the card once. On
``path="cuda"`` the grouped entries of the edge-probe and vertex-scan
kernels answer each tenant's row against its own block of shard rows
only, and the label reduction and the pool lookup do the same as
``[G, S / G, Lq, ...]``; ``path="scan"`` runs the dense reference per
shard row against its own tenant's row. ``top_k_many`` decodes every
row's owners in one launch and ranks each tenant's block alone.

Admission: a tenant is attached (owns a slot) or evicted (its rows live in
a checkpoint under ``directory/tenant-<id>``, the id in the manifest's
``extra``). ``attach`` restores an evicted tenant's checkpoint into a
free slot, any free slot (routing is slot-relative); a full pool evicts
its least recently used tenant (needs ``directory``) or raises
``PoolFullError``. Slot surgery writes the pooled tensors in place and
hands out a fresh handle, so no cached planes outlive it.
``path="collective"`` is not supported on a pool.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core import queries as _q
from repro_torch.core.lgs import _lgs_edge_query, _lgs_vertex_query
from repro_torch.core.types import EMPTY, EdgeBatch
from repro_torch.engine.window import bucket_size

from . import checkpoint as _ckpt
from .analytics import grouped_top_k
from .ingest import _FIELDS, _degenerate_batch, _dispatch_stacked, \
    _shard_bucket
from .query import QueryBatch, _with_group_window, query_planes, \
    query_planes_multi, resolve_query_path
from .routing import routed_assignment
from .spec import SketchSpec
from .state import ShardedState, _init, create


class PoolFullError(RuntimeError):
    """Raised by ``attach`` when every slot is taken and the pool has no
    checkpoint directory to evict cold tenants into."""


# --------------------------------------------------------------------------
# query-batch combination — many (tenant, QueryBatch) pairs, one dispatch
# --------------------------------------------------------------------------

def _batch_len(q: QueryBatch) -> int:
    if q.kind == "edge":
        return max(np.atleast_1d(np.asarray(q.src)).shape[0],
                   np.atleast_1d(np.asarray(q.dst)).shape[0])
    if q.kind == "vertex":
        return np.atleast_1d(np.asarray(q.vertex)).shape[0]
    return np.atleast_1d(np.asarray(q.vertex_label)).shape[0]


def _cat_field(vals, lens):
    """One optional per-pair field concatenated, scalars broadcast to
    their pair's row count; all-None stays None (no edge label)."""
    if all(v is None for v in vals):
        return None
    if any(v is None for v in vals):
        raise ValueError(
            "pooled query batches must agree on edge_label presence "
            "(with_le is a static axis of the pooled dispatch)")
    return np.concatenate([
        np.broadcast_to(np.atleast_1d(np.asarray(v, np.int32)), (n,))
        for v, n in zip(vals, lens)])


def _np_i32(x, n: int | None = None):
    a = np.atleast_1d(np.asarray(x, np.int32))
    if n is not None and a.shape[0] != n:
        a = np.broadcast_to(a, (n,))
    return a


def _np_query_rows(spec, q: QueryBatch):
    """Numpy twin of ``query.normalize_query`` without the bucket pad:
    int32, scalars broadcast, a ``gss`` query without labels, edge label
    and window, an ``lgs`` label aggregate refused. Returns ``(arrays,
    with_le, last, n)`` with unpadded arrays."""
    gss = spec.kind == "gss"
    le, last = (None, None) if gss else (q.edge_label, q.last)
    with_le = le is not None

    def labels(x, n):
        return np.zeros(n, np.int32) if gss else _np_i32(x, n)

    if q.kind == "edge":
        src, dst = _np_i32(q.src), _np_i32(q.dst)
        n = max(src.shape[0], dst.shape[0])
        src, dst = _np_i32(src, n), _np_i32(dst, n)
        la, lb = labels(q.src_label, n), labels(q.dst_label, n)
        les = _np_i32(le, n) if with_le else np.zeros_like(src)
        return (src, dst, la, lb, les), with_le, last, n
    if q.kind == "vertex":
        v = _np_i32(q.vertex)
        n = v.shape[0]
        lv = labels(q.vertex_label, n)
        les = _np_i32(le, n) if with_le else np.zeros_like(v)
        return (v, lv, les), with_le, last, n
    if q.kind == "label":
        if spec.kind == "lgs":
            raise NotImplementedError(
                "LGS stores no label blocks; label aggregates need "
                "LSketch/GSS")
        n = _np_i32(q.vertex_label).shape[0]
        lv = labels(q.vertex_label, n)
        les = _np_i32(le, n) if with_le else np.zeros_like(lv)
        return (lv, les), with_le, last, n
    raise ValueError(f"unknown query kind {q.kind!r}")


def _group_queries(spec, slotted, n_slots: int, device):
    """Pack ``(slot, QueryBatch)`` pairs into ``[n_slots * Lq]`` tensors,
    row ``slot`` of each ``[n_slots, Lq]`` grid holding that slot's pairs
    in pair order, normalized as the standalone frontend would and padded
    with ``EMPTY`` to the common bucket ``Lq``; a slot with no queries is
    an all-``EMPTY`` row. The grids are made in numpy and copied to
    ``device`` once a field. kind, direction, last and edge-label
    presence must agree (they fix what the dispatch computes).

    Returns ``(arrays, with_le, last, kind, direction, spans, Lq)``;
    ``spans[i] = (slot, offset, length)`` locates pair ``i``'s answers in
    the ``[n_slots, Lq]`` output."""
    kinds = {q.kind for _, q in slotted}
    dirs = {q.direction for _, q in slotted}
    lasts = {q.last for _, q in slotted}
    if len(kinds) > 1 or len(dirs) > 1 or len(lasts) > 1:
        raise ValueError(
            f"pooled query batches must share kind/direction/last, got "
            f"kinds={sorted(kinds)} directions={sorted(dirs)} "
            f"lasts={sorted(lasts, key=repr)}")
    kind, direction = next(iter(kinds)), next(iter(dirs))
    by_slot: dict = {}
    for i, (s, _) in enumerate(slotted):
        by_slot.setdefault(s, []).append(i)
    fields = ("src", "src_label", "dst", "dst_label", "vertex",
              "vertex_label", "edge_label")
    spans: list = [None] * len(slotted)
    slot_norm: dict = {}
    with_le = last = None
    for s, idxs in by_slot.items():
        qs = [slotted[i][1] for i in idxs]
        lens = [_batch_len(q) for q in qs]
        cat = {f: _cat_field([getattr(q, f) for q in qs], lens)
               for f in fields}
        sb = QueryBatch(kind=kind, direction=direction,
                        last=next(iter(lasts)), **cat)
        arrays, wle, lst, _ = _np_query_rows(spec, sb)
        if with_le is None:
            with_le, last = wle, lst
        elif wle != with_le:
            raise ValueError(
                "pooled query batches must agree on edge_label presence "
                "(with_le is a static axis of the pooled dispatch)")
        slot_norm[s] = arrays
        off = 0
        for i, m in zip(idxs, lens):
            spans[i] = (s, off, m)
            off += m
    Lq = bucket_size(max(a[0].shape[0] for a in slot_norm.values()),
                     floor=32)
    grids = [np.full((n_slots, Lq), EMPTY, np.int32)
             for _ in next(iter(slot_norm.values()))]
    for s, arrays in slot_norm.items():
        for grid, a in zip(grids, arrays):
            grid[s, :a.shape[0]] = a
    arrays = tuple(torch.from_numpy(g.reshape(-1)).to(device) for g in grids)
    return arrays, with_le, last, kind, direction, spans, Lq


def _scan_pooled(spec, shards, arrays, kind, direction, with_le, last,
                 groups, Lq, slots):
    """The dense reference on a pooled stack: each shard row of a listed
    slot against its own tenant's query row, summed within the tenant.
    Returns int32 [groups, Lq] (rows of unlisted slots are 0)."""
    cfg = spec.config
    shards = _with_group_window(shards, groups)
    S = shards.leaves()[0].shape[0]
    per = S // groups
    out = torch.zeros((groups, Lq), dtype=torch.int64,
                      device=arrays[0].device)
    for s in range(S):
        g = s // per
        if g not in slots:
            continue
        st = shards.map(lambda x: x[s])
        a = [x[g * Lq:(g + 1) * Lq] for x in arrays]
        if spec.kind == "lgs":
            part = _lgs_edge_query(cfg, st, *a, with_le, last) \
                if kind == "edge" else _lgs_vertex_query(
                    cfg, st, *a, with_le, direction, last)
        else:
            if kind == "edge":
                src, dst, la, lb, les = a
                w, wl = _q.edge_query(cfg, st, src, dst, (la, lb, les),
                                      with_le, last)
            elif kind == "vertex":
                v, lv, les = a
                w, wl = _q.vertex_query(cfg, st, v, (lv, les),
                                        direction=direction,
                                        with_edge_label=with_le, last=last)
            else:
                lv, les = a
                w, wl = _q.vertex_label_aggregate(
                    cfg, st, lv, direction=direction,
                    with_edge_label=with_le, last=last,
                    edge_label=les if with_le else None)
            part = wl if with_le else w
        out[g] += part.to(torch.int64)
    return out.to(torch.int32)


def _cuda_pooled(spec, planes, arrays, kind, direction, with_le, groups):
    """The kernel route on pooled planes: int32 [groups, Lq], each tenant's
    row answered by its own block of rows (one grouped launch)."""
    from repro_torch.kernels.sketch_query.ops import edge_query_planes
    from repro_torch.kernels.vertex_scan.ops import (
        label_aggregate_planes, vertex_query_planes)
    cfg = spec.config
    if kind == "edge":
        src, dst, la, lb, les = arrays
        w, wl = edge_query_planes(cfg, planes, src, dst, (la, lb, les),
                                  with_le=with_le, groups=groups)
        return wl if with_le else w
    if kind == "vertex":
        v, lv, les = arrays
        w, wl = vertex_query_planes(cfg, planes, v, (lv, les),
                                    direction=direction, with_le=with_le,
                                    groups=groups)
    else:
        lv, les = arrays
        w, wl = label_aggregate_planes(cfg, planes, lv, edge_label=les,
                                       direction=direction, with_le=with_le,
                                       groups=groups)
    x = wl if with_le else w  # [S, Lq] partials
    return x.view(groups, -1, x.shape[-1]).sum(
        1, dtype=torch.int64).to(torch.int32)


# --------------------------------------------------------------------------
# the pool
# --------------------------------------------------------------------------

class TenantPool:
    """``n_slots`` same-spec tenant sketches in one stacked handle.

    ``spec`` is the per-tenant spec (``n_shards`` shards a tenant); the
    pooled handle lives under ``pool_spec`` =
    ``spec.replace(n_shards=n_slots * spec.n_shards)``, on ``device`` (the
    card unless the caller names the CPU). ``directory`` enables eviction:
    evicted tenants checkpoint under ``directory/tenant-<id>``, and
    attaching to a full pool evicts the least recently used tenant.

    Writes mirror ``AsyncIngestor``: ``submit`` stages a round of
    ``(tenant, batch)`` pairs (dispatching the round staged before),
    ``flush``/``state`` apply everything. Reads (``query``,
    ``query_many``, ``top_k``, ``top_k_many``) flush first.
    """

    def __init__(self, spec: SketchSpec, n_slots: int, *, directory=None,
                 path: str = "auto", keep: int = 3, device=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.spec = spec
        self.n_slots = int(n_slots)
        self.pool_spec = spec.replace(n_shards=self.n_slots * spec.n_shards)
        self.directory = directory
        self.path = path
        self.keep = keep
        self._state = create(self.pool_spec, device)
        self.device = self._state.device
        self._slots: dict = {}       # tenant id -> slot
        self._last_used: dict = {}   # tenant id -> LRU clock tick
        self._steps: dict = {}       # tenant id -> next checkpoint step
        self._clock = 0
        self._staged = None          # (cols, counts) awaiting dispatch
        self._empty_rows = None      # a cleared slot's rows, made once

    # ---- introspection ----------------------------------------------------

    @property
    def tenants(self) -> dict:
        """Attached tenants: ``{tenant_id: slot}`` (a copy)."""
        return dict(self._slots)

    @property
    def free_slots(self) -> int:
        return self.n_slots - len(self._slots)

    @property
    def state(self) -> ShardedState:
        """The pooled handle with every submitted round applied (implicit
        flush); live: the next dispatched round spends it."""
        return self.flush()

    def slot_of(self, tenant_id) -> int:
        """The slot of an attached tenant (KeyError when evicted)."""
        return self._slots[tenant_id]

    def _rows(self, shards, slot: int):
        """Views of one slot's block of rows."""
        n = self.spec.n_shards
        return shards.map(lambda x: x[slot * n:(slot + 1) * n])

    def handle_of(self, tenant_id) -> tuple[SketchSpec, ShardedState]:
        """A standalone ``(spec, state)`` copy of one tenant's sketch, in
        storage of its own (the pool's ingest writes in place)."""
        st = self.flush()
        rows = self._rows(st.live(), self._slots[tenant_id])
        return self.spec, ShardedState(rows.map(torch.clone))

    # ---- admission / eviction --------------------------------------------

    def _tenant_dir(self, tenant_id) -> str:
        return os.path.join(str(self.directory), f"tenant-{tenant_id}")

    def _has_checkpoint(self, tenant_id) -> bool:
        return (self.directory is not None
                and os.path.isdir(self._tenant_dir(tenant_id)))

    def attach(self, tenant_id) -> int:
        """Admit a tenant and return its slot (its own, if attached). An
        evicted tenant's checkpoint is restored, possibly into another
        slot. A full pool evicts its least recently used tenant when it
        has a ``directory``, else raises ``PoolFullError``."""
        if tenant_id in self._slots:
            return self._slots[tenant_id]
        if not self.free_slots:
            if self.directory is None:
                raise PoolFullError(
                    f"all {self.n_slots} slots attached and no checkpoint "
                    "directory to evict into — construct the pool with "
                    "directory=... or evict() a tenant explicitly")
            self.evict(min(self._slots, key=lambda t: self._last_used[t]))
        slot = min(set(range(self.n_slots)) - set(self._slots.values()))
        if self._has_checkpoint(tenant_id):
            restored = _ckpt.restore(self.spec, self._tenant_dir(tenant_id),
                                     device=self.device)
            self._write_slot(slot, restored.live())
        self._slots[tenant_id] = slot
        self._touch(tenant_id)
        return slot

    def evict(self, tenant_id, blocking: bool = True) -> None:
        """Checkpoint a tenant's rows (the tenant id in the manifest's
        ``extra``) and free its slot. The rows are copied to host memory
        before the slot is cleared, also with ``blocking=False``."""
        if self.directory is None:
            raise ValueError("evict() needs a pool checkpoint directory")
        slot = self._slots[tenant_id]
        rows = self._rows(self.flush().live(), slot)
        step = self._steps.get(tenant_id, 0)
        _ckpt.save(self.spec, ShardedState(rows), self._tenant_dir(tenant_id),
                   step=step, keep=self.keep, blocking=blocking,
                   extra={"tenant_id": str(tenant_id)})
        self._steps[tenant_id] = step + 1
        self._clear_slot(slot)
        del self._slots[tenant_id]
        self._last_used.pop(tenant_id, None)

    def _touch(self, tenant_id) -> None:
        self._clock += 1
        self._last_used[tenant_id] = self._clock

    def _ensure(self, tenant_id) -> int:
        slot = self._slots.get(tenant_id)
        if slot is None:
            slot = self.attach(tenant_id)
        self._touch(tenant_id)
        return slot

    def _write_slot(self, slot: int, rows) -> None:
        """Replace one slot's rows in place (after a flush: surgery and the
        staged round must not reorder). The pool gets a fresh handle, so
        no planes cached on the old one are served again."""
        st = self.flush()
        for dst, src in zip(self._rows(st.live(), slot).leaves(),
                            rows.leaves()):
            dst.copy_(src)
        st.spent = True
        self._state = ShardedState(st.shards)

    def _clear_slot(self, slot: int) -> None:
        if self._empty_rows is None:
            self._empty_rows = _init(self.spec, (self.spec.n_shards,),
                                     self.device)
        self._write_slot(slot, self._empty_rows)

    # ---- ingest -----------------------------------------------------------

    def _partition_pool(self, pairs):
        """The host half of a pooled round: each tenant's rows (its
        batches concatenated in submission order), routed as a standalone
        handle of the tenant spec would route them, laid out by slot.
        Returns ``(cols, counts)`` as ``ingest._partition_stack`` does."""
        n_sh = self.spec.n_shards
        per_slot: dict = {}
        for slot, batch in pairs:
            if self.spec.kind == "gss":
                batch = _degenerate_batch(batch)
            fs = {f: np.atleast_1d(np.asarray(getattr(batch, f), np.int32))
                  for f in _FIELDS}
            if slot in per_slot:
                fs = {f: np.concatenate([per_slot[slot][f], fs[f]])
                      for f in _FIELDS}
            per_slot[slot] = fs
        index: dict = {}
        max_count = 1
        for slot in sorted(per_slot):
            fs = per_slot[slot]
            sid = routed_assignment(self.spec, fs["src"], fs["dst"],
                                    fs["src_label"])
            for s in range(n_sh):
                ix = np.flatnonzero(sid == s)
                if len(ix):
                    index[slot * n_sh + s] = (fs, ix)
                    max_count = max(max_count, len(ix))
        L = _shard_bucket(max_count, floor=64)
        S = self.pool_spec.n_shards
        out = {f: np.zeros((S, L), np.int32) for f in _FIELDS}
        counts = np.zeros(S, np.int32)
        for row, (fs, ix) in index.items():
            m = len(ix)
            counts[row] = m
            for f in _FIELDS:
                r = out[f][row]
                r[:m] = fs[f][ix]
                r[m:] = r[m - 1]  # replicate-last keeps time non-decreasing
        return out, counts

    def submit(self, batches) -> None:
        """Stage one round of writes: ``{tenant: batch}`` or ``(tenant,
        batch)`` pairs (a tenant may appear more than once; its batches
        apply in pair order). Dispatches the round staged before, then
        partitions this one on the host. Unknown tenants are attached,
        which may evict from a full pool."""
        pairs = (list(batches.items()) if isinstance(batches, dict)
                 else list(batches))
        pairs = [(tid, b) for tid, b in pairs if len(b) > 0]
        if not pairs:
            return
        # admission may evict (slot surgery flushes): before staging, so
        # the staged round never passes it
        slotted = [(self._ensure(tid), b) for tid, b in pairs]
        self._dispatch_staged()
        self._staged = self._partition_pool(slotted)

    def ingest(self, tenant_id, batch: EdgeBatch) -> None:
        """Synchronous single-tenant write (submit and flush)."""
        self.submit([(tenant_id, batch)])
        self.flush()

    def flush(self) -> ShardedState:
        """Dispatch any staged round; the returned pooled handle reflects
        every submitted batch, in each tenant's submission order."""
        self._dispatch_staged()
        return self._state

    @property
    def pending(self) -> int:
        """Staged, not yet dispatched rounds (0 or 1)."""
        return int(self._staged is not None)

    @property
    def dispatched(self) -> ShardedState:
        """The live pooled handle with every dispatched round applied;
        does not flush the staged round."""
        return self._state

    def _dispatch_staged(self) -> None:
        if self._staged is None:
            return
        (cols, counts), self._staged = self._staged, None
        self._state = _dispatch_stacked(self.pool_spec, self._state, cols,
                                        counts, self.path)

    # ---- query ------------------------------------------------------------

    def prewarm(self, last=None, *, horizons=None) -> None:
        """Build (or fold) the pooled planes for a horizon, or with
        ``horizons=`` the stacked planes of a sweep, ahead of traffic."""
        if horizons is not None:
            query_planes_multi(self.spec, self.flush(), list(horizons),
                               groups=self.n_slots)
            return
        query_planes(self.spec, self.flush(), last, groups=self.n_slots)

    def query(self, tenant_id, q: QueryBatch, path: str = "auto"):
        """One tenant's answers, int32 [B], equal to its standalone
        sketch's."""
        return self.query_many([(tenant_id, q)], path=path)[0]

    def query_many(self, pairs, path: str = "auto"):
        """Answer many ``(tenant, QueryBatch)`` pairs in one pooled
        dispatch; returns each pair's answers, in input order. The pairs
        must share kind, direction, last and edge-label presence. Evicted
        tenants are readmitted."""
        pairs = list(pairs.items()) if isinstance(pairs, dict) else list(pairs)
        if not pairs:
            return []
        if path == "collective":
            raise ValueError(
                "pooled handles are host-resident: path='collective' is for "
                "one mesh-placed sketch, not a TenantPool")
        slotted = [(self._ensure(tid), q) for tid, q in pairs]
        state = self.flush()
        path = resolve_query_path(path, state.device, self.spec.kind)
        groups = self.n_slots
        arrays, with_le, last, kind, direction, spans, Lq = _group_queries(
            self.spec, slotted, groups, state.device)
        if path == "cuda":
            planes = query_planes(self.spec, state, last, groups=groups)
            out = _cuda_pooled(self.spec, planes, arrays, kind, direction,
                               with_le, groups)
        else:
            out = _scan_pooled(self.spec, state.live(), arrays, kind,
                               direction, with_le, last, groups, Lq,
                               {s for s, _, _ in spans})
        return [out[s, off:off + m] for s, off, m in spans]

    def top_k(self, tenant_id, kind: str = "vertex", k: int = 10, *,
              direction: str = "out", last=None, horizons=None):
        """One tenant's windowed top-k: "vertex" -> (vids [k], weights
        [k]), "edge" -> (src [k], dst [k], weights [k]), "label" ->
        (blocks [k], weights [k]); (-1, 0) padding. ``horizons=`` adds a
        leading [H] axis."""
        return self.top_k_many([tenant_id], kind=kind, k=k,
                               direction=direction, last=last,
                               horizons=horizons)[0]

    def top_k_many(self, tenant_ids, kind: str = "vertex", k: int = 10, *,
                   direction: str = "out", last=None, horizons=None):
        """Top-k for many tenants in one pooled dispatch (one decode
        launch), each equal to ``sketch.heavy_vertices`` (etc.) on the
        tenant's standalone handle; per-tenant result tuples in input
        order. ``horizons=[...]`` (not with ``last=``) sweeps the ranking:
        each leaf gains a leading [H] axis, row i equal to
        ``last=horizons[i]``."""
        if self.spec.kind == "lgs":
            raise NotImplementedError(
                "LGS cells store no keys — the reversible cell-owner "
                "decode needs LSketch/GSS")
        tenant_ids = list(tenant_ids)
        if not tenant_ids:
            return []
        slots = [self._ensure(tid) for tid in tenant_ids]
        out = grouped_top_k(self.spec, self.flush(), self.n_slots, kind, k,
                            direction=direction, last=last,
                            horizons=horizons)
        if horizons is not None:
            return [tuple(x[:, s] for x in out) for s in slots]
        return [tuple(x[s] for x in out) for s in slots]
