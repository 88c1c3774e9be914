"""Sketch serving: batched ingest and batched queries over one handle
(port of ``repro.launch.serve_sketch``: ``QueryRequest``, ``SketchServer``,
``build_spec`` and the CLI's ``main``).

The server owns a ``(SketchSpec, AsyncIngestor)`` pair: ingest
hash-partitions each edge batch across ``--shards`` shards in one stacked
dispatch (the insert and pool kernels on the card, the scan on the CPU)
and is pipelined, the host partition of batch N+1 overlapping batch N's
dispatch (``--no-pipeline`` dispatches each batch at once). Queries flush
the pipeline first, so answers reflect every batch submitted before
them, and are answered in one pass per query kind through every shard
(one batched dispatch per request group in pool mode and off the kernel
route). ``--query-path`` picks the read path: ``scan`` (the dense
reference) or ``cuda`` (the probe and scan kernels over cached
window-reduced planes; ``pallas``, the reference's name, means the same);
``auto`` is ``cuda`` on the card. The plane cache is kept hot after each
ingest (prewarm) and reused by every request group until the next one.
The same server fronts ``lsketch``, ``lgs`` and ``gss``.

With ``--tenants T`` the server fronts a ``sketch.TenantPool``: T
same-spec tenant sketches in one stacked state, where a cross-tenant
ingest round and a query group each take one pooled dispatch and every
answer equals the tenant's standalone sketch's.

With ``mesh=`` (a ``sketch.MeshContext``, or a process group) the served
handle is mesh-resident: each rank of the group holds its block of shard
rows, ingests it and, on ``query_path="collective"``, answers against its
own planes with the partials reduced across the ranks. Every rank runs
the same server on the same requests. ``--mesh N`` runs N such ranks
(``distributed.ranks.spawn_ranks``: NCCL, one card a rank, or gloo ranks
with ``--device cpu``) and rank 0 prints; ``--collective`` stands for
``--query-path collective``.

Usage: python -m repro_torch.launch.serve_sketch --sketch lsketch --shards 4
       python -m repro_torch.launch.serve_sketch --shards 1 --tenants 16
       python -m repro_torch.launch.serve_sketch --shards 8 --mesh 4 \
           --collective --device cpu
   (or python -m repro_torch.launch.serve --mode sketch ...; on the card
   unless --device cpu)
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import sketch as skt
from repro_torch.core import LGSConfig, LSketchConfig
from repro_torch.core.gss import gss_config
from repro_torch.core.types import resolve_device
from repro_torch.data.stream import PHONE, edge_batches, generate
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.telemetry.spans import span


@dataclasses.dataclass
class QueryRequest:
    """One pending query; ``answer`` is filled by ``SketchServer.flush``."""

    kind: str  # "edge" | "vertex" | "label"
    args: Dict[str, Any]
    answer: int | None = None
    tenant: Any = None  # pool-mode routing (None on a single-sketch server)


class SketchServer:
    """Continuous-batching frontend over one sharded sketch handle, or,
    with ``pool=``, over a ``sketch.TenantPool`` of same-spec sketches.

    ``submit`` enqueues; ``flush`` groups every pending request by (kind,
    edge-label?, last, direction). On a single handle it answers each
    kind's groups in one pass (``skt.query_many``: on the kernel route
    one edge launch over every edge request, one addressing and a scan
    per (direction, horizon) for vertices, a plane reduction per
    (direction, horizon) for labels) and reads every answer back in one
    copy. In pool mode each group takes one pooled dispatch, the tenant
    a per-row axis of it, whatever the tenants it spans.

    Ingest rides an ``AsyncIngestor`` (``pipeline=True``) and the query
    path flushes it before answering. In pool mode the pool's own
    staggered rounds play that part (``ingest(batch, tenant=...)``, or
    ``ingest_many`` for one cross-tenant round); per-tenant order is kept
    and cross-tenant order normalised by slot, so the state is the same
    for any caller order. ``heat_threshold``/``split_replicas`` turn on
    the heavy-key detector (single handle only); ``horizons`` registers a
    sweep that every prewarm builds in one stacked pass. The handle lives
    on ``device`` (the card unless the caller names the CPU; a pool has
    its own). ``mesh=`` (a ``MeshContext`` or a process group, with
    ``axis``) places the handle over the group's ranks, or a ``state``
    that is already placed keeps its layout; ``query_path="collective"``
    needs one whose group divides the shard count.
    """

    def __init__(self, spec: "skt.SketchSpec | None" = None,
                 max_batch: int = 4096,
                 state: "skt.ShardedState | None" = None,
                 pipeline: bool = True, query_path: str = "auto",
                 mesh=None, axis: str = "data", prewarm: bool = True,
                 pool: "skt.TenantPool | None" = None,
                 heat_threshold: float | None = None,
                 split_replicas: int | None = None,
                 horizons=None, device=None):
        self.horizons = [h if h is None else int(h)
                         for h in (horizons or [])]
        if any(h is not None and h <= 0 for h in self.horizons):
            raise ValueError("horizons= entries must be positive (or None "
                             "for the full window)")
        self.pool = pool
        if pool is not None:
            if spec is not None and spec != pool.spec:
                raise ValueError("pass either spec= or pool=, and a pool "
                                 "carries its own per-tenant spec")
            if state is not None or mesh is not None:
                raise ValueError(
                    "pool mode owns its state and is host-resident: "
                    "state=/mesh= do not apply")
            if query_path == "collective":
                raise ValueError(
                    "query_path='collective' serves one mesh-placed "
                    "sketch, not a TenantPool")
            if heat_threshold is not None:
                raise ValueError("heat_threshold= tracks a single handle's "
                                 "stream; pool tenants route per-spec")
            self.spec = pool.spec
            self.pipeline = pipeline
            self.query_path = query_path
            self.prewarm = prewarm
            self._ingestor = None
            self.max_batch = max_batch
            self.pending: List[QueryRequest] = []
            self.query_shard_counts = np.zeros(pool.spec.n_shards, np.int64)
            return
        if spec is None:
            raise ValueError("SketchServer needs a spec= or a pool=")
        self.spec = spec
        self.pipeline = pipeline
        self.query_path = query_path
        self.prewarm = prewarm
        # a pre-placed handle already carries its layout: keep it
        ctx = skt.mesh_context(state) if state is not None else None
        if ctx is None and mesh is not None:
            ctx = mesh if isinstance(mesh, skt.MeshContext) else \
                skt.MeshContext(group=mesh, axis=axis)
        if query_path == "collective":
            # refuse at construction, not after a whole ingest
            if ctx is None:
                raise ValueError(
                    "query_path='collective' needs a mesh (SketchServer("
                    "..., mesh=...) or a place()d state)")
            if not ctx.divides(spec.n_shards):
                raise ValueError(
                    f"query_path='collective' needs the mesh axis to divide "
                    f"the shard count: n_shards={spec.n_shards} over "
                    f"{ctx.n_devices} devices replicates instead of "
                    "sharding")
        if ctx is not None and skt.mesh_context(state) is None:
            # mesh-resident from the first dispatch; ingest keeps it
            state = skt.place(spec, state if state is not None
                              else skt.create(spec, device), ctx)
        self._ingestor = skt.AsyncIngestor(spec, state=state,
                                           heat_threshold=heat_threshold,
                                           split_replicas=split_replicas,
                                           device=device)
        self.max_batch = max_batch
        self.pending: List[QueryRequest] = []
        # per-shard query-endpoint log: every answered edge/vertex request
        # counts its endpoint's home shard (the workload signal
        # ``budget_report`` blends with the ingest load)
        self.query_shard_counts = np.zeros(spec.n_shards, np.int64)

    @property
    def state(self) -> "skt.ShardedState":
        """The handle with every ingested batch applied (flushes)."""
        if self.pool is not None:
            return self.pool.state
        return self._ingestor.state

    @property
    def device(self) -> torch.device:
        if self.pool is not None:
            return self.pool.device
        return self._ingestor.dispatched.device

    @property
    def live_spec(self) -> "skt.SketchSpec":
        """The spec with the live routing table (the constructor's spec
        plus any splits the detector applied since); same identity as
        ``self.spec``. Checkpoint with this one."""
        if self.pool is not None:
            return self.pool.spec
        return self._ingestor.spec

    def budget_report(self, alpha: float = 0.5) -> "skt.BudgetReport":
        """Workload-aware sizing (``sketch.recommend_budget``): the
        detector's ingest load blended with this server's query-endpoint
        log, and the routing table that levels them. Apply it to stored
        history with ``sketch.reshard(spec, state, n_shards,
        routing=report.routing)`` and to new ingest by serving with
        ``spec.replace(routing=report.routing)``."""
        if self.pool is not None:
            raise ValueError("budget_report() sizes a single handle; pool "
                             "tenants carry per-spec routing")
        det = self._ingestor.detector
        if det is None:
            raise ValueError("budget_report() needs the heavy-key detector "
                             "(construct with heat_threshold=...)")
        return skt.recommend_budget(self.live_spec, det,
                                    self.query_shard_counts, alpha=alpha)

    def _log_query_endpoints(self, batches) -> None:
        """Count every edge and vertex request's endpoint shard, in one
        pass over the flush's batches."""
        ends = [(q.src, q.src_label) if q.kind == "edge" else
                (q.vertex, q.vertex_label) for q in batches
                if q.kind in ("edge", "vertex")]
        if not ends:  # label aggregates touch every shard equally
            return
        v, lv = (np.concatenate([np.asarray(x[i]) for x in ends])
                 for i in (0, 1))
        self.query_shard_counts += np.bincount(
            skt.shard_assignment(self.spec, v, lv),
            minlength=self.spec.n_shards).astype(np.int64)

    # ---- ingest ----
    def ingest(self, batch, tenant=None) -> None:
        with span("lsketch.server.ingest"):
            if self.pool is not None:
                if tenant is None:
                    raise ValueError("pool-mode ingest needs tenant=")
                self.ingest_many([(tenant, batch)])
                return
            if tenant is not None:
                raise ValueError("tenant= needs a pool-mode server (pool=)")
            self._ingestor.submit(batch)
            if not self.pipeline:
                self._ingestor.flush()
            self._prewarm_many([None])

    def ingest_many(self, batches) -> None:
        """One cross-tenant ingest round (pool mode): ``{tenant: batch}``
        or ``(tenant, batch)`` pairs in one pooled dispatch, the same
        state under any iteration order."""
        if self.pool is None:
            raise ValueError("ingest_many needs a pool-mode server (pool=)")
        self.pool.submit(batches)
        if not self.pipeline:
            self.pool.flush()
        self._prewarm_many([None])

    def _path(self) -> str:
        return skt.resolve_query_path(self.query_path, self.device,
                                      self.spec.kind)

    def _prewarm(self, last=None, handle=None) -> None:
        """Keep the plane cache hot off the query path, on the dispatched
        handle (the staged batch stays staged): folds the flush's delta
        chain, or pays a rebuild here instead of in the first query. A
        no-op on the scan path, which reads raw counters."""
        if not self.prewarm or self._path() == "scan":
            return
        if self.pool is not None:
            skt.query_planes(self.spec,
                             handle if handle is not None
                             else self.pool.dispatched,
                             last, groups=self.pool.n_slots)
            return
        h = handle if handle is not None else self._ingestor.dispatched
        if h is None:
            return
        skt.query_planes(self.spec, h, last,
                         collective=self._path() == "collective")

    def _wanted(self, lasts) -> list:
        """The horizons a flush's planes cover: its own, then the
        registered sweep's."""
        want = list(dict.fromkeys(lasts))
        return want + [h for h in self.horizons if h not in want]

    def _prewarm_many(self, lasts, handle=None) -> None:
        """Multi-horizon prewarm: when a flush (or the registered
        ``horizons=`` sweep) needs several horizons, one stacked build
        covers them all and per-horizon lookups slice it; a single
        horizon with no sweep takes the plain prewarm."""
        if not self.prewarm or self._path() == "scan":
            return
        want = self._wanted(lasts)
        if not want:
            return
        with span("lsketch.server.prewarm"):
            if len(want) == 1:
                self._prewarm(want[0], handle=handle)
                return
            if self.pool is not None:
                h0 = handle if handle is not None else self.pool.dispatched
                skt.query_planes_multi(self.spec, h0, want,
                                       groups=self.pool.n_slots)
                return
            h0 = handle if handle is not None else self._ingestor.dispatched
            if h0 is None:
                return
            skt.query_planes_multi(self.spec, h0, want,
                                   collective=self._path() == "collective")

    def serving_summary(self, alpha: float = 0.5) -> str:
        """One-line serving health for periodic logging: queue depth, the
        plane cache's counters and, with the detector on, the sizing
        numbers of ``budget_report()``."""
        from repro_torch.sketch.query import PLANES_BUILD_COUNTS as c
        parts = [f"pending={len(self.pending)}",
                 f"planes[build={c['build']} delta={c['delta']} "
                 f"evict={c['evict']}]"]
        if self.pool is None and self._ingestor.detector is not None:
            rep = self.budget_report(alpha)
            live = self.live_spec.routing.splits \
                if self.live_spec.routing else ()
            parts.append(
                f"splits[live={len(live)} recommended="
                f"{len(rep.routing.splits)}] "
                f"load=[{' '.join('%.3f' % f for f in rep.combined)}]")
        return " ".join(parts)

    # ---- queries ----
    def submit(self, kind: str, tenant=None, **args) -> QueryRequest:
        if (tenant is None) != (self.pool is None):
            raise ValueError("tenant= is required in pool mode and invalid "
                             "otherwise")
        req = QueryRequest(kind, args, tenant=tenant)
        self.pending.append(req)
        if len(self.pending) >= self.max_batch:
            self.flush()
        return req

    def _group_key(self, r: QueryRequest):
        # the tenant is absent: in pool mode it is a per-row axis of the
        # pooled dispatch, not a group
        return (r.kind, r.args.get("le") is not None, r.args.get("last"),
                r.args.get("direction", "out"))

    @staticmethod
    def _group_batch(kind, reqs, with_le, last, direction) -> "skt.QueryBatch":
        a = {k: np.asarray([r.args[k] for r in reqs], np.int32)
             for k in reqs[0].args if _batch_axis(reqs, k)}
        le = a.get("le") if with_le else None
        if kind == "edge":
            return skt.QueryBatch.edges(a["src"], a["la"], a["dst"],
                                        a["lb"], edge_label=le, last=last)
        if kind == "vertex":
            return skt.QueryBatch.vertices(a["v"], a["lv"], edge_label=le,
                                           direction=direction, last=last)
        if kind == "label":
            return skt.QueryBatch.labels(a["lv"], edge_label=le,
                                         direction=direction, last=last)
        raise ValueError(f"unknown query kind {kind!r}")

    def flush(self) -> int:
        if not self.pending:  # nothing queued: no dispatch, no state touch
            return 0
        with span("lsketch.server.flush"):
            groups: Dict[tuple, List[QueryRequest]] = {}
            for r in self.pending:
                groups.setdefault(self._group_key(r), []).append(r)
            # .state drains the ingest pipeline; a flush spanning several
            # horizons prewarms them in one stacked build
            lasts = [g[2] for g in groups]
            self._prewarm_many(lasts, handle=self.state)
            if self.pool is not None:
                for key, reqs in groups.items():
                    with span("lsketch.server.group"):
                        self._answer_group(key, reqs)
            else:
                self._answer_passes(groups, self._wanted(lasts))
            done = len(self.pending)
            self.pending.clear()
            return done

    def _answer_passes(self, groups: Dict[tuple, List[QueryRequest]],
                       horizons: list) -> None:
        """A single handle's flush: one ``skt.query_many`` pass a query
        kind over every group of that kind (on the kernel route one
        launch or a few; on the other paths a dispatch a group), then
        every answer read back in one copy."""
        by_kind: Dict[str, list] = {}
        for key, reqs in groups.items():
            kind, with_le, last, direction = key
            by_kind.setdefault(kind, []).append(
                (reqs, self._group_batch(kind, reqs, with_le, last,
                                         direction)))
        self._log_query_endpoints([q for items in by_kind.values()
                                   for _, q in items])
        state, outs, answered = self.state, [], []
        for items in by_kind.values():
            with span("lsketch.server.group"):
                outs += skt.query_many(self.spec, state,
                                       [q for _, q in items],
                                       path=self.query_path,
                                       horizons=horizons)
            answered += [r for reqs, _ in items for r in reqs]
        with span("lsketch.server.readback"):
            for r, v in zip(answered, torch.cat(outs).cpu().tolist()):
                r.answer = v

    def _answer_group(self, key: tuple, reqs: List[QueryRequest]) -> None:
        """One request group's pooled dispatch (pool mode), its answers
        set on its requests: stable-sorted contiguous per-tenant runs keep
        the row layout the same under any arrival interleaving."""
        kind, with_le, last, direction = key
        order = sorted(range(len(reqs)),
                       key=lambda i: self.pool.slot_of(reqs[i].tenant)
                       if reqs[i].tenant in self.pool.tenants else -1)
        runs: List[tuple] = []  # (tenant, [req, ...]) runs
        for i in order:
            r = reqs[i]
            if runs and runs[-1][0] == r.tenant:
                runs[-1][1].append(r)
            else:
                runs.append((r.tenant, [r]))
        pairs = [(t, self._group_batch(kind, rs, with_le, last, direction))
                 for t, rs in runs]
        outs = self.pool.query_many(pairs, path=self.query_path)
        with span("lsketch.server.readback"):
            for (_, rs), out in zip(runs, outs):
                for r, v in zip(rs, out.cpu().numpy()):
                    r.answer = int(v)

    # ---- analytics ----
    def top_k(self, kind: str = "vertex", k: int = 10, *,
              direction: str = "out", last=None, horizons=None, tenant=None):
        """Windowed heavy-hitter top-k over the served sketch: "vertex" ->
        (vids, weights), "edge" -> (src, dst, weights), "label" ->
        (blocks, weights), each ``[k]`` padded with (-1, 0). Pool mode
        answers for one tenant (``tenant=``). Flushes pending queries
        first; ``horizons=`` (not with ``last=``) adds a leading [H]
        axis."""
        self.flush()
        if self.pool is not None:
            if tenant is None:
                raise ValueError("pool-mode top_k needs tenant=")
            return self.pool.top_k(tenant, kind=kind, k=k,
                                   direction=direction, last=last,
                                   horizons=horizons)
        if tenant is not None:
            raise ValueError("tenant= needs a pool-mode server (pool=)")
        st = self.state
        if kind == "vertex":
            return skt.heavy_vertices(self.spec, st, k, direction=direction,
                                      last=last, horizons=horizons,
                                      path=self.query_path)
        if kind == "edge":
            return skt.heavy_edges(self.spec, st, k, last=last,
                                   horizons=horizons, path=self.query_path)
        if kind == "label":
            return skt.top_labels(self.spec, st, k, direction=direction,
                                  last=last, horizons=horizons,
                                  path=self.query_path)
        raise ValueError(f"unknown top_k kind {kind!r}")

    def reachable(self, src, src_label, dst, dst_label, *,
                  max_hops: int = 8, last=None, horizons=None, tenant=None):
        """Batched multi-hop reachability (bool [B]) over the served
        sketch; pool mode reads the tenant's standalone handle.
        ``horizons=`` returns bool ``[H, B]``."""
        self.flush()
        if self.pool is not None:
            if tenant is None:
                raise ValueError("pool-mode reachable needs tenant=")
            spec, st = self.pool.handle_of(tenant)
            return skt.reachable_many(spec, st, src, src_label, dst,
                                      dst_label, max_hops=max_hops,
                                      last=last, horizons=horizons)
        if tenant is not None:
            raise ValueError("tenant= needs a pool-mode server (pool=)")
        return skt.reachable_many(self.spec, self.state, src, src_label,
                                  dst, dst_label, max_hops=max_hops,
                                  last=last, horizons=horizons)


def _batch_axis(reqs: List[QueryRequest], k: str) -> bool:
    """Request fields that batch into arrays (not the grouping axes)."""
    return k not in ("direction", "last") and \
        all(r.args.get(k) is not None for r in reqs)


def build_spec(name: str, window_size: int,
               n_shards: int = 1) -> "skt.SketchSpec":
    if name == "lgs":
        cfg = LGSConfig(d=128, copies=3, c=8, k=8, window_size=window_size)
    elif name == "gss":
        cfg = gss_config(d=128)
    else:
        cfg = LSketchConfig(d=128, n_blocks=2, F=1024, r=8, s=8, c=16, k=8,
                            window_size=window_size, pool_capacity=4096,
                            pool_probes=16)
    return skt.SketchSpec(kind=name, config=cfg, n_shards=n_shards)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sketch", default="lsketch",
                    choices=["lsketch", "lgs", "gss"])
    ap.add_argument("--shards", type=int, default=1,
                    help="hash-partitioned sketch shards (leading state axis)")
    ap.add_argument("--edges", type=int, default=20000)
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--ingest-batch", type=int, default=2048)
    ap.add_argument("--no-pipeline", action="store_true",
                    help="dispatch each batch at once instead of "
                         "overlapping partition and device work")
    ap.add_argument("--query-path", default="auto",
                    choices=["auto", "scan", "cuda", "pallas", "collective"],
                    help="read path: the dense scan, the CUDA kernels over "
                         "cached window-reduced planes ('pallas' is the "
                         "reference's name for it), or the same on each "
                         "rank's block of a mesh-resident handle with the "
                         "answers reduced across the ranks (needs --mesh)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="lay the shard axis over N ranks, one card each "
                         "(gloo ranks on the CPU with --device cpu; 0 = "
                         "host-resident handle); N must divide --shards "
                         "for the collective path")
    ap.add_argument("--collective", action="store_true",
                    help="shorthand for --query-path collective")
    ap.add_argument("--no-prewarm", action="store_true",
                    help="skip keeping the plane cache hot across ingest "
                         "flushes; the first query after a flush pays the "
                         "fold or the rebuild")
    ap.add_argument("--topk", type=int, default=5,
                    help="heavy-hitter summary size printed after serving")
    ap.add_argument("--heat-threshold", type=float, default=0.0,
                    help="split any source key carrying more than this "
                         "fraction of the ingest stream across replica "
                         "shards (0 = off); prints the workload-aware "
                         "budget report after serving")
    ap.add_argument("--horizons", default="", metavar="H1,H2,...",
                    help="register a horizon sweep (window counts, e.g. "
                         "1,2,4,8): prewarm builds every registered "
                         "horizon in one stacked pass and a sweep prints "
                         "after serving")
    ap.add_argument("--summary-every", type=int, default=0, metavar="N",
                    help="print a serving-health summary every N ingest "
                         "batches; 0 = off")
    ap.add_argument("--tenants", type=int, default=0, metavar="T",
                    help="serve T independent tenant sketches from one "
                         "TenantPool (the stream split round-robin; each "
                         "tenant gets --shards shards)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    if args.tenants and (args.mesh or args.collective):
        raise SystemExit("--tenants is host-resident: drop --mesh/"
                         "--collective")
    if args.tenants and args.heat_threshold:
        raise SystemExit("--heat-threshold tracks a single handle's "
                         "stream: drop --tenants")
    if args.collective:
        args.query_path = "collective"
    dev = resolve_device(args.device)
    if args.mesh:
        if dev.type == "cuda" and args.mesh > torch.cuda.device_count():
            raise SystemExit(f"--mesh {args.mesh}: only "
                             f"{torch.cuda.device_count()} devices available")
        if args.query_path == "collective" and args.shards % args.mesh:
            raise SystemExit(
                f"--query-path collective needs --mesh to divide --shards "
                f"(got {args.shards} shards over {args.mesh} devices, "
                "which replicates instead of sharding)")
        spawn_ranks(_serve, args.mesh, device=dev, args=(args,))
        return
    if args.query_path == "collective":
        raise SystemExit("--query-path collective needs --mesh N")
    _serve(args)


def _serve(args) -> None:
    """The serving run of ``main``: in this process, or on each rank of a
    ``--mesh`` group (only rank 0 prints)."""
    dev = resolve_device(args.device)
    mesh = skt.MeshContext() if args.mesh else None
    say = print if mesh is None or mesh.rank == 0 else \
        (lambda *a, **k: None)

    horizons = [int(x) for x in args.horizons.split(",") if x.strip()]
    spec = dataclasses.replace(PHONE, n_edges=args.edges, n_vertices=1000)
    st = generate(spec, seed=0)
    sk_spec = build_spec(args.sketch, spec.window_size, n_shards=args.shards)
    if args.tenants:
        pool = skt.TenantPool(sk_spec, n_slots=args.tenants, device=dev)
        server = SketchServer(pool=pool, pipeline=not args.no_pipeline,
                              query_path=args.query_path,
                              prewarm=not args.no_prewarm,
                              horizons=horizons)
    else:
        server = SketchServer(sk_spec, pipeline=not args.no_pipeline,
                              query_path=args.query_path, mesh=mesh,
                              prewarm=not args.no_prewarm,
                              heat_threshold=args.heat_threshold or None,
                              horizons=horizons, device=dev)

    from repro_torch.engine.insert import ROUTE_EDGES
    routes_before = dict(ROUTE_EDGES)
    t0 = time.time()
    n_batches = 0
    for batch in edge_batches(st, args.ingest_batch):
        if args.tenants:
            # round-robin tenant split of one stream: every tenant sees a
            # time-ordered substream, each round one pooled dispatch
            server.ingest_many([(n_batches % args.tenants, batch)])
        else:
            server.ingest(batch)
        n_batches += 1
        if args.summary_every and n_batches % args.summary_every == 0:
            say(f"[batch {n_batches}] {server.serving_summary()}")
    server.state  # drains the pipeline
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt_ing = time.time() - t0
    routes = {k: ROUTE_EDGES[k] - v for k, v in routes_before.items()}
    say(f"ingested {len(st)} edges in {dt_ing:.2f}s "
        f"({len(st) / dt_ing:.0f} edges/s, {n_batches} batches, "
        f"{args.shards} shards"
        + (f", {args.tenants} tenants" if args.tenants else "")
        + f", {routes['kernel']} kernel-route and {routes['scan']} "
        f"scan-route edges"
        + (f" in rank 0's rows of {args.mesh} ranks" if mesh else "")
        + f") on {dev}")

    rng = np.random.default_rng(1)
    idx = rng.integers(0, len(st), args.requests)
    t0 = time.time()
    reqs = [server.submit("edge", src=int(st.src[i]), la=int(st.src_label[i]),
                          dst=int(st.dst[i]), lb=int(st.dst_label[i]),
                          tenant=(int(i) % args.tenants if args.tenants
                                  else None))
            for i in idx]
    server.flush()
    dt_q = time.time() - t0
    say(f"answered {len(reqs)} edge queries in {dt_q:.2f}s "
        f"({len(reqs) / dt_q:.0f} q/s)")
    say("sample answers:", [r.answer for r in reqs[:8]])

    if horizons:
        # a horizon sweep in one stacked dispatch: the answer tightens as
        # the window narrows
        i = int(idx[0])
        q = skt.QueryBatch.edges(int(st.src[i]), int(st.src_label[i]),
                                 int(st.dst[i]), int(st.dst_label[i]),
                                 last=horizons)
        t0 = time.time()
        if args.tenants:
            sw_spec, sw_st = server.pool.handle_of(int(i) % args.tenants)
            sweep = skt.query(sw_spec, sw_st, q)
        else:
            sweep = skt.query(sk_spec, server.state, q, path=args.query_path)
        sweep = sweep.cpu().numpy()
        dt_s = time.time() - t0
        say(f"horizon sweep (src={int(st.src[i])} dst={int(st.dst[i])}): "
            + ", ".join(f"last={h}: {int(w)}"
                        for h, w in zip(horizons, sweep[:, 0]))
            + f" ({dt_s:.2f}s, one stacked dispatch)")

    if args.sketch != "lgs":  # LGS stores no keys: no reversible analytics
        tenant = 0 if args.tenants else None
        t0 = time.time()
        vids, vws = server.top_k("vertex", args.topk, tenant=tenant)
        es, ed, ews = server.top_k("edge", args.topk, tenant=tenant)
        dt_a = time.time() - t0
        vtop = [(int(v), int(w)) for v, w in zip(vids.tolist(),
                                                 vws.tolist()) if v >= 0]
        etop = [((int(a), int(b)), int(w)) for a, b, w in
                zip(es.tolist(), ed.tolist(), ews.tolist()) if a >= 0]
        say(f"top-{args.topk} heavy vertices (vid, w): {vtop} "
            + (f"[tenant {tenant}] " if args.tenants else "")
            + f"({dt_a:.2f}s)")
        say(f"top-{args.topk} heavy edges ((src, dst), w): {etop}")

    if args.heat_threshold and not args.tenants:
        rep = server.budget_report()
        splits = server.live_spec.routing.splits \
            if server.live_spec.routing else ()
        say(f"routing: {len(splits)} split keys live; recommended "
            f"splits {len(rep.routing.splits)}; per-shard combined "
            f"load {['%.3f' % f for f in rep.combined]}")


if __name__ == "__main__":
    main()
