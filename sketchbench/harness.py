"""One run of one cell: set-up, the measured window, the traced part, the
check, and the result line.

The system under test is ``repro_torch.launch.serve_sketch.SketchServer``
over the configuration's sketch: one sharded handle (``AsyncIngestor``
inside) or, with ``tenants``, a ``repro_torch.sketch.TenantPool``. The
traffic file sets the serve loop. Each iteration first ingests (``closed``:
the next micro-batch of the stream, back to back; ``periodic``: every
pooled round now due, each tenant's next batch), then issues queries
(``open``: every request due by now, Poisson arrivals at a fixed rate;
``closed``: every client whose previous request was answered) and
flushes them. Batches stop at subwindow boundaries. A request's latency
runs from its due time (open) or issue time (closed) to its answer in
host memory. At the close the server is drained, so every edge ingested
in the window is applied and every request issued is answered, all of it
inside the window's seconds.

Set-up: the kernels built and loaded, the state allocated, the streams
generated, ``prefill_windows`` windows of each stream ingested, and one
flush of ``warm_requests`` requests, so every query path has run. The
set-up time runs from the start of the process to the window.
"""

from __future__ import annotations

import sys
import time
import types

import numpy as np
import torch

from sketchbench import check
from sketchbench.catalog import Catalog
from sketchbench.host import HostMeter, placement
from sketchbench.reference import hashing as rh
from sketchbench.reference import sketch as ref
from sketchbench.trace import Observer, reduce
from sketchbench.traffic import queries as tq
from sketchbench.traffic import schedule
from sketchbench.traffic import stream as ts

PROFILE_FROM = 0.4  # the traced part starts at this share of the window
PROFILE_S = 2.0  # and lasts this many seconds
MAX_CHECK_ROUNDS = 160  # rounds the check may run to meet both plane kinds
MAX_CHECKED = 4  # of which it checks at most this many
SPAN_S = 0.3  # the window's last seconds, whose rounds the check follows


def log(msg: str) -> None:
    """A progress line on standard error."""
    print(f"[sketchbench {time.perf_counter() - T0:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


T0 = time.perf_counter()


class System:
    """The server over the configuration's sketch, its streams and where
    each stream stands."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch import sketch as skt
        from repro_torch.core.types import LSketchConfig
        from repro_torch.launch.serve_sketch import SketchServer

        sk = cfg["sketch"]
        lcfg = LSketchConfig(**{k: int(sk[k]) for k in (
            "d", "n_blocks", "F", "r", "s", "c", "k", "window_size",
            "pool_capacity", "pool_probes", "seed")})
        self.n_shards = int(cfg["shards"])
        self.tenants = int(cfg.get("tenants", 0))
        spec = skt.SketchSpec(kind="lsketch", config=lcfg,
                              n_shards=self.n_shards)
        self.device = torch.device(device)
        # the server as the traffic deploys it: the horizons its requests
        # ask registered, and a request queue long enough that a flush
        # happens where the serve loop calls it
        kw = dict(query_path="cuda", horizons=traffic.get("horizons"),
                  max_batch=int(traffic["queries"]["server_max_batch"]))
        if self.tenants:
            self.pool = skt.TenantPool(spec, n_slots=self.tenants,
                                       device=self.device)
            self.server = SketchServer(pool=self.pool, **kw)
        else:
            self.pool = None
            self.server = SketchServer(spec, device=self.device, **kw)
        self.rcfg = ref.Config.from_dict(sk)
        n = max(self.tenants, 1)
        self.params = ts.StreamParams.from_config(cfg)
        offset = int(cfg.get("tenant_offset_subwindows", 0)) * \
            self.params.subwindow
        self.replays = [ts.Replay(self.params, ts.make_base(
            self.params, seed + t, t0=offset * t, graph=t))
            for t in range(n)]
        self.pos = [0] * n
        self.ingest = traffic["ingest"]
        self.edges = 0  # edges handed to the server

    # the reference's view of the layout: tenant t in slot t, its rows a
    # block of n_shards; a single handle is one fleet of every shard
    def fleet(self, t) -> list:
        base = 0 if t is None else t * self.n_shards
        return list(range(base, base + self.n_shards))

    def rows_of(self, t, cols) -> np.ndarray:
        return self.fleet(t)[0] + rh.shard_of(
            self.rcfg, self.n_shards, cols["src"], cols["src_label"])

    def leaves(self) -> dict:
        st = self.server.state.live()
        return dict(zip(ref.LEAVES, st.leaves()))

    def _batch(self, t: int, size: int):
        from repro_torch.core.types import EdgeBatch
        a = self.pos[t]
        b = self.replays[t].next_cut(a, size)
        cols = self.replays[t].columns(a, b)
        self.pos[t] = b
        self.edges += b - a
        return cols, EdgeBatch(**cols)

    def ingest_round(self, obs: Observer, size: int | None = None) -> list:
        """One ingest step: the single handle's next batch, or one pooled
        round of each tenant's next batch. Returns ``(tenant, columns)``
        of what was sent."""
        size = size or int(self.ingest["max_batch"])
        if self.pool is None:
            cols, batch = self._batch(0, size)
            with obs.span("ingest"):
                self.server.ingest(batch)
            return [(None, cols)]
        sent, pairs = [], []
        for t in range(self.tenants):
            cols, batch = self._batch(t, size)
            sent.append((t, cols))
            pairs.append((t, batch))
        with obs.span("ingest"):
            self.server.ingest_many(pairs)
        return sent

    def next_subwindow(self, t: int) -> bool:
        """Whether stream ``t``'s next batch enters a new subwindow."""
        a = self.pos[t]
        if a == 0:
            return True
        w = self.replays[t].at([a - 1, a])["time"] // self.params.subwindow
        return bool(w[1] > w[0])

    def requests(self, mix: dict, u: np.ndarray, tenants) -> list:
        """``(tenant, kind, args)`` of requests with draws ``u``, tenant
        ``tenants[i]`` (None on a single handle)."""
        out = [None] * len(u)
        tenants = np.asarray([-1 if t is None else t for t in tenants])
        for t in np.unique(tenants):
            idx = np.flatnonzero(tenants == t)
            s = 0 if t < 0 else int(t)
            got = tq.sample_many(mix, u[idx], self.replays[s], self.pos[s],
                                 self.params.edges_per_window)
            for i, (kind, args) in zip(idx, got):
                out[i] = (None if t < 0 else int(t), kind, args)
        return out

    def serve(self, obs: Observer, reqs: list) -> list:
        """Submit requests and flush: their answers, in order."""
        handles = [self.server.submit(kind, tenant=t, **args)
                   for t, kind, args in reqs]
        with obs.span("flush"):
            self.server.flush()
        return [h.answer for h in handles]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters():
    from repro_torch.engine.insert import ROUTE_EDGES
    from repro_torch.sketch.query import PLANES_BUILD_COUNTS
    return dict(planes_build=PLANES_BUILD_COUNTS["build"],
                planes_delta=PLANES_BUILD_COUNTS["delta"],
                route_kernel=ROUTE_EDGES["kernel"],
                route_scan=ROUTE_EDGES["scan"])


def _pci(device) -> str | None:
    """The card's PCI address (``dddd:bb:dd.0``), where torch gives it."""
    if device.type != "cuda":
        return None
    p = torch.cuda.get_device_properties(device)
    ids = [getattr(p, f"pci_{k}_id", None) for k in ("domain", "bus",
                                                      "device")]
    if any(i is None for i in ids):
        return None
    return "%04x:%02x:%02x.0" % tuple(ids)


def _allocs(device) -> tuple:
    """The caching allocator's device malloc and free calls so far."""
    if device.type != "cuda":
        return (0, 0)
    st = torch.cuda.memory_stats(device)
    return (st.get("num_device_alloc", 0), st.get("num_device_free", 0))


class Loop:
    """The traffic file's query loop and ingest schedule, from the seed."""

    def __init__(self, traffic: dict, system: System, seed: int,
                 seconds: float):
        q = traffic["queries"]
        self.mix = q["mix"]
        self.kind = q["loop"]
        self.rng = np.random.default_rng([seed, 1])
        if self.kind == "open":
            due = schedule.poisson_due(np.random.default_rng([seed, 2]),
                                       float(q["rate_per_s"]), seconds)
            self.sched = schedule.OpenLoop(due)
            self.tenant_of = np.full(len(due), -1)
        else:
            n = int(q["clients"])
            self.sched = schedule.ClosedLoop(n)
            self.tenant_of = self._bind(q, system, n, seed)
        ing = traffic["ingest"]
        self.periodic = schedule.Periodic(float(ing["period_ms"]) * 1e-3,
                                          seconds) \
            if ing["mode"] == "periodic" else None

    @staticmethod
    def _bind(q: dict, system: System, n: int, seed: int) -> np.ndarray:
        if not system.tenants:
            return np.full(n, -1)
        p = 1.0 / np.arange(1, system.tenants + 1) ** float(q["tenant_zipf"])
        return np.random.default_rng([seed, 3]).choice(
            system.tenants, n, p=p / p.sum())

    def draw(self, tenants) -> tuple:
        t = [None if x < 0 else int(x) for x in tenants]
        return tq.draws(self.rng, len(t)), t


def prefill(system: System, traffic: dict, obs: Observer) -> None:
    """``prefill_windows`` windows of every stream through the server."""
    size = int(traffic.get("prefill_batch", traffic["ingest"]["max_batch"]))
    goal = int(traffic["prefill_windows"]) * system.params.edges_per_window
    while min(system.pos) < goal:
        system.ingest_round(obs, size)


def warm(system: System, loop: Loop, traffic: dict, obs: Observer) -> None:
    n = int(traffic["warm_requests"])
    tenants = np.arange(n) % max(system.tenants, 1) if system.tenants \
        else np.full(n, -1)
    u, t = loop.draw(tenants)
    system.serve(obs, system.requests(loop.mix, u, t))


class Span:
    """The window's last ``SPAN_S`` seconds, kept for the check: the
    program's state where they begin (the pipeline drained, every leaf
    copied on the device) and, in order, each ingest round's batches and
    each flush's requests and answers after it. The copy is the
    harness's memory, not the program's: ``peak`` leaves it out."""

    def __init__(self, system: System):
        dev = system.device
        system.server.state  # drains the ingest pipeline
        _sync(dev)
        cuda = dev.type == "cuda"
        self.peak_before = torch.cuda.max_memory_allocated(dev) if cuda \
            else 0
        a0 = torch.cuda.memory_allocated(dev) if cuda else 0
        self.snap = check.clone_leaves(system.leaves())
        self.nbytes = (torch.cuda.memory_allocated(dev) - a0) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        self.events = []  # ("ingest", sent) or ("flush", reqs, answers)
        self.opened = time.perf_counter()

    def rounds(self) -> int:
        return sum(e[0] == "ingest" for e in self.events)

    def peak(self, device) -> int:
        """The program's peak device memory over the run."""
        if device.type != "cuda":
            return 0
        return max(self.peak_before,
                   torch.cuda.max_memory_allocated(device) - self.nbytes)


def window(system: System, loop: Loop, obs: Observer, seconds: float):
    """The measured window. Returns (issue times, answer times, wall
    seconds, edges ingested, the ``Span`` of its last rounds)."""
    dev = system.device
    issued, answered = [], []
    span = None
    e0 = system.edges
    t0 = time.perf_counter()
    closed_ingest = loop.periodic is None
    mark = 5.0

    def ingest():
        sent = system.ingest_round(obs)
        if span is not None:
            span.events.append(("ingest", sent))

    def flush(took):
        reqs, got = _flush(system, loop, obs, took, t0, issued, answered)
        if span is not None:
            span.events.append(("flush", reqs, got))

    while True:
        now = time.perf_counter() - t0
        # the span opens outside the profiled part, and the window closes
        # once a traced run's profiled part is whole and the span holds a
        # round (or has waited SPAN_S for one: the check then fails)
        if span is None and now >= seconds - SPAN_S and \
                obs.state != "profiling":
            span = Span(system)
            now = time.perf_counter() - t0
        if now >= seconds and obs.state != "profiling" and \
                (span.rounds() or
                 time.perf_counter() - span.opened >= SPAN_S):
            break
        obs.tick(now, lambda: _sync(dev))
        if now >= mark:
            log(f"  {now:6.2f} s: {system.edges - e0} edges, "
                f"{len(answered)} answered")
            mark += 5.0
        if closed_ingest:
            ingest()
        else:
            for _ in loop.periodic.take(now):
                ingest()
        now = time.perf_counter() - t0
        took = list(loop.sched.take(now))
        if took:
            flush(took)
    obs.stop(lambda: _sync(dev))
    system.server.state  # drains the ingest pipeline
    took = list(loop.sched.take(time.perf_counter() - t0)) \
        if loop.kind == "open" else []
    if took:
        flush(took)
    _sync(dev)
    wall = time.perf_counter() - t0
    return (np.asarray(issued), np.asarray(answered), wall,
            system.edges - e0, span)


def _check_span(system: System, span: Span) -> dict:
    """The reference follows the span from its starting state: each
    round's batches applied in order, each flush's answers against the
    reference's state at that point, and at the end every leaf against
    the program's state at the close."""
    rcfg = system.rcfg
    ans_mm = 0
    for ev in span.events:
        if ev[0] == "ingest":
            for t, cols in ev[1]:
                ref.apply(rcfg, span.snap, system.rows_of(t, cols), cols)
        else:
            fleets = [(system.fleet(t), k, a) for t, k, a in ev[1]]
            ans_mm += check.answer_mismatch(rcfg, span.snap, fleets, ev[2])
    return dict(span_state_mismatch=check.leaf_mismatch(system.leaves(),
                                                        span.snap),
                span_answer_mismatch=ans_mm, span_rounds=span.rounds())


def _flush(system, loop, obs, took, t0, issued, answered):
    u, t = loop.draw(loop.tenant_of[took])
    reqs = system.requests(loop.mix, u, t)
    got = system.serve(obs, reqs)
    done = time.perf_counter() - t0
    for i in took:
        issued.append(loop.sched.issue_time(i))
        answered.append(done)
        if loop.kind == "closed":
            loop.sched.answered(i, done)
    return reqs, got


def _check_rounds(system: System, loop: Loop, traffic: dict, obs: Observer,
                  control: str | None) -> dict:
    """The check's rounds after the window (see ``check``): the serve loop
    goes on one round at a time (a batch, then ``check_requests``
    requests), and a round of a plane kind not yet checked (it rebuilds
    where a stream enters a new subwindow, and folds elsewhere) is checked
    against the reference."""
    rcfg = system.rcfg
    n_req = int(traffic["check_requests"])
    seen = {}
    state_mm = ans_mm = 0
    streams = range(max(system.tenants, 1))
    for _ in range(MAX_CHECK_ROUNDS):
        if {"folded", "built"} <= set(seen) or \
                sum(seen.values()) >= MAX_CHECKED:
            break
        kind = "built" if any(system.next_subwindow(t) for t in streams) \
            else "folded"
        snap = None if kind in seen else check.clone_leaves(system.leaves())
        c0 = _counters()
        sent = system.ingest_round(obs)
        u, t = loop.draw(loop.tenant_of[np.arange(n_req) %
                                        len(loop.tenant_of)])
        reqs = system.requests(loop.mix, u, t)
        got = system.serve(obs, reqs)
        if snap is None:
            continue
        c1 = _counters()
        fleets = [(system.fleet(tt), k, a) for tt, k, a in reqs]
        if control == check.CONTROL:  # answers from before the round
            got = check.reference_answers(rcfg, snap, fleets)
        for tt, cols in sent:
            ref.apply(rcfg, snap, system.rows_of(tt, cols), cols)
        state_mm += check.leaf_mismatch(system.leaves(), snap)
        ans_mm += check.answer_mismatch(rcfg, snap, fleets, got)
        del snap
        actual = "built" if c1["planes_build"] > c0["planes_build"] else \
            "folded" if c1["planes_delta"] > c0["planes_delta"] else "cached"
        seen[actual] = seen.get(actual, 0) + 1
    return dict(round_state_mismatch=state_mm,
                round_answer_mismatch=ans_mm, rounds=seen)


def _check_start(cfg: dict, traffic: dict, seed: int, device,
                 obs: Observer) -> int:
    """A fresh system's first set-up round into the empty state, against
    the reference's from nothing."""
    fresh = System(cfg, traffic, seed, device)
    size = int(traffic.get("prefill_batch", traffic["ingest"]["max_batch"]))
    sent = fresh.ingest_round(obs, size)
    mine = ref.empty_leaves(fresh.rcfg, max(fresh.tenants, 1) *
                            fresh.n_shards, device)
    for t, cols in sent:
        ref.apply(fresh.rcfg, mine, fresh.rows_of(t, cols), cols)
    return check.leaf_mismatch(fresh.leaves(), mine)


def run_cell(cat: Catalog, name: str, seed: int, seconds: float,
             traced: bool, device="cuda", t_start: float | None = None,
             control: str | None = None) -> dict:
    """One run: the result object (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cat.workload(name)
    traffic = cell["traffic"]
    cfg = cat.config(cell["config"])
    device = torch.device(device)
    obs = Observer(traced, PROFILE_FROM * seconds,
                   min(PROFILE_S, 0.5 * seconds))

    from repro_torch.telemetry.stream_stats import PARTITION_STATS
    system = System(cfg, traffic, seed, device)
    log(f"{name}: streams made")
    loop = Loop(traffic, system, seed, seconds)
    prefill(system, traffic, obs)
    log(f"prefilled {system.edges} edges")
    warm(system, loop, traffic, obs)
    _sync(device)
    obs.spans.clear()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s; the window opens; host "
        f"{placement(_pci(device))}")

    PARTITION_STATS.reset()
    c0 = _counters()
    m0 = _allocs(device)
    meter = HostMeter()
    issued, answered, wall, edges, span = window(system, loop, obs, seconds)
    c1 = _counters()
    log(f"host in the window {meter.read()}")
    log(f"window closed: {wall:.3f} s, {edges} edges, "
        f"{len(answered)} requests; device mallocs and frees "
        f"{[b - a for a, b in zip(m0, _allocs(device))]}")
    obs.counters = {k: c1[k] - c0[k] for k in c0}
    obs.counters["partition"] = PARTITION_STATS.snapshot()
    peak = span.peak(device)

    lat = schedule.latencies_ms(issued, answered)
    e2e = {"setup_s": setup_s, "ingest_eps": edges / wall,
           "query_p95_ms": schedule.p95(lat) if len(lat) else None,
           "query_rps": len(answered) / wall}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}

    metrics, breakdown = {}, None
    if traced:
        trace = reduce(obs.prof, obs.profiled[0]) if obs.prof else None
        now = system.leaves()
        view = types.SimpleNamespace(
            spans=obs.spans, counters=obs.counters, trace=trace,
            captures=obs.captures, cfg=system.rcfg, key_later=now["key"],
            pool_key_before=obs.pool_key_before,
            pool_key_after=obs.pool_key_after if obs.pool_key_after
            is not None else now["pool_key"])
        for m in cat.metrics(name, True):
            v = cat.reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if trace is not None:
            dev_info["busy_s"] = trace["busy_s"]
            dev_info["window_s"] = trace["window_s"]
            breakdown = trace["breakdown"]
        obs.captures.clear()
        obs.prof = None
        del view, trace, now
    else:
        for m in cat.metrics(name, False):
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the check: the window's last rounds, rounds after it, the start
    log(f"metrics read; the check starts ({span.rounds()} rounds in the "
        f"span)")
    checks = _check_span(system, span)
    del span
    rounds = _check_rounds(system, loop, traffic, obs, control)
    checks.update({k: v for k, v in rounds.items() if k != "rounds"})
    del system, loop
    torch.cuda.empty_cache() if device.type == "cuda" else None
    log(f"check rounds {rounds['rounds']}")
    checks["start_state_mismatch"] = _check_start(cfg, traffic, seed, device,
                                                  obs)
    log("check done")
    kinds_ok = {"folded", "built"} <= set(rounds["rounds"]) and \
        checks["span_rounds"] >= 1
    correct = kinds_ok and all(checks[k] <= check.LIMITS[k]
                               for k in check.LIMITS)
    out = {"correct": bool(correct), "attempted": int(len(issued)),
           "failed": int(len(issued) - len(answered)), "metrics": metrics,
           "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": checks[k], "limit": check.LIMITS[k]}
                     for k in check.LIMITS}
    out["checks"]["span_rounds"] = {"value": checks["span_rounds"],
                                    "limit": ">= 1"}
    for kind in ("folded", "built"):
        out["checks"]["rounds_" + kind] = {
            "value": rounds["rounds"].get(kind, 0), "limit": ">= 1"}
    return out
