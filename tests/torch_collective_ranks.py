"""Rank bodies of ``tests/test_torch_collective.py`` and
``tests/test_torch_router_telemetry.py``: the port's mesh-resident path on
gloo ranks, imported by the spawned ranks (no JAX here).

``run(world, ckpt_dir, shard_states)`` runs every case of one world size
on each rank of the group and returns, on rank 0, a dict of numpy results
keyed by case; the test holds them to ``repro`` and to the port's unplaced
handle. Checks that only a rank can make (its own block of rows, a
refusal, a warning) are asserted in the rank: a failing rank fails the
run with its traceback.
"""

from __future__ import annotations

import dataclasses
import importlib
import warnings

import numpy as np
import torch

from repro_torch import sketch as skt
from repro_torch.core import merge as tmerge
from repro_torch.core.gss import gss_config
from repro_torch.core.lgs import LGSConfig
from repro_torch.core.types import EdgeBatch, LSketchConfig

q_mod = importlib.import_module("repro_torch.sketch.query")

LS = dict(d=64, n_blocks=2, F=512, r=4, s=4, c=4, k=4, window_size=400,
          pool_capacity=256, pool_probes=8)
GS = dict(d=64, r=4, s=4, pool_capacity=256)
TINY = dict(d=8, n_blocks=2, F=256, r=2, s=2, c=4, k=4, window_size=400,
            pool_capacity=8, pool_probes=2)
CPU = "cpu"
HOT = 7
# (kind, shards) of the parity sweep at each world size
SWEEP = {4: (("lsketch", 4), ("lsketch", 8), ("gss", 4), ("gss", 8)),
         2: (("lsketch", 4), ("gss", 4)),
         1: (("lsketch", 2), ("gss", 4))}
MULTI_LASTS = [3, None, 1, 3, 2]
PLANE_LEAVES = ("key", "cw", "pw", "pool_key", "pool_cw", "pool_pw")


def config(kind: str, kw=None):
    if kind == "gss":
        return gss_config(**GS)
    return LSketchConfig(**(kw or LS))


def stream(kind, seed=11, n=600, tmax=2400, nv=50):
    """The seeded stream of the reference's mesh tests (``_SKETCH_PRELUDE``
    of ``tests/test_multidevice.py``)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, n).astype(np.int32)
    dst = rng.integers(0, nv, n).astype(np.int32)
    le = rng.integers(0, 5, n).astype(np.int32)
    w = rng.integers(1, 4, n).astype(np.int32)
    t = np.sort(rng.integers(0, tmax, n)).astype(np.int32)
    if kind == "gss":
        z = np.zeros(n, np.int32)
        return src, dst, z, z, z, w, z
    return src, dst, src % 3, dst % 3, le, w, t


def routed_stream():
    """Half the stream's sources rewritten to the hot key ``HOT``."""
    a = list(stream("lsketch", seed=23))
    take = np.random.default_rng(5).random(a[0].shape[0]) < 0.5
    a[0] = np.where(take, HOT, a[0]).astype(np.int32)
    a[2] = (a[0] % 3).astype(np.int32)
    return tuple(a)


def live_batch(seed, tlo=2300, thi=2400, n=64):
    """A flush inside one live subwindow (the delta stays valid)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 50, n).astype(np.int32)
    dst = rng.integers(0, 50, n).astype(np.int32)
    return (src, dst, src % 3, dst % 3,
            rng.integers(0, 5, n).astype(np.int32),
            rng.integers(1, 4, n).astype(np.int32),
            np.sort(rng.integers(tlo, thi, n)).astype(np.int32))


def wrap_late():
    return tuple(np.asarray(x, np.int32) for x in
                 ([9999], [0], [9998], [0], [0], [1],
                  [LSketchConfig(**LS).subwindow_size * 40]))


def stages(a, parts=2):
    n = a[0].shape[0]
    step = -(-n // parts)
    return [tuple(x[i:i + step] for x in a) for i in range(0, n, step)]


def suite(kind, a, lasts=None):
    """The reference's compact query suite: ``(constructor, args,
    kwargs)`` of every kind and direction, with and without the edge
    label, at each horizon of ``lasts`` (the full window only for
    gss)."""
    src, dst, la, lb, le = a[:5]
    if lasts is None:
        lasts = (None,) if kind == "gss" else (None, 1)
    vs = np.arange(40, dtype=np.int32)
    out = []
    for last in lasts:
        e = (src[:48], la[:48], dst[:48], lb[:48])
        out += [("edges", e, dict(last=last)),
                ("edges", e, dict(edge_label=le[:48], last=last)),
                ("vertices", (vs, vs % 3), dict(direction="out", last=last)),
                ("vertices", (vs, vs % 3), dict(direction="in", last=last)),
                ("labels", (np.arange(4, dtype=np.int32),),
                 dict(last=last))]
    return out


def make_query(mod, item):
    ctor, args, kw = item
    return getattr(mod.QueryBatch, ctor)(*args, **kw)


def _batch(a) -> EdgeBatch:
    return EdgeBatch(*[np.asarray(x, np.int32) for x in a])


def _answers(spec, st, items, paths=("scan", "cuda", "collective")):
    """{path: [int32 answers of every item]}."""
    return {p: [skt.query(spec, st, make_query(skt, it), path=p).numpy()
                for it in items] for p in paths}


def _leaves(spec, st):
    """Copies (a CPU tensor's numpy view would follow later ingests)."""
    return [x.copy() for x in skt.to_numpy(st, spec)]


def _same_planes(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in PLANE_LEAVES)


def _check_block(spec, st, host) -> None:
    """This rank holds exactly its block of the unplaced stack's rows."""
    ctx = skt.mesh_context(st)
    assert ctx is not None, "the MeshContext was lost"
    sl = ctx.block(spec.n_shards)
    mine, full = st.live().leaves(), host.live().leaves()
    assert all(torch.equal(x, y[sl]) for x, y in zip(mine, full)), \
        f"rank {ctx.rank}: its rows differ from the unplaced stack's"
    assert mine[0].shape[0] == sl.stop - sl.start


def _placed_and_host(spec, batches):
    """A placed and an unplaced handle fed the same batches."""
    st = skt.place(spec, skt.create(spec, CPU), skt.MeshContext())
    host = skt.create(spec, CPU)
    for b in batches:
        st = skt.ingest(spec, st, _batch(b))
        host = skt.ingest(spec, host, _batch(b))
    return st, host


def case_sweep(kind, ns):
    """Staged ingest: after each stage the placed leaves, the rows of
    this rank and every path's answers, beside the unplaced handle's."""
    spec = skt.SketchSpec(kind=kind, config=config(kind), n_shards=ns)
    a = stream(kind)
    items = suite(kind, a)
    st = skt.place(spec, skt.create(spec, CPU), skt.MeshContext())
    host = skt.create(spec, CPU)
    out = []
    for b in stages(a):
        st = skt.ingest(spec, st, _batch(b))
        host = skt.ingest(spec, host, _batch(b))
        _check_block(spec, st, host)
        out.append(dict(leaves=_leaves(spec, st), host=_leaves(spec, host),
                        answers=_answers(spec, st, items),
                        host_answers=_answers(spec, host, items,
                                              ("scan", "cuda"))))
    return out


def case_window_edges():
    """Ring wraparound far past the stream, and a saturated pool."""
    out = {}
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch"),
                          n_shards=4)
    a = stream("lsketch", seed=12, n=200, tmax=LS["window_size"] - 1)
    st, host = _placed_and_host(spec, [a, wrap_late()])
    out["wrap"] = dict(answers=_answers(spec, st, suite("lsketch", a)),
                       leaves=_leaves(spec, st), host=_leaves(spec, host))
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch", TINY),
                          n_shards=4)
    a = stream("lsketch", seed=13, n=500, tmax=1500, nv=400)
    st, host = _placed_and_host(spec, [a])
    out["overflow"] = dict(answers=_answers(spec, st, suite("lsketch", a)),
                           leaves=_leaves(spec, st),
                           host=_leaves(spec, host))
    return out


def case_routed():
    """A split hot key on a placed handle: placed routed ingest equals the
    unplaced one, and every path answers."""
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch"),
                          n_shards=4)
    routed = spec.with_splits([(HOT, HOT % 3, 4)])
    a = routed_stream()
    st, host = _placed_and_host(routed, [a])
    _check_block(routed, st, host)
    items = suite("lsketch", a, lasts=(None,))
    out = dict(leaves=_leaves(routed, st), host=_leaves(routed, host),
               answers=_answers(routed, st, items))
    # merge, compatibility and reshard read the gathered stack; a reshard
    # comes back host-resident
    for name, h in (("placed", st), ("unplaced", host)):
        wide = skt.reshard(routed, h, 2)
        assert skt.mesh_context(wide) is None
        out[name] = dict(
            merged=[x.numpy().copy()
                    for x in skt.merge_all(routed, h).leaves()],
            compatible=bool(skt.shards_compatible(routed, h)),
            reshard=skt.to_numpy(wide))
    return out


def case_lgs():
    """An ``lgs`` handle placed: ingest keeps its block and every host
    path answers as on the unplaced handle (``lgs`` queries take the
    scan, so "collective" resolves to it)."""
    spec = skt.SketchSpec(kind="lgs", config=LGSConfig(
        d=64, copies=3, c=4, k=4, window_size=400), n_shards=4)
    a = stream("lsketch")
    st, host = _placed_and_host(spec, stages(a))
    _check_block(spec, st, host)
    items = [it for it in suite("lsketch", a) if it[0] != "labels"]
    return dict(leaves=_leaves(spec, st), host=_leaves(spec, host),
                answers=_answers(spec, st, items),
                host_answers=_answers(spec, host, items, ("scan",)))


ANALYTICS = (("heavy_vertices", {"direction": "out"}),
             ("heavy_vertices", {"direction": "in", "last": 1}),
             ("heavy_edges", {}),
             ("top_labels", {}))


def case_analytics():
    """Top-k on every path of a placed 4-shard handle."""
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch"),
                          n_shards=4)
    st, _ = _placed_and_host(spec, [stream("lsketch")])
    return {(name, str(kw)): {p: [x.numpy() for x in getattr(skt, name)(
        spec, st, 6, path=p, **kw)] for p in ("scan", "cuda", "collective")}
        for name, kw in ANALYTICS}


def case_build_counts():
    """One collective plane build a horizon a handle, whatever the query
    kinds and sizes (``test_collective_compile_counts_and_device_plane_
    cache``)."""
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch"),
                          n_shards=8)
    a = stream("lsketch", seed=31)
    st, _ = _placed_and_host(spec, [a])
    src, dst, la, lb = a[:4]

    def edge_q(n, last=None):
        return skt.QueryBatch.edges(src[:n], la[:n], dst[:n], lb[:n],
                                    last=last)

    c = q_mod.PLANES_BUILD_COUNTS
    b0 = c["build"]
    for n in (20, 27, 40, 33):
        skt.query(spec, st, edge_q(n), path="collective")
    vs = np.arange(20, dtype=np.int32)
    skt.query(spec, st, skt.QueryBatch.vertices(vs, vs % 3),
              path="collective")
    skt.query(spec, st, skt.QueryBatch.labels([0, 1]), path="collective")
    counts = [c["build"] - b0]
    skt.query(spec, st, edge_q(20, last=1), path="collective")
    counts.append(c["build"] - b0)
    st2 = skt.ingest(spec, st, _batch(tuple(
        x[:64] for x in stream("lsketch", seed=32))))
    skt.query(spec, st2, edge_q(20), path="collective")
    counts.append(c["build"] - b0)
    # the collective entry is the rank's block, apart from the host one
    pl = skt.query_planes(spec, st2, collective=True)
    assert pl.cw.shape[0] == 8 // skt.mesh_context(st2).n_devices
    assert ("collective", 4) in q_mod._cache(st2) and \
        4 not in q_mod._cache(st2)
    return counts


def case_delta():
    """The collective plane cache across flushes: every fold equals a cold
    build, one fold a flush and no build, a moved ring rebuilds, and the
    delta-kept handle answers."""
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch"),
                          n_shards=8)
    st, host = _placed_and_host(spec, [stream("lsketch", seed=71, n=1600)])
    skt.query_planes(spec, st, collective=True)  # warm the cache
    c = q_mod.PLANES_BUILD_COUNTS
    b0, d0 = c["build"], c["delta"]
    folds_equal = []
    for i in range(4):
        b = live_batch(72 + i)
        st = skt.ingest(spec, st, _batch(b))
        host = skt.ingest(spec, host, _batch(b))
        inc = skt.query_planes(spec, st, collective=True)
        skt.clear_plane_cache(st)
        cold = skt.query_planes(spec, st, collective=True)
        folds_equal.append(_same_planes(inc, cold))
    counts = [c["delta"] - d0, c["build"] - b0]
    b = live_batch(90, tlo=2400, thi=2500)  # the ring moves: a build
    st = skt.ingest(spec, st, _batch(b))
    host = skt.ingest(spec, host, _batch(b))
    skt.query_planes(spec, st, collective=True)
    counts += [c["delta"] - d0, c["build"] - b0]
    b = live_batch(99, tlo=2400, thi=2500)
    st = skt.ingest(spec, st, _batch(b))
    host = skt.ingest(spec, host, _batch(b))
    a = stream("lsketch", seed=71, n=1600)
    return dict(folds_equal=folds_equal, counts=counts,
                leaves=_leaves(spec, st), host=_leaves(spec, host),
                answers=_answers(spec, st, suite("lsketch", a)))


def case_multi():
    """Horizon sweeps on the collective path: the stacked entry, a fold
    into it across a live flush, and the analytics sweep."""
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch"),
                          n_shards=8)
    a = stream("lsketch", seed=41, n=1600)
    st, host = _placed_and_host(spec, [a])
    src, dst, la, lb = a[:4]
    vs = np.arange(24, dtype=np.int32)
    items = [("edges", (src[:32], la[:32], dst[:32], lb[:32]),
              dict(last=MULTI_LASTS)),
             ("vertices", (vs, vs % 3), dict(last=MULTI_LASTS))]
    out = dict(cold=_answers(spec, st, items))
    mp, uniq = skt.query_planes_multi(spec, st, MULTI_LASTS,
                                      collective=True)
    out["uniq"] = uniq
    c = q_mod.PLANES_BUILD_COUNTS
    b0, d0 = c["build"], c["delta"]
    b = live_batch(42)
    st = skt.ingest(spec, st, _batch(b))
    host = skt.ingest(spec, host, _batch(b))
    mp2, _ = skt.query_planes_multi(spec, st, MULTI_LASTS, collective=True)
    out["counts"] = [c["build"] - b0, c["delta"] - d0]
    skt.clear_plane_cache(st)
    cold, _ = skt.query_planes_multi(spec, st, MULTI_LASTS, collective=True)
    out["fold_equal"] = _same_planes(mp2, cold)
    out["delta"] = _answers(spec, st, items)
    out["leaves"], out["host"] = _leaves(spec, st), _leaves(spec, host)
    sweeps = {}
    for fn in (skt.heavy_vertices, skt.top_labels):
        sweep = fn(spec, st, 5, horizons=[1, 2, 4], path="collective")
        single = [fn(spec, st, 5, last=h, path="collective")
                  for h in (1, 2, 4)]
        sweeps[fn.__name__] = all(
            torch.equal(x[i], y) for i, one in enumerate(single)
            for x, y in zip(sweep, one))
    out["analytics_sweep"] = sweeps
    return out


def case_psum_sketch(shard_states):
    """``psum_sketch`` of this rank's state (``shard_states[rank]``, a
    list of numpy leaves ``repro`` built)."""
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch"),
                          n_shards=1)
    rank = torch.distributed.get_rank()
    mine = skt.from_numpy(spec, shard_states[rank], CPU, plain=True)
    before = [x.clone() for x in mine.leaves()]
    out = tmerge.psum_sketch(spec.config, mine,
                             skt.MeshContext().group)
    assert all(torch.equal(x, y) for x, y in zip(before, mine.leaves())), \
        "psum_sketch changed its input"
    return [x.numpy() for x in out.leaves()]


def case_replicated():
    """3 shards over 2 ranks: one warning for two layouts, every rank
    holds and ingests every row, "collective" refuses, the host paths
    answer."""
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch"),
                          n_shards=3)
    ctx = skt.MeshContext()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        lay = skt.named_shardings(spec, ctx)
        skt.named_shardings(spec, ctx)
    assert len(rec) == 1 and "replicated" in str(rec[0].message), \
        [str(w.message) for w in rec]
    assert lay.shards.C == (None,) * 5, lay.shards.C
    spec4 = dataclasses.replace(spec, n_shards=4)
    assert skt.named_shardings(spec4, ctx).shards.C == \
        ("data",) + (None,) * 4
    a = stream("lsketch")
    st, host = _placed_and_host(spec, [a])
    assert st.live().key.shape[0] == 3
    _check_block(spec, st, host)
    items = suite("lsketch", a)
    for fn in (lambda: skt.query(spec, st, make_query(skt, items[0]),
                                 path="collective"),
               lambda: skt.query_planes(spec, st, collective=True),
               lambda: skt.heavy_vertices(spec, st, 4, path="collective")):
        try:
            fn()
        except ValueError as e:
            assert "divide the shard" in str(e), e
        else:
            raise AssertionError("collective answered on a replicated "
                                 "handle")
    return dict(answers=_answers(spec, st, items, ("scan", "cuda")),
                leaves=_leaves(spec, st), host=_leaves(spec, host))


def case_save(ckpt_dir):
    """The smoke handle, saved from its placed ranks."""
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch"),
                          n_shards=4)
    st, host = _placed_and_host(spec, [stream("lsketch")])
    skt.save(spec, st, ckpt_dir, step=3)
    return _leaves(spec, host)


def case_restore(ckpt_dir):
    """The world-4 checkpoint restored at this world size."""
    spec = skt.SketchSpec(kind="lsketch", config=config("lsketch"),
                          n_shards=4)
    st = skt.restore(spec, ckpt_dir, device=CPU, mesh=skt.MeshContext())
    ctx = skt.mesh_context(st)
    assert st.live().key.shape[0] == 4 // ctx.n_devices
    a = stream("lsketch")
    return dict(leaves=_leaves(spec, st),
                answers=_answers(spec, st, suite("lsketch", a)))


def run(world: int, ckpt_dir: str, shard_states=None) -> dict:
    """Every case of one world size (see the module docstring)."""
    out = {("sweep", k, ns): case_sweep(k, ns) for k, ns in SWEEP[world]}
    if world == 4:
        out["window_edges"] = case_window_edges()
        out["routed"] = case_routed()
        out["analytics"] = case_analytics()
        out["build_counts"] = case_build_counts()
        out["delta"] = case_delta()
        out["multi"] = case_multi()
        out["psum_sketch"] = case_psum_sketch(shard_states)
        out["saved"] = case_save(ckpt_dir)
    if world == 2:
        out["lgs"] = case_lgs()
        out["replicated"] = case_replicated()
        out["restored"] = case_restore(ckpt_dir)
    return out


def fail_on_rank_1() -> int:
    """Rank 1 raises while rank 0 waits in a collective for it."""
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.all_reduce(torch.zeros(1))
    return 0


# ---------------------------------------------------------------------------
# router telemetry (the cases of tests/test_telemetry.py)
# ---------------------------------------------------------------------------

def telemetry_cases(mod, paths, **kw) -> dict:
    """The controller reads of the four router-telemetry cases of
    ``tests/test_telemetry.py`` on ``mod``'s ``RouterTelemetry`` and
    ``CapacityController`` (``repro.telemetry`` or the port's), every
    telemetry built with ``kw`` (shards, mesh, device) but the
    single-shard twin of the sharded case. The reads are taken on each
    query path of ``paths`` in turn over the same ingested sketches:
    ``{path: {case: reads}}``, and ``"default"``, the path a telemetry
    chose for itself."""
    tele = mod.RouterTelemetry(n_experts=8, n_buckets=256, window_steps=64,
                               subwindows=8, **kw)
    default = tele.query_path
    rng = np.random.default_rng(0)
    for step in range(0, 32, 4):
        counts = rng.integers(0, 5, (256, 8))
        counts[:, 3] += 10  # expert 3 is hot
        tele.ingest(counts, step)

    expiring = mod.RouterTelemetry(n_experts=4, window_steps=16,
                                   subwindows=4, **kw)
    hot = np.zeros((256, 4), np.int64)
    hot[:, 1] = 5
    expiring.ingest(hot, step=0)  # an old burst on expert 1
    cold = np.zeros((256, 4), np.int64)
    cold[:10, 0] = 1
    for s in (4, 8, 12, 16):  # the window slides past step 0
        expiring.ingest(cold, step=s)

    plain = {k: v for k, v in kw.items() if k == "device"}
    one = mod.RouterTelemetry(n_experts=8, window_steps=16, subwindows=4,
                              **plain)
    many = mod.RouterTelemetry(n_experts=8, window_steps=16, subwindows=4,
                               **kw)
    rng = np.random.default_rng(2)
    for step in (0, 4, 8):
        counts = rng.integers(0, 4, (256, 8))
        one.ingest(counts, step)
        many.ingest(counts, step)

    skewed = mod.RouterTelemetry(n_experts=4, window_steps=16,
                                 subwindows=4, **kw)
    skew = np.zeros((256, 4), np.int64)
    skew[:, 0] = 20
    skew[:, 1:] = 1
    skewed.ingest(skew, step=0)
    even = mod.RouterTelemetry(n_experts=4, window_steps=16, subwindows=4,
                               **kw)
    even.ingest(np.full((256, 4), 3, np.int64), step=0)

    out = {"default": default}
    for p in paths:
        for t in (tele, expiring, many, skewed, even):
            t.query_path = p
        # the host-resident twin has no collective path
        one.query_path = "scan" if p == "collective" else p
        out[p] = dict(
            tracks=[np.asarray(tele.load_vector()),
                    np.asarray(tele.load_vector(last=2)), tele.imbalance(),
                    tele.routing_affinity(5, 3)],
            expires=[expiring.expert_load(1, last=2),
                     expiring.expert_load(1), expiring.expert_load(0, 1)],
            sharded=[[np.asarray(t.load_vector()),
                      np.asarray(t.load_vector(last=1)),
                      t.routing_affinity(5, 2), t.imbalance()]
                     for t in (one, many)],
            controller=[
                mod.CapacityController(skewed, lo=1.1, hi=1.5).update(1.25),
                mod.CapacityController(even, lo=1.1, hi=1.5).update(2.0)])
    return out


def telemetry_mesh(n_shards: int) -> dict:
    """``telemetry_cases`` of the port with ``mesh=`` over this group, on
    the collective path and both host paths."""
    from repro_torch import telemetry
    return telemetry_cases(telemetry, ("collective", "scan", "cuda"),
                           n_shards=n_shards, device=CPU,
                           mesh=skt.MeshContext())


# ---------------------------------------------------------------------------
# the mesh-resident sketch server (tests/test_torch_serve_sketch.py)
# ---------------------------------------------------------------------------

def serve_requests(st, n=64):
    """The edge, vertex and label requests of the sharded-server case."""
    rng = np.random.default_rng(1)
    idx = rng.integers(0, len(st), n)
    subs = [("edge", dict(src=int(st.src[i]), la=int(st.src_label[i]),
                          dst=int(st.dst[i]), lb=int(st.dst_label[i])))
            for i in idx]
    subs += [("edge", dict(src=int(st.src[i]), la=int(st.src_label[i]),
                           dst=int(st.dst[i]), lb=int(st.dst_label[i]),
                           le=int(st.edge_label[i]), last=1))
             for i in idx[:16]]
    subs += [("vertex", dict(v=int(st.src[i]), lv=int(st.src_label[i]),
                             direction=d)) for i in idx[:16]
             for d in ("out", "in")]
    subs += [("label", dict(lv=int(x), le=3, last=2)) for x in range(3)]
    return idx, subs


def serve_mesh(paths, n_shards: int = 4) -> dict:
    """For each query path of ``paths``, a ``SketchServer(mesh=...)`` over
    this group fed the server cases' stream: its requests' answers, a
    registered sweep, top-k and reachability, each gathered on rank 0
    (``{path: results}``); the refusals of a non-dividing group and of
    pool mode are checked in the ranks."""
    return {p: _serve_mesh(p, n_shards) for p in paths}


def _serve_mesh(path: str, n_shards: int) -> dict:
    from repro_torch.data.stream import PHONE, edge_batches, generate
    from repro_torch.launch import serve_sketch as ts
    st = generate(dataclasses.replace(PHONE, n_edges=3000, n_vertices=300),
                  seed=0)
    spec = ts.build_spec("lsketch", PHONE.window_size, n_shards)
    ctx = skt.MeshContext()
    server = ts.SketchServer(spec, mesh=ctx, query_path=path,
                             horizons=[1, 2], device=CPU)
    for b in edge_batches(st, 512):
        server.ingest(b)
    assert skt.mesh_context(server.state) is ctx
    idx, subs = serve_requests(st)
    reqs = [server.submit(k, **a) for k, a in subs]
    assert server.flush() == len(reqs)
    out = dict(answers=[r.answer for r in reqs],
               leaves=_leaves(spec, server.state))
    out["top_k"] = [[x.numpy() for x in server.top_k(kind, 8)]
                    for kind in ("vertex", "edge", "label")]
    sl = idx[:8]
    out["reachable"] = server.reachable(st.src[sl], st.src_label[sl],
                                        st.dst[sl], st.dst_label[sl],
                                        max_hops=3)
    q = skt.QueryBatch.edges(st.src[sl], st.src_label[sl], st.dst[sl],
                             st.dst_label[sl], last=[1, 2])
    out["sweep"] = skt.query(spec, server.state, q, path=path).numpy()
    odd = ts.build_spec("lsketch", PHONE.window_size, 3)
    for bad in (lambda: ts.SketchServer(odd, mesh=ctx,
                                        query_path="collective",
                                        device=CPU),
                lambda: ts.SketchServer(pool=skt.TenantPool(
                    spec, n_slots=2, device=CPU), mesh=ctx)):
        try:
            bad()
        except ValueError:
            pass
        else:
            raise AssertionError("a refused server was built")
    return out
