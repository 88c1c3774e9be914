"""The port's multi-tenant pool (``repro_torch.sketch.tenant``), the sketch
checkpoints it evicts through (``sketch/checkpoint.py``,
``distributed/checkpoint.py``), the grouped planes (``query_planes(...,
groups=)``) and the grouped entries of the edge-probe, vertex-scan, label
and top-k paths, on the CPU, exactly.

The cases of ``tests/test_tenant_pool.py`` at 1 and 2 shards a tenant:
pooled answers equal to standalone handles across window positions, ring
wraparound and pool overflow on both paths, evict and readmit into
another slot, LRU eviction, ``PoolFullError``, the flush order, pooled
delta upkeep and mixed static axes refused; the pooled states, answers
and top-k against ``repro``'s pool. The checkpoint seam in both
directions. The stacked-entry family pairing of the plane cache (a pooled
key beside a global stacked entry), and each grouped plain version at
G in {1, 3} (with empty groups) against its rows' standalone answers.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sketch as jskt
from repro.core.gss import gss_config as j_gss_config
from repro.core.lgs import LGSConfig as JLGSConfig
from repro.core.types import EdgeBatch as JBatch
from repro.core.types import LSketchConfig as JConfig
from repro.sketch.tenant import TenantPool as JPool

from repro_torch import sketch as tskt
from repro_torch.core.gss import gss_config
from repro_torch.core.lgs import LGSConfig
from repro_torch.core.queries import build_query_planes
from repro_torch.core.types import EdgeBatch, LSketchConfig
from repro_torch.kernels.heavy_hitters import ops as hh_ops
from repro_torch.kernels.sketch_query.kernel import edge_query_plain
from repro_torch.kernels.vertex_scan import ops as vs_ops
from repro_torch.kernels.vertex_scan.kernel import vertex_scan_plain

q_mod = importlib.import_module("repro_torch.sketch.query")

KW = dict(d=32, n_blocks=2, F=256, r=4, s=4, c=4, k=4, window_size=400,
          pool_capacity=256, pool_probes=8)
LS_CFG, J_LS_CFG = LSketchConfig(**KW), JConfig(**KW)
FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
          "time")
CPU = "cpu"
PATHS = ("scan", "cuda")


def _stream(seed, n=300, tmax=1200, n_vertices=50):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n)
    dst = rng.integers(0, n_vertices, n)
    return EdgeBatch.from_arrays(src, dst, src % 3, dst % 3,
                                 rng.integers(0, 5, n), rng.integers(1, 4, n),
                                 np.sort(rng.integers(0, tmax, n)))


def _jbatch(b: EdgeBatch) -> JBatch:
    return JBatch(*[jnp.asarray(getattr(b, f), jnp.int32) for f in FIELDS])


def _spec(kind="lsketch", ns=2, cfg=LS_CFG):
    return tskt.make_spec(kind, n_shards=ns, config=cfg)


def _query_suite(kind, n_queries=24, seed=7):
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 60, n_queries)
    qd = rng.integers(0, 60, n_queries)
    le = rng.integers(0, 5, n_queries)
    vs = np.arange(40)
    Q = tskt.QueryBatch
    for last in ((None,) if kind == "gss" else (None, 2)):
        yield Q.edges(qs, qs % 3, qd, qd % 3, last=last)
        yield Q.edges(qs, qs % 3, qd, qd % 3, edge_label=le, last=last)
        yield Q.vertices(vs, vs % 3, direction="out", last=last)
        yield Q.vertices(vs, vs % 3, edge_label=vs % 5, direction="in",
                         last=last)
        if kind != "lgs":
            yield Q.labels(np.arange(3), direction="out", last=last)
            yield Q.labels(np.arange(3), edge_label=[1, 2, 4],
                           direction="in", last=last)


def _assert_pool_matches(spec, pool, indep, kind, paths=PATHS, ctx=""):
    for qb in _query_suite(kind):
        for path in paths:
            pairs = [(t, qb) for t in sorted(indep)]
            for (t, _), a in zip(pairs, pool.query_many(pairs, path=path)):
                ref = tskt.query(spec, indep[t], qb, path=path)
                assert torch.equal(a, ref), (ctx, t, qb.kind, qb.direction,
                                             qb.last, path)


def _interleaved(spec, pool, indep, chunks):
    pool.submit(list(chunks.items()))
    for t, b in chunks.items():
        indep[t] = tskt.ingest(spec, indep[t], b)
    pool.flush()
    return indep


def _leaves_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(tskt.to_numpy(a),
                                                    tskt.to_numpy(b)))


# --------------------------------------------------------------------------
# the pool against standalone handles and against repro's pool
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,ns", [("lsketch", 1), ("lsketch", 2),
                                     ("gss", 1), ("lgs", 2)])
def test_pool_bit_identical_across_window_positions(kind, ns):
    cfg = {"lsketch": LS_CFG, "gss": gss_config(d=32),
           "lgs": LGSConfig()}[kind]
    jcfg = {"lsketch": J_LS_CFG, "gss": j_gss_config(d=32),
            "lgs": JLGSConfig()}[kind]
    spec = _spec(kind, ns, cfg)
    jspec = jskt.make_spec(kind, n_shards=ns, config=jcfg)
    T = 3
    pool = tskt.TenantPool(spec, n_slots=4, device=CPU)
    jpool = JPool(jspec, n_slots=4)
    indep = {t: tskt.create(spec, device=CPU) for t in range(T)}
    streams = {t: _stream(seed=20 + t) for t in range(T)}
    paths = ("scan",) if kind == "lgs" else PATHS
    for stage, a in enumerate(range(0, 300, 100)):
        chunks = {t: streams[t].slice(a, a + 100) for t in range(T)}
        indep = _interleaved(spec, pool, indep, chunks)
        jpool.submit([(t, _jbatch(b)) for t, b in chunks.items()])
        _assert_pool_matches(spec, pool, indep, kind, paths,
                             f"{kind} x{ns} stage {stage}")
    for x, y in zip(tskt.to_numpy(pool.state),
                    jax.tree.leaves(jpool.state.shards)):
        np.testing.assert_array_equal(x, np.asarray(y))
    # one pooled dispatch of each kind against repro's pool (scan path)
    qs = list(_query_suite(kind))[1::3]
    for qb in qs:
        pairs = [(t, qb) for t in range(T)]
        got = pool.query_many(pairs, path="scan")
        want = jpool.query_many(pairs, path="scan")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pool_window_isolation_on_wraparound():
    """One tenant's ring wraps far ahead; the others' windows must not
    move (the per-group lift)."""
    spec = _spec()
    pool = tskt.TenantPool(spec, n_slots=3, device=CPU)
    indep = {t: tskt.create(spec, device=CPU) for t in range(2)}
    base = {t: _stream(seed=30 + t, n=200, tmax=LS_CFG.window_size - 1)
            for t in range(2)}
    indep = _interleaved(spec, pool, indep, base)
    late = EdgeBatch.from_arrays([9999], [9998], [0], [0], [0], [1],
                                 [LS_CFG.subwindow_size * 40])
    indep = _interleaved(spec, pool, indep, {0: late})
    _assert_pool_matches(spec, pool, indep, "lsketch", ctx="wraparound")
    # a global lift would have expired tenant 1's window
    q = tskt.QueryBatch.vertices(np.arange(40), np.arange(40) % 3)
    assert int(pool.query(1, q, path="cuda").sum()) > 0


def test_pool_bit_identical_under_pool_overflow():
    cfg = LSketchConfig(d=8, n_blocks=2, F=256, r=2, s=2, c=4, k=4,
                        window_size=400, pool_capacity=8, pool_probes=2)
    spec = _spec(cfg=cfg)
    pool = tskt.TenantPool(spec, n_slots=2, device=CPU)
    indep = {t: tskt.create(spec, device=CPU) for t in range(2)}
    chunks = {t: _stream(seed=40 + t, n=400, tmax=1500, n_vertices=400)
              for t in range(2)}
    indep = _interleaved(spec, pool, indep, chunks)
    assert int(pool.state.shards.pool_lost.sum()) > 0, "pool must saturate"
    _assert_pool_matches(spec, pool, indep, "lsketch", ctx="overflow")


def test_top_k_many_matches_standalone_and_repro():
    spec = _spec()
    jspec = jskt.make_spec("lsketch", n_shards=2, config=J_LS_CFG)
    pool = tskt.TenantPool(spec, n_slots=3, device=CPU)
    jpool = JPool(jspec, n_slots=3)
    indep = {t: tskt.create(spec, device=CPU) for t in ("a", "b")}
    chunks = {t: _stream(seed=60 + i, n=300) for i, t in enumerate(indep)}
    indep = _interleaved(spec, pool, indep, chunks)
    jpool.submit([(t, _jbatch(b)) for t, b in chunks.items()])
    fns = {"vertex": tskt.heavy_vertices, "edge": tskt.heavy_edges,
           "label": tskt.top_labels}
    for kind, fn in fns.items():
        kw = {} if kind == "edge" else {"direction": "in"}
        for sel in ({"last": None}, {"last": 2}, {"horizons": [None, 1, 2]}):
            got = pool.top_k_many(["b", "a"], kind=kind, k=6, **kw, **sel)
            for t, g in zip(("b", "a"), got):
                want = fn(spec, indep[t], k=6, **kw, **sel)
                assert all(torch.equal(x, y) for x, y in zip(g, want)), (
                    kind, sel, t)
    got = pool.top_k("a", kind="edge", k=6, last=2)
    want = jpool.top_k("a", kind="edge", k=6, last=2)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    with pytest.raises(ValueError, match="not both"):
        pool.top_k_many(["a"], last=1, horizons=[1])


# --------------------------------------------------------------------------
# admission / eviction
# --------------------------------------------------------------------------

def test_evict_readmit_round_trip_different_slot(tmp_path):
    spec = _spec()
    pool = tskt.TenantPool(spec, n_slots=3, directory=tmp_path, device=CPU)
    indep = {t: tskt.create(spec, device=CPU) for t in ("a", "b")}
    chunks = {t: _stream(seed=50 + i, n=250) for i, t in enumerate(indep)}
    indep = _interleaved(spec, pool, indep, chunks)
    q = tskt.QueryBatch.vertices(np.arange(8), np.zeros(8, np.int32))
    before = pool.query("a", q, path="cuda")  # cached planes to invalidate
    slot_a = pool.slot_of("a")
    pool.evict("a")
    assert "a" not in pool.tenants
    assert tskt.saved_extra(tmp_path / "tenant-a") == {"tenant_id": "a"}
    pool.ingest("c", _stream(seed=60, n=100))
    assert pool.slot_of("c") == slot_a
    pool.attach("a")
    assert pool.slot_of("a") != slot_a
    assert torch.equal(pool.query("a", q, path="cuda"), before)
    _assert_pool_matches(spec, pool, {"a": indep["a"], "b": indep["b"]},
                         "lsketch", ctx="post-readmit")
    more = {"a": _stream(seed=70, n=150, tmax=2000),
            "b": _stream(seed=71, n=150, tmax=2000)}
    indep = _interleaved(spec, pool, indep, more)
    _assert_pool_matches(spec, pool, indep, "lsketch",
                         ctx="post-readmit ingest")


def test_handle_of_is_standalone_equivalent_in_fresh_storage():
    spec = _spec()
    pool = tskt.TenantPool(spec, n_slots=2, device=CPU)
    b = _stream(seed=80, n=200)
    pool.ingest("t", b)
    ref = tskt.ingest(spec, tskt.create(spec, device=CPU), b)
    hspec, hstate = pool.handle_of("t")
    assert hspec == spec and _leaves_equal(hstate, ref)
    pool.ingest("t", _stream(seed=81, n=200))  # writes the pool in place
    assert _leaves_equal(hstate, ref)
    q = tskt.QueryBatch.vertices(np.arange(16), np.zeros(16, np.int32))
    assert torch.equal(tskt.query(hspec, hstate, q), tskt.query(spec, ref, q))


def test_pool_full_raises_without_directory():
    spec = _spec(ns=1)
    pool = tskt.TenantPool(spec, n_slots=2, device=CPU)
    pool.attach("a")
    pool.attach("b")
    with pytest.raises(tskt.PoolFullError):
        pool.attach("c")
    assert sorted(pool.tenants) == ["a", "b"]
    with pytest.raises(ValueError, match="directory"):
        pool.evict("a")


def test_pool_full_lru_auto_evicts_with_directory(tmp_path):
    spec = _spec(ns=1)
    pool = tskt.TenantPool(spec, n_slots=2, directory=tmp_path, device=CPU)
    pool.ingest("a", _stream(seed=90, n=50))
    pool.ingest("b", _stream(seed=91, n=50))
    pool.query("a", tskt.QueryBatch.vertices(np.arange(4),
                                             np.zeros(4, np.int32)))
    slot_b = pool.slot_of("b")
    pool.attach("c")
    assert "b" not in pool.tenants and pool.slot_of("c") == slot_b
    assert tskt.saved_extra(tmp_path / "tenant-b") == {"tenant_id": "b"}
    pool.attach("b")  # readmitted, evicting the next-coldest ("a")
    assert "b" in pool.tenants and "a" not in pool.tenants


# --------------------------------------------------------------------------
# flush order, delta upkeep, the frontend
# --------------------------------------------------------------------------

def test_cross_tenant_flush_order_deterministic():
    spec = _spec()
    b = {t: [_stream(seed=100 + 10 * i + t, n=80) for i in range(2)]
         for t in range(3)}

    def run(rounds):
        pool = tskt.TenantPool(spec, n_slots=3, device=CPU)
        for t in range(3):
            pool.attach(t)
        for rnd in rounds:
            pool.submit(rnd)
        return pool.state

    s1 = run([[(0, b[0][0]), (1, b[1][0]), (2, b[2][0])],
              [(0, b[0][1]), (1, b[1][1]), (2, b[2][1])]])
    s2 = run([[(2, b[2][0]), (0, b[0][0]), (1, b[1][0])],
              [(1, b[1][1]), (2, b[2][1]), (0, b[0][1])]])
    assert _leaves_equal(s1, s2)


def test_within_tenant_submission_order_and_stagger():
    spec = _spec(ns=1)
    b1 = _stream(seed=110, n=60, tmax=300)
    b2 = _stream(seed=111, n=60, tmax=300)
    pool = tskt.TenantPool(spec, n_slots=1, device=CPU)
    st0 = pool.dispatched
    pool.submit([(0, b1), (0, b2)])
    assert pool.pending == 1 and pool.dispatched is st0
    ref = tskt.ingest(spec, tskt.ingest(spec, tskt.create(spec, device=CPU),
                                        b1), b2)
    assert _leaves_equal(pool.state, ref) and pool.pending == 0
    pool.submit({0: b1.slice(0, 0)})  # empty batches stage nothing
    assert pool.pending == 0


def test_pooled_planes_delta_maintenance():
    spec = _spec()
    pool = tskt.TenantPool(spec, n_slots=2, device=CPU)
    sub = LS_CFG.subwindow_size
    pool.submit([(0, _stream(seed=120, n=200, tmax=sub - 1)),
                 (1, _stream(seed=121, n=100, tmax=sub - 1))])
    pool.flush()
    qb = tskt.QueryBatch.vertices(np.arange(8), np.zeros(8, np.int32))
    before = dict(q_mod.PLANES_BUILD_COUNTS)
    pool.query(0, qb, path="cuda")  # cold: a build
    pool.query(0, qb, path="cuda")  # cached
    assert q_mod.PLANES_BUILD_COUNTS["build"] == before["build"] + 1
    pool.ingest(1, _stream(seed=122, n=150, tmax=sub - 1))
    got = pool.query(1, qb, path="cuda")  # a fold, not a build
    assert q_mod.PLANES_BUILD_COUNTS["delta"] == before["delta"] + 1
    assert q_mod.PLANES_BUILD_COUNTS["build"] == before["build"] + 1
    assert torch.equal(got, pool.query(1, qb, path="scan"))
    # the folded planes equal a cold build of the pooled handle
    st = pool.state
    folded = tskt.query_planes(spec, st, None, groups=2)
    tskt.clear_plane_cache(st)
    cold = tskt.query_planes(spec, st, None, groups=2)
    for f in ("key", "cw", "pw", "pool_key", "pool_cw", "pool_pw"):
        assert torch.equal(getattr(folded, f), getattr(cold, f)), f


def test_query_many_rejects_mixed_static_axes():
    spec = _spec(ns=1)
    pool = tskt.TenantPool(spec, n_slots=2, device=CPU)
    pool.ingest(0, _stream(seed=130, n=40))
    v, lv = np.arange(4), np.zeros(4, np.int32)
    vq = tskt.QueryBatch.vertices(v, lv, direction="out")
    eq = tskt.QueryBatch.edges(v, lv, v, lv)
    with pytest.raises(ValueError, match="kind/direction/last"):
        pool.query_many([(0, vq), (0, eq)])
    with pytest.raises(ValueError, match="edge_label presence"):
        pool.query_many([(0, vq), (0, tskt.QueryBatch.vertices(
            v, lv, edge_label=lv, direction="out"))])
    with pytest.raises(ValueError, match="collective"):
        pool.query_many([(0, vq)], path="collective")
    assert pool.query_many([]) == []


# --------------------------------------------------------------------------
# the checkpoint seam
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lsketch", "lgs"])
def test_checkpoints_cross_the_seam_both_ways(kind, tmp_path):
    cfg, jcfg = (LS_CFG, J_LS_CFG) if kind == "lsketch" else \
        (LGSConfig(d=16), JLGSConfig(d=16))
    spec = _spec(kind, 2, cfg).with_splits([(3, 0, 2)])
    jspec = jskt.make_spec(kind, n_shards=2, config=jcfg).with_splits(
        [(3, 0, 2)])
    b = _stream(seed=140, n=300)
    st = tskt.ingest(spec, tskt.create(spec, device=CPU), b)
    jst = jskt.ingest(jspec, jskt.create(jspec), _jbatch(b))
    tskt.save(spec, st, tmp_path / "port", step=3,
              extra={"tenant_id": "x"})
    jskt.save(jspec, jst, tmp_path / "ref", step=3,
              extra={"tenant_id": "x"})
    # the manifests match but for the time: keys from repro's checkpoint
    man = [json.loads((tmp_path / w / "step_00000003" /
                       "manifest.json").read_text()) for w in ("port", "ref")]
    for m in man:
        m.pop("time")
    assert man[0] == man[1]
    assert man[1]["keys"][0] == (".shards/.key" if kind == "lsketch"
                                 else ".shards/.C")
    # repro's checkpoint restores in the port, and the port's in repro
    back = tskt.restore(spec, tmp_path / "ref", device=CPU)
    assert _leaves_equal(back, st)
    assert tskt.saved_spec(tmp_path / "ref").routing == spec.routing
    assert tskt.saved_extra(tmp_path / "ref") == {"tenant_id": "x"}
    jback = jskt.restore(jspec, tmp_path / "port")
    for x, y in zip(tskt.to_numpy(st), jax.tree.leaves(jback.shards)):
        np.testing.assert_array_equal(x, np.asarray(y))
    q = tskt.QueryBatch.edges(b.src[:16], b.src_label[:16], b.dst[:16],
                              b.dst_label[:16], last=2)
    jq = jskt.QueryBatch.edges(b.src[:16], b.src_label[:16], b.dst[:16],
                               b.dst_label[:16], last=2)
    np.testing.assert_array_equal(tskt.query(spec, back, q).numpy(),
                                  np.asarray(jskt.query(jspec, jback, jq)))
    # into another shard count: repro's restore there, leaf for leaf
    four = tskt.restore(spec.replace(n_shards=4), tmp_path / "ref",
                        device=CPU)
    jfour = jskt.restore(jspec.replace(n_shards=4), tmp_path / "ref")
    for x, y in zip(tskt.to_numpy(four), jax.tree.leaves(jfour.shards)):
        np.testing.assert_array_equal(x, np.asarray(y))
    with pytest.raises(ValueError, match="incompatible"):
        tskt.restore(_spec("gss", 2, gss_config(d=16)), tmp_path / "ref",
                     device=CPU)


def test_async_save_snapshots_before_it_returns(tmp_path):
    spec = _spec()
    st = tskt.ingest(spec, tskt.create(spec, device=CPU), _stream(seed=150))
    want = [x.copy() for x in tskt.to_numpy(st)]
    mgr = tskt.save(spec, st, tmp_path, step=0, keep=2, blocking=False)
    st.shards.C.zero_()  # the in-place update the snapshot must not see
    mgr.wait()
    assert all(np.array_equal(x, y) for x, y in zip(
        tskt.to_numpy(tskt.restore(spec, tmp_path, device=CPU)), want))
    for step in (1, 2):
        tskt.save(spec, st, tmp_path, step=step, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001", "step_00000002"]


# --------------------------------------------------------------------------
# grouped planes and the grouped plain versions
# --------------------------------------------------------------------------

def test_stacked_entry_families_do_not_cross():
    """A pooled single-horizon key and a global stacked entry on one
    handle: a global miss must not read the pooled key, and neither
    family serves the other's horizons."""
    spec = _spec(ns=2)
    st = tskt.ingest(spec, tskt.create(spec, device=CPU), _stream(seed=160))
    tskt.query_planes(spec, st, 1, groups=2)  # ("pooled", 2, 1)
    multi, _ = tskt.query_planes_multi(spec, st, [None, 1])  # global
    before = dict(q_mod.PLANES_BUILD_COUNTS)
    got = tskt.query_planes(spec, st, None)  # served by the global entry
    assert q_mod.PLANES_BUILD_COUNTS == before
    assert torch.equal(got.cw, multi.cw[1])
    tskt.query_planes(spec, st, 2, groups=2)  # no pooled stacked entry
    assert q_mod.PLANES_BUILD_COUNTS["build"] == before["build"] + 1
    tskt.query_planes_multi(spec, st, [1, 3], groups=2)
    before = dict(q_mod.PLANES_BUILD_COUNTS)
    pooled = tskt.query_planes(spec, st, 3, groups=2)  # its pooled row
    assert q_mod.PLANES_BUILD_COUNTS == before
    tskt.query_planes(spec, st, 3)  # a global miss: not the pooled rows
    assert q_mod.PLANES_BUILD_COUNTS["build"] == before["build"] + 1
    assert torch.equal(pooled.cw, tskt.query_planes(spec, st, 3,
                                                    groups=2).cw)


def _pooled_planes(groups, per, seed=170):
    """Planes of ``groups`` tenants at ``per`` rows each, tenant g on a
    clock offset by g subwindows; tenant 1 empty. Returns (planes, the
    tenants' standalone planes)."""
    spec = _spec(ns=per)
    pool = tskt.TenantPool(spec, n_slots=groups, device=CPU)
    for g in range(groups):  # tenant g in slot g
        assert pool.attach(g) == g
        if g != 1:
            b = _stream(seed=seed + g, n=300, tmax=1000)
            b.time = b.time + g * LS_CFG.subwindow_size
            pool.ingest(g, b)
    pooled = tskt.query_planes(spec, pool.state, 2, groups=groups)
    alone = [tskt.query_planes(spec, pool.handle_of(g)[1], 2)
             for g in range(groups)]
    return spec, pooled, alone


def _group_queries(groups, Lq=24, seed=5):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 60, groups * Lq).astype(
        np.int32)) for _ in range(3)]


@pytest.mark.parametrize("groups", [1, 3])
def test_grouped_plain_versions_equal_their_rows_alone(groups):
    per = 2
    spec, pooled, alone = _pooled_planes(groups, per)
    cfg, Lq = spec.config, 24
    src, dst, le = _group_queries(groups, Lq)
    la, lb = src % 3, dst % 3
    w, wl = edge_query_plain(cfg, pooled, src, la, dst, lb, le,
                             groups=groups)
    assert w.shape == (1, groups * per, Lq)
    lines_pre, lines = vs_ops.scan_lines(cfg, src, la)
    bucket = le % cfg.c  # the scan takes label buckets
    for g in range(groups):
        qs, rows = slice(g * Lq, (g + 1) * Lq), slice(g * per, (g + 1) * per)
        aw, awl = edge_query_plain(cfg, alone[g], src[qs], la[qs], dst[qs],
                                   lb[qs], le[qs])
        assert torch.equal(w[:, rows], aw) and torch.equal(wl[:, rows], awl)
        for direction in ("out", "in"):
            sw, swl = vertex_scan_plain(
                lines, lines_pre.f, bucket, pooled.key, pooled.cw, pooled.pw,
                r=cfg.r, F=cfg.F, direction=direction, groups=groups)
            aw, awl = vertex_scan_plain(
                lines[qs], lines_pre.f[qs], bucket[qs], alone[g].key,
                alone[g].cw, alone[g].pw, r=cfg.r, F=cfg.F,
                direction=direction)
            assert torch.equal(sw[rows], aw) and torch.equal(swl[rows], awl)
            for fn, args in (
                    (vs_ops.vertex_query_planes, (src, (la, le))),
                    (vs_ops.label_aggregate_planes, (la % 2, le))):
                gw, gwl = fn(cfg, pooled, *args, direction=direction,
                             with_le=True, groups=groups)
                one = tuple(x[qs] if isinstance(x, torch.Tensor)
                            else tuple(y[qs] for y in x) for x in args)
                aw, awl = fn(cfg, alone[g], *one, direction=direction,
                             with_le=True)
                assert gw.shape == (groups * per, Lq)
                assert torch.equal(gw[rows], aw), (fn.__name__, direction)
                assert torch.equal(gwl[rows], awl), (fn.__name__, direction)
    # groups=1 is the plain entry, and the summed grouped edge answers
    if groups == 1:
        w1, _ = edge_query_plain(cfg, pooled, src, la, dst, lb, le)
        assert torch.equal(w1, w)
    from repro_torch.kernels.sketch_query.ops import edge_query_planes
    gw, _ = edge_query_planes(cfg, pooled, src, dst, (la, lb, le),
                              groups=groups)
    assert torch.equal(gw, w[0].view(groups, per, Lq).sum(1, dtype=torch.int64
                                                         ).to(torch.int32))
    # one decode, each group ranked alone
    for rank in (hh_ops.heavy_vertices_planes, hh_ops.heavy_edges_planes,
                 hh_ops.top_labels_planes):
        got = rank(cfg, pooled, 5, groups=groups)
        for g in range(groups):
            want = rank(cfg, alone[g], 5)
            assert all(torch.equal(x[g], y) for x, y in zip(got, want))


def test_pooled_planes_lift_the_window_per_group():
    spec, pooled, alone = _pooled_planes(3, 2)
    for f in ("key", "cw", "pw", "pool_key", "pool_cw", "pool_pw"):
        assert torch.equal(getattr(pooled, f), torch.cat(
            [getattr(a, f) for a in alone])), f
    # one global lift over the same rows would expire the lagging tenant
    stack = build_query_planes(spec.config, q_mod._with_global_window(
        torch_pool_shards(spec)), 2)
    assert not torch.equal(stack.cw, pooled.cw)


def torch_pool_shards(spec):
    pool = tskt.TenantPool(spec, n_slots=3, device=CPU)
    for g in range(3):
        pool.attach(g)
    for g in (0, 2):
        b = _stream(seed=170 + g, n=300, tmax=1000)
        b.time = b.time + g * LS_CFG.subwindow_size
        pool.ingest(g, b)
    return pool.state.live()
