"""Flush-delta plane maintenance and the pipelined ingest of the port
(``core/queries.py::PlanesDelta``/``apply_planes_delta(_multi)``,
``engine/insert.py``'s ``emit_delta``, ``sketch/query.py``'s delta chain
and multi-slice hits, ``sketch/ingest.py::AsyncIngestor``) on the CPU,
exact (the state is int32).

The cases of ``tests/test_query_path.py`` (the delta half),
``tests/test_multi_horizon.py`` (slice hits, the multi fold, the LRU) and
the seeded sweep of ``tests/test_planes_delta_property.py``: whatever
served the planes (a fold or a build), they equal a cold build at every
horizon, and the answers on them equal the scan path's. Against
``repro``: the ``build``/``delta``/``evict`` counts and the planes of one
scripted flush sequence, and ``AsyncIngestor``'s final state.
"""

import jax
import numpy as np
import pytest
import torch

import importlib

from repro import sketch as jskt
from repro.core.gss import gss_config as j_gss_config
from repro.core.types import EdgeBatch as JBatch
from repro.core.types import LSketchConfig as JConfig

from repro_torch import sketch as tskt
from repro_torch.core.gss import gss_config
from repro_torch.core.types import EdgeBatch, LSketchConfig

# the packages export a function ``query``, which hides the module
q_mod = importlib.import_module("repro_torch.sketch.query")
j_q_mod = importlib.import_module("repro.sketch.query")

KW = dict(d=64, n_blocks=2, F=512, r=4, s=4, c=4, k=4, window_size=400,
          pool_capacity=256, pool_probes=8)
LS_CFG = LSketchConfig(**KW)
LEAVES = ("key", "cw", "pw", "pool_key", "pool_cw", "pool_pw")
FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
          "time")
CPU = "cpu"


def _spec(ns, cfg=LS_CFG, kind="lsketch"):
    return tskt.make_spec(kind, n_shards=ns, config=cfg)


def _arrays_batch(src, dst, le, w, t, n_labels=3):
    return EdgeBatch.from_arrays(src, dst, src % n_labels, dst % n_labels, le,
                                 w, t)


def _stream(seed, n=600, tmax=2400, n_vertices=50):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n)
    dst = rng.integers(0, n_vertices, n)
    return _arrays_batch(src, dst, rng.integers(0, 5, n),
                         rng.integers(1, 4, n),
                         np.sort(rng.integers(0, tmax, n)))


def _live_batch(seed, n=64, tlo=2300, thi=2400, n_vertices=50):
    """One subwindow of the stream (subwindow 100): t in [tlo, thi)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n)
    dst = rng.integers(0, n_vertices, n)
    return _arrays_batch(src, dst, rng.integers(0, 5, n),
                         rng.integers(1, 4, n),
                         np.sort(rng.integers(tlo, thi, n)))


def _planes_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in LEAVES)


def _counts():
    return dict(q_mod.PLANES_BUILD_COUNTS)


def _moved(before):
    return {k: q_mod.PLANES_BUILD_COUNTS[k] - v for k, v in before.items()}


def _query_suite(n_queries=32, seed=7):
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 60, n_queries)
    qd = rng.integers(0, 60, n_queries)
    le = rng.integers(0, 5, n_queries)
    vs = np.arange(40)
    Q = tskt.QueryBatch
    for last in (None, 1, 2):
        yield Q.edges(qs, qs % 3, qd, qd % 3, last=last)
        yield Q.edges(qs, qs % 3, qd, qd % 3, edge_label=le, last=last)
        for direction in ("out", "in"):
            yield Q.vertices(vs, vs % 3, edge_label=vs % 5,
                             direction=direction, last=last)
            yield Q.labels(np.arange(4), direction=direction, last=last)


def _assert_paths_agree(spec, state, ctx=""):
    """Answers on the (folded) planes equal the dense scan path's."""
    for qb in _query_suite():
        a = tskt.query(spec, state, qb, path="scan")
        b = tskt.query(spec, state, qb, path="cuda")
        assert torch.equal(a, b), (ctx, qb.kind, qb.last, qb.direction)


def _cold_copy(state):
    """A fresh handle over copies of a handle's tensors (a cold cache)."""
    return tskt.ShardedState(state.live().map(torch.clone))


def _assert_folds_equal_cold(spec, state, horizons):
    """Every horizon's planes as the handle serves them, then a cold build
    of each after the cache and the pending chain are dropped."""
    inc = [tskt.query_planes(spec, state, h) for h in horizons]
    tskt.clear_plane_cache(state)
    for h, planes in zip(horizons, inc):
        assert _planes_equal(planes, tskt.query_planes(spec, state, h)), h


def _base(ns, seed, cfg=LS_CFG, **kw):
    spec = _spec(ns, cfg)
    state = tskt.ingest(spec, tskt.create(spec, device=CPU),
                        _stream(seed, **kw))
    return spec, state


@pytest.mark.parametrize("ns", [1, 4])
def test_planes_delta_bit_identical_every_horizon(ns):
    spec, state = _base(ns, 51)
    for last in (None, 1, 2):  # warm every horizon's entry
        tskt.query_planes(spec, state, last)
    before = _counts()
    state2 = tskt.ingest(spec, state, _live_batch(52))
    _assert_folds_equal_cold(spec, state2, (None, 1, 2, LS_CFG.k + 5))
    assert _moved(before)["delta"] == 3 and _moved(before)["build"] == 3
    state3 = tskt.ingest(spec, state2, _live_batch(53))
    _assert_paths_agree(spec, state3, f"delta x{ns}")


@pytest.mark.parametrize("ns", [1, 4])
def test_planes_delta_horizon_gating_on_stale_slot(ns):
    """A late flush into an older, still-claimed subwindow adds to the
    whole window's planes but not to a horizon that excludes its slot."""
    spec, state = _base(ns, 54)
    for last in (None, 1, 2):
        tskt.query_planes(spec, state, last)
    state2 = tskt.ingest(spec, state, _live_batch(55, tlo=2200, thi=2300))
    before = _counts()
    _assert_folds_equal_cold(spec, state2, (None, 1, 2))
    assert _moved(before)["delta"] == 3
    _assert_paths_agree(spec, state2, f"stale-slot x{ns}")


def test_planes_delta_fallback_on_ring_movement():
    """A window advance (a slot reset) and a flush spanning subwindows
    make the delta unusable: the planes are built, still exact."""
    spec, state = _base(4, 56)
    tskt.query_planes(spec, state)
    before = _counts()
    st_adv = tskt.ingest(spec, state, _live_batch(57, tlo=2400, thi=2450))
    tskt.query_planes(spec, st_adv)
    assert _moved(before)["build"] == 1 and _moved(before)["delta"] == 0
    _assert_paths_agree(spec, st_adv, "advance fallback")
    tskt.query_planes(spec, st_adv)
    before = _counts()
    st_span = tskt.ingest(spec, st_adv, _live_batch(58, tlo=2400, thi=2600))
    tskt.query_planes(spec, st_span)
    assert _moved(before)["build"] == 1 and _moved(before)["delta"] == 0


@pytest.mark.parametrize("path", ["scan", "cuda"])
def test_planes_delta_chain_resolution_and_overflow_cap(path):
    """Flushes with no query between them chain and resolve in one go;
    past MAX_DELTA_CHAIN the chain is dropped and the next query builds.
    Both insert routes record the delta."""
    spec, state = _base(2, 59)
    tskt.query_planes(spec, state)
    before = _counts()
    st = state
    for i in range(3):
        st = tskt.ingest(spec, st, _live_batch(60 + i), path=path)
    inc = tskt.query_planes(spec, st)
    assert _moved(before)["delta"] == 1 and _moved(before)["build"] == 0
    tskt.clear_plane_cache(st)
    assert _planes_equal(inc, tskt.query_planes(spec, st))

    before = _counts()
    for i in range(q_mod.MAX_DELTA_CHAIN + 2):
        st = tskt.ingest(spec, st, _live_batch(80 + i), path=path)
    tskt.query_planes(spec, st)
    assert _moved(before)["delta"] == 0 and _moved(before)["build"] == 1


def test_planes_delta_under_pool_overflow():
    cfg = LSketchConfig(d=8, n_blocks=2, F=256, r=2, s=2, c=4, k=4,
                        window_size=400, pool_capacity=8, pool_probes=2)
    spec, state = _base(2, 61, cfg, n=500, tmax=1500, n_vertices=400)
    assert int(state.shards.pool_lost.sum()) > 0, "the pool must saturate"
    tskt.query_planes(spec, state)
    d0 = q_mod.PLANES_BUILD_COUNTS["delta"]
    state2 = tskt.ingest(spec, state, _live_batch(62, tlo=1400, thi=1500,
                                                  n_vertices=400))
    inc = tskt.query_planes(spec, state2)
    assert q_mod.PLANES_BUILD_COUNTS["delta"] == d0 + 1
    tskt.clear_plane_cache(state2)
    assert _planes_equal(inc, tskt.query_planes(spec, state2))
    _assert_paths_agree(spec, state2, "pool-overflow delta")


def test_async_ingestor_steady_state_builds_stay_flat():
    """Pipelined flushes through ``AsyncIngestor.state`` with a query after
    each: after the first build the planes are kept by folds alone."""
    spec = _spec(4)
    qb = tskt.QueryBatch.vertices(np.arange(30), np.arange(30) % 3)
    ing = tskt.AsyncIngestor(spec, device=CPU)
    ing.submit(_stream(63))
    tskt.query(spec, ing.state, qb, path="cuda")  # the first build
    before = _counts()
    for i in range(6):
        ing.submit(_live_batch(64 + i))
        st = ing.state
        got = tskt.query(spec, st, qb, path="cuda")
        assert torch.equal(got, tskt.query(spec, st, qb, path="scan"))
    assert _moved(before)["build"] == 0 and _moved(before)["delta"] == 6


# -- horizon-stacked entries (tests/test_multi_horizon.py) -----------------

def test_single_horizon_slices_cached_multi_entry():
    spec, state = _base(2, 3)
    before = _counts()
    tskt.query_planes_multi(spec, state, [1, 2, 3])
    sliced = {h: tskt.query_planes(spec, state, h) for h in (1, 2, 3)}
    assert _moved(before)["build"] == 1
    assert _moved(before)["build-multi"] == 1
    before = _counts()
    tskt.query_planes(spec, state, 4)  # not covered: its own build
    assert _moved(before)["build"] == 1
    for h, planes in sliced.items():
        cold = tskt.query_planes(spec, _cold_copy(state), h)
        assert _planes_equal(planes, cold), h


def test_multi_entry_rides_planes_delta_across_flush():
    spec, state = _base(2, 11)
    hs = [1, 2, 3, 4]
    tskt.query_planes_multi(spec, state, hs)
    before = _counts()
    state = tskt.ingest(spec, state, _live_batch(12))
    inc, _ = tskt.query_planes_multi(spec, state, hs)
    assert _moved(before)["build"] == 0
    assert _moved(before)["delta"] == _moved(before)["delta-multi"] == 1
    tskt.clear_plane_cache(state)
    cold, _ = tskt.query_planes_multi(spec, state, hs)
    assert _planes_equal(inc, cold)


def test_plane_cache_lru_evicts_and_counts(monkeypatch):
    spec, state = _base(2, 13)
    monkeypatch.setattr(q_mod, "PLANES_CACHE_CAP", 2)
    before = q_mod.PLANES_BUILD_COUNTS["evict"]
    for h in (1, 2, 3, 4):
        tskt.query_planes(spec, state, h)
    cache = getattr(state, q_mod._PLANES_ATTR)
    assert list(cache) == [3, 4]
    assert q_mod.PLANES_BUILD_COUNTS["evict"] - before == 2
    tskt.query_planes(spec, state, 3)
    tskt.query_planes(spec, state, 1)
    assert list(getattr(state, q_mod._PLANES_ATTR)) == [3, 1]


# -- the seeded sweep of tests/test_planes_delta_property.py ---------------

SWEEP_LS = LSketchConfig(d=16, n_blocks=2, F=256, r=2, s=2, c=4, k=4,
                         window_size=400, pool_capacity=64, pool_probes=4)
SWEEP_TINY = LSketchConfig(d=8, n_blocks=2, F=256, r=2, s=2, c=4, k=4,
                           window_size=400, pool_capacity=8, pool_probes=2)
SWEEP_GSS = gss_config(d=16)


def _sweep_batch(rng, kind, n, tlo, thi, n_vertices):
    src = rng.integers(0, n_vertices, n)
    dst = rng.integers(0, n_vertices, n)
    if kind == "gss":
        return EdgeBatch.from_arrays(src, dst, weight=rng.integers(1, 4, n))
    return _arrays_batch(src, dst, rng.integers(0, 5, n),
                         rng.integers(1, 4, n),
                         np.sort(rng.integers(tlo, thi, n)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind,ns", [(k, n) for k in ("lsketch", "gss")
                                     for n in (1, 4)])
def test_incremental_planes_property(kind, ns, seed):
    """For live appends, late arrivals, window advances and pool overflow,
    in any order, the planes after each flush equal a cold build at every
    horizon, whatever served them."""
    rng = np.random.default_rng(1000 + seed)
    n_flushes = int(rng.integers(1, 4))
    placements = [("live", "late", "advance")[int(x)]
                  for x in rng.integers(0, 3, 3)]
    tiny = bool(seed % 2) and kind == "lsketch"
    cfg = SWEEP_GSS if kind == "gss" else (SWEEP_TINY if tiny else SWEEP_LS)
    n_vertices = 400 if tiny else 60
    spec = _spec(ns, cfg, kind)
    horizons = (None,) if kind == "gss" else (None, 1, 2)
    sw, tmax = max(cfg.subwindow_size, 1), 1600
    state = tskt.ingest(spec, tskt.create(spec, device=CPU), _sweep_batch(
        rng, kind, 512 if tiny else 256, 0, tmax, n_vertices))
    if tiny:
        assert int(state.shards.pool_lost.sum()) > 0
    for h in horizons:
        tskt.query_planes(spec, state, h)
    for i in range(n_flushes):
        placement = placements[i]
        if placement == "live":
            tlo, thi = tmax - sw, tmax
        elif placement == "late":
            tlo, thi = tmax - 2 * sw, tmax - sw
        else:
            tlo, thi = tmax, tmax + sw
            tmax += sw
        state = tskt.ingest(spec, state, _sweep_batch(rng, kind, 64, tlo, thi,
                                                      n_vertices))
        _assert_folds_equal_cold(spec, state, horizons)


# -- against repro ---------------------------------------------------------

def _jbatch(b: EdgeBatch) -> JBatch:
    return JBatch(*[jax.numpy.asarray(getattr(b, f), jax.numpy.int32)
                    for f in FIELDS])


def _planes_match_jax(tp, jp) -> bool:
    return all(np.array_equal(np.asarray(getattr(jp, f)),
                              getattr(tp, f).numpy()) for f in LEAVES)


@pytest.mark.parametrize("kind", ["lsketch", "gss"])
def test_counts_and_planes_follow_reference(kind):
    """One scripted sequence of flushes and plane lookups (single and
    stacked, a stale slot, a chain, an advance, a spanning flush, the
    chain cap, a cleared cache) through ``repro`` and the port: the
    ``build``/``delta``/``evict`` counts move alike at every step and the
    planes are equal."""
    cfg = LS_CFG if kind == "lsketch" else gss_config(d=64)
    jcfg = JConfig(**KW) if kind == "lsketch" else j_gss_config(d=64)
    tspec = tskt.make_spec(kind, n_shards=4, config=cfg)
    jspec = jskt.SketchSpec(kind=kind, config=jcfg, n_shards=4)
    hs = [None, 1, 2]
    script = [("ingest", _stream(70)), ("single", None), ("single", 1),
              ("multi", hs), ("ingest", _live_batch(71)), ("single", 2),
              ("multi", hs), ("single", None),
              ("ingest", _live_batch(72, tlo=2200, thi=2300)),
              ("ingest", _live_batch(73)), ("single", 1), ("multi", hs),
              ("ingest", _live_batch(74, tlo=2400, thi=2450)),
              ("single", None), ("ingest", _live_batch(75, tlo=2400,
                                                       thi=2600)),
              ("multi", hs), ("single", 3)]
    script += [("ingest", _live_batch(80 + i, tlo=2500, thi=2600))
               for i in range(q_mod.MAX_DELTA_CHAIN + 1)]
    script += [("single", None), ("clear", None), ("multi", hs),
               ("ingest", _live_batch(90, tlo=2500, thi=2600)),
               ("single", 1)]
    tst, jst = tskt.create(tspec, device=CPU), jskt.create(jspec)
    for step, (op, arg) in enumerate(script):
        tb, jb = _counts(), dict(j_q_mod.PLANES_BUILD_COUNTS)
        if op == "ingest":
            tst = tskt.ingest(tspec, tst, arg)
            jst = jskt.ingest(jspec, jst, _jbatch(arg))
        elif op == "single":
            assert _planes_match_jax(tskt.query_planes(tspec, tst, arg),
                                     jskt.query_planes(jspec, jst, arg))
        elif op == "multi":
            tp, tu = tskt.query_planes_multi(tspec, tst, arg)
            jp, ju = jskt.query_planes_multi(jspec, jst, arg)
            assert tu == ju and _planes_match_jax(tp, jp)
        else:
            tskt.clear_plane_cache(tst)
            jskt.clear_plane_cache(jst)
        moved = _moved(tb)
        want = {k: j_q_mod.PLANES_BUILD_COUNTS[k] - v for k, v in jb.items()}
        assert {k: moved[k] for k in want} == want, (step, op, arg)
    assert q_mod.PLANES_BUILD_COUNTS["delta"] > 0


# -- AsyncIngestor (tests/test_sketch_api.py) ------------------------------

def test_async_ingestor_matches_sync_and_reference():
    """Pipelined ingest of a chunked stream, with queries between the
    submissions, ends leaf for leaf equal to synchronous ``ingest`` of
    the same chunks and to ``repro``'s ``AsyncIngestor``; every query sees
    every batch submitted before it."""
    b = _stream(30, n=1200, tmax=3000, n_vertices=400)
    small = dict(KW, d=8, pool_capacity=16)  # the pool overflows
    tspec = _spec(4, LSketchConfig(**small))
    jspec = jskt.make_spec("lsketch", n_shards=4, config=JConfig(**small))
    ing, jing = tskt.AsyncIngestor(tspec, device=CPU), \
        jskt.AsyncIngestor(jspec)
    sync = tskt.create(tspec, device=CPU)
    q = tskt.QueryBatch.edges(b.src[:16], b.src_label[:16], b.dst[:16],
                              b.dst_label[:16])
    jq = jskt.QueryBatch.edges(b.src[:16], b.src_label[:16], b.dst[:16],
                               b.dst_label[:16])
    for i, a in enumerate(range(0, len(b), 256)):
        chunk = b.slice(a, a + 256)
        ing.submit(chunk)
        jing.submit(_jbatch(chunk))
        sync = tskt.ingest(tspec, sync, chunk)
        if i % 2 == 1:  # on the planes: the next flush records a delta
            got = tskt.query(tspec, ing.state, q, path="cuda")
            assert ing.pending == 0
            assert torch.equal(got, tskt.query(tspec, sync, q))
            np.testing.assert_array_equal(
                np.asarray(jskt.query(jspec, jing.state, jq,
                                      path="pallas")), got.numpy())
    final = ing.flush()
    assert int(final.shards.pool_lost.sum()) > 0
    for x, y, z in zip(tskt.to_numpy(final), tskt.to_numpy(sync),
                       jax.tree.leaves(jing.flush().shards)):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, np.asarray(z))


def test_async_ingestor_flush_contract():
    spec = _spec(2)
    ing = tskt.AsyncIngestor(spec, device=CPU)
    st0 = ing.flush()
    assert ing.flush() is st0 and ing.pending == 0
    ing.submit(_stream(31).slice(0, 0))  # an empty batch: a no-op
    assert ing.pending == 0 and ing.flush() is st0
    batch = _stream(31).slice(0, 64)
    ing.submit(batch)
    assert ing.pending == 1 and ing.dispatched is st0
    st1 = ing.flush()
    assert ing.pending == 0 and st1 is not st0 and st0.spent
    assert ing.flush() is st1 and ing.state is st1
    ref = tskt.ingest(spec, tskt.create(spec, device=CPU), batch)
    for x, y in zip(tskt.to_numpy(st1), tskt.to_numpy(ref)):
        np.testing.assert_array_equal(x, y)
    routed = tskt.AsyncIngestor(spec, device=CPU, heat_threshold=0.1)
    assert isinstance(routed.detector, tskt.HeavyKeyDetector)
