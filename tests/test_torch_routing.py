"""Skew-aware routing of the port (``repro_torch.sketch.routing``, the
spec's ``routing`` field, ``ingest``'s routed partition and
``PARTITION_STATS``, ``AsyncIngestor``'s auto-split) against ``repro`` on
the CPU, exactly.

The cases of ``tests/test_routing.py`` without the three reshard cases
(``tests/test_torch_reshard.py`` holds those): the detector's counts one-sided and its
total exact, routing tables normalised and validated, routing carried in
JSON but left out of identity, ``routed_assignment`` bit for bit with
``repro``'s with and without splits, routed ingest and the
``AsyncIngestor`` auto-split leaf for leaf against ``repro``'s, and
``recommend_budget`` / ``prune_routing`` against ``repro``'s.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sketch as jskt
from repro.core.types import EdgeBatch as JBatch
from repro.core.types import LSketchConfig as JConfig
from repro.sketch import routing as jrouting
from repro.telemetry.stream_stats import PARTITION_STATS as J_STATS

from repro_torch import sketch as tskt
from repro_torch.core.types import EdgeBatch, LSketchConfig
from repro_torch.sketch import routing as trouting
from repro_torch.telemetry.stream_stats import PARTITION_STATS

q_mod = importlib.import_module("repro_torch.sketch.query")

KW = dict(d=32, n_blocks=2, F=256, r=4, s=4, c=4, k=4, window_size=400,
          pool_capacity=512, pool_probes=8)
CFG, JCFG = LSketchConfig(**KW), JConfig(**KW)
FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
          "time")
HOT = 7  # the planted heavy source vertex (label HOT % 3 = 1)
CPU = "cpu"


def _heavy(seed=0, n=400, frac=0.5, tmax=KW["window_size"] - 1):
    """A stream whose source is HOT for about ``frac`` of the edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 40, n)
    dst = rng.integers(0, 40, n)
    take = np.random.default_rng(seed + 1).random(n) < frac
    src[take] = HOT
    return EdgeBatch.from_arrays(src, dst, src % 3, dst % 3,
                                 rng.integers(0, 5, n), rng.integers(1, 4, n),
                                 np.sort(rng.integers(0, tmax, n)))


def _jbatch(b: EdgeBatch) -> JBatch:
    return JBatch(*[jnp.asarray(getattr(b, f), jnp.int32) for f in FIELDS])


def _specs(ns, routing=None):
    t = tskt.make_spec("lsketch", n_shards=ns, config=CFG)
    j = jskt.make_spec("lsketch", n_shards=ns, config=JCFG)
    if routing is not None:
        t = t.replace(routing=trouting.RoutingTable(routing))
        j = j.replace(routing=jrouting.RoutingTable(routing))
    return t, j


def _states_equal(tstate, jstate):
    for x, y in zip(tskt.to_numpy(tstate), jax.tree.leaves(jstate.shards)):
        np.testing.assert_array_equal(x, np.asarray(y))


def _truth(b: EdgeBatch) -> dict:
    out: dict = {}
    for i in range(len(b)):
        key = (int(b.src[i]), int(b.src_label[i]), int(b.dst[i]),
               int(b.dst_label[i]))
        out[key] = out.get(key, 0) + int(b.weight[i])
    return out


# --------------------------------------------------------------------------
# HeavyKeyDetector
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [8, 64])
def test_detector_counts_one_sided_and_total_exact(capacity):
    b = _heavy(seed=3, n=600, frac=0.3)
    det, jdet = trouting.HeavyKeyDetector(capacity), \
        jrouting.HeavyKeyDetector(capacity)
    for a in range(0, 600, 150):
        det.update(b.src[a:a + 150], b.src_label[a:a + 150])
        jdet.update(b.src[a:a + 150], b.src_label[a:a + 150])
    assert det.total == jdet.total == 600
    assert det.counts == jdet.counts
    assert len(det.counts) <= capacity
    true: dict = {}
    for s, l in zip(b.src.tolist(), b.src_label.tolist()):
        true[(s, l)] = true.get((s, l), 0) + 1
    for key, c in det.counts.items():
        assert c >= true.get(key, 0)  # space-saving never under-counts
    assert det.hot_keys(0.2) == jdet.hot_keys(0.2)
    assert det.hot_keys(0.2)[0][:2] == (HOT, HOT % 3)
    with pytest.raises(ValueError):
        trouting.HeavyKeyDetector(0)


def test_routing_table_normalization_and_validation():
    t = trouting.RoutingTable(((9, 1, 3), (2, 0, 2)))
    assert t.splits == ((2, 0, 2), (9, 1, 3))
    assert t == trouting.RoutingTable(((2, 0, 2), (9, 1, 3)))
    assert t.splits == jrouting.RoutingTable(((9, 1, 3), (2, 0, 2))).splits
    np.testing.assert_array_equal(t.replicas([9, 2, 5], [1, 0, 0]),
                                  [3, 2, 1])
    assert not trouting.RoutingTable() and t
    with pytest.raises(ValueError, match="duplicate"):
        trouting.RoutingTable(((1, 0, 2), (1, 0, 3)))
    with pytest.raises(ValueError, match="n_replicas"):
        trouting.RoutingTable(((1, 0, 1),))
    assert t.merged([(9, 1, 4), (5, 5, 2)]).splits == \
        ((2, 0, 2), (5, 5, 2), (9, 1, 4))


def test_routing_is_identity_excluded_and_json_carried():
    base, jbase = _specs(4)
    split = base.with_splits([(HOT, 1, 3)])
    assert split == base and hash(split) == hash(base)
    assert split.routing.splits == ((HOT, 1, 3),)
    with pytest.raises(TypeError, match="routing"):
        base.replace(routing=[(1, 0, 2)])
    # the JSON is the reference's, key for key, and reads back either way
    jsplit = jbase.with_splits([(HOT, 1, 3)])
    assert split.to_json() == jsplit.to_json()
    assert base.to_json() == jbase.to_json()
    back = tskt.SketchSpec.from_json(jsplit.to_json())
    assert back == split and back.routing == split.routing
    assert jskt.SketchSpec.from_json(split.to_json()).routing == \
        jsplit.routing
    assert base.compatible(base.replace(n_shards=2))
    assert not base.compatible(tskt.make_spec("gss", config=CFG))


# --------------------------------------------------------------------------
# routed_assignment
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ns,splits", [
    (1, ((HOT, 1, 2),)), (4, ()), (4, ((HOT, 1, 4), (3, 0, 2))),
    (8, ((HOT, 1, 3), (11, 2, 8), (20, 2, 16)))])
def test_routed_assignment_bit_identical_to_repro(ns, splits):
    spec, jspec = _specs(ns, splits)
    for seed in range(3):
        b = _heavy(seed=seed, n=2000, frac=0.4)
        got = tskt.routed_assignment(spec, b.src, b.dst, b.src_label)
        want = jskt.routed_assignment(jspec, b.src, b.dst, b.src_label)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        plain = tskt.shard_assignment(spec, b.src, b.src_label)
        if not splits:
            np.testing.assert_array_equal(got, plain)
        cold = ~np.isin(b.src, [s for s, _, _ in splits])
        np.testing.assert_array_equal(got[cold], plain[cold])  # unmoved
    vids = np.random.default_rng(5).integers(0, 1 << 24, 500)
    np.testing.assert_array_equal(
        tskt.routed_assignment_vids(spec, vids, vids[::-1]),
        jskt.routed_assignment_vids(jspec, vids, vids[::-1]))


def test_routed_assignment_spreads_split_key_deterministically():
    spec, _ = _specs(4, ((HOT, 1, 4),))
    b = _heavy(seed=8, n=1000, frac=0.6)
    a1 = tskt.routed_assignment(spec, b.src, b.dst, b.src_label)
    a2 = tskt.routed_assignment(spec, b.src, b.dst, b.src_label)
    np.testing.assert_array_equal(a1, a2)
    hot = b.src == HOT
    assert len(set(a1[hot].tolist())) == 4
    # one (src, dst) pair lands on one shard: its pool identity stays whole
    for d in np.unique(b.dst[hot])[:8]:
        assert len(set(a1[hot & (b.dst == d)].tolist())) == 1


# --------------------------------------------------------------------------
# routed ingest, PARTITION_STATS and the auto-split
# --------------------------------------------------------------------------

def test_routed_ingest_leaf_for_leaf_and_one_sided():
    spec, jspec = _specs(4, ((HOT, 1, 4),))
    b = _heavy(seed=11, n=400)
    PARTITION_STATS.reset()
    J_STATS.reset()
    st = tskt.ingest(spec, tskt.create(spec, device=CPU), b)
    jst = jskt.ingest(jspec, jskt.create(jspec), _jbatch(b))
    _states_equal(st, jst)
    snap, jsnap = PARTITION_STATS.snapshot(), J_STATS.snapshot()
    assert snap["rounds"] == jsnap["rounds"] == 1
    for k in ("max_fill", "mean_fill", "pad_ratio", "imbalance"):
        assert snap[k] == pytest.approx(jsnap[k], rel=0, abs=0)
    truth = _truth(b)
    keys = list(truth)
    q = tskt.QueryBatch.edges(*[np.array([k[i] for k in keys])
                                for i in range(4)])
    lost = int(st.shards.pool_lost.sum())
    for path in ("scan", "cuda"):
        est = tskt.query(spec, st, q, path=path).numpy()
        want = np.array([truth[k] for k in keys])
        assert (est >= want - lost).all(), path
    # the same edges unrouted: the hot shard pads every row
    plain, _ = _specs(4)
    PARTITION_STATS.reset()
    tskt.ingest(plain, tskt.create(plain, device=CPU), b)
    assert PARTITION_STATS.snapshot()["imbalance"] > snap["imbalance"]


def test_routed_flush_rides_planes_delta_not_rebuild():
    spec, _ = _specs(4, ((HOT, 1, 4),))
    sub = CFG.subwindow_size
    st = tskt.ingest(spec, tskt.create(spec, device=CPU),
                     _heavy(seed=12, n=300, tmax=sub - 1))
    q = tskt.QueryBatch.vertices(np.array([HOT, 1, 2]), np.array([1, 1, 2]))
    tskt.query(spec, st, q, path="cuda")
    split = spec.with_splits([(1, 1, 2)])  # a split mid-stream keeps identity
    before = dict(q_mod.PLANES_BUILD_COUNTS)
    st2 = tskt.ingest(split, st, _heavy(seed=13, n=200, tmax=sub - 1))
    got = tskt.query(split, st2, q, path="cuda")
    assert q_mod.PLANES_BUILD_COUNTS["delta"] == before["delta"] + 1
    assert q_mod.PLANES_BUILD_COUNTS["build"] == before["build"]
    assert torch.equal(got, tskt.query(split, st2, q, path="scan"))


@pytest.mark.parametrize("replicas", [None, 2])
def test_async_ingestor_auto_splits_hot_key(replicas):
    spec, jspec = _specs(4)
    ing = tskt.AsyncIngestor(spec, device=CPU, heat_threshold=0.2,
                             split_replicas=replicas)
    jing = jskt.AsyncIngestor(jspec, heat_threshold=0.2,
                              split_replicas=replicas)
    sync, jsync = tskt.create(spec, device=CPU), jskt.create(jspec)
    b = _heavy(seed=21, n=600, frac=0.45)
    specs_seen = []
    for a in range(0, 600, 100):
        chunk = b.slice(a, a + 100)
        ing.submit(chunk)
        jing.submit(_jbatch(chunk))
        specs_seen.append(ing.spec)
        # the synchronous replay under the spec this batch was cut with
        sync = tskt.ingest(ing.spec, sync, chunk)
    assert ing.spec == spec  # identity kept
    assert ing.spec.routing.splits == jing.spec.routing.splits
    assert (HOT, HOT % 3, replicas or 4) in ing.spec.routing.splits
    assert specs_seen[0].routing is not None  # HOT is hot from batch 0
    assert ing.detector.counts == jing.detector.counts
    final = ing.flush()
    _states_equal(final, jing.flush())
    for x, y in zip(tskt.to_numpy(final), tskt.to_numpy(sync)):
        np.testing.assert_array_equal(x, y)


def test_async_ingestor_no_detector_without_threshold():
    spec, _ = _specs(4)
    ing = tskt.AsyncIngestor(spec, device=CPU)
    assert ing.detector is None
    ing.submit(_heavy(seed=30, n=100))
    assert ing.spec.routing is None
    det = tskt.HeavyKeyDetector(16)
    one = tskt.AsyncIngestor(tskt.make_spec("lsketch", config=CFG),
                             device=CPU, heat_threshold=0.1, detector=det)
    one.submit(_heavy(seed=31, n=100))  # one shard: nothing to split
    assert one.detector is det and det.total == 0
    assert one.spec.routing is None


# --------------------------------------------------------------------------
# recommend_budget and prune_routing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("query_counts", [None, [5, 1, 1, 1]])
def test_recommend_budget_matches_repro(query_counts):
    spec, jspec = _specs(4)
    b = _heavy(seed=40, n=2000, frac=0.3)
    det, jdet = trouting.HeavyKeyDetector(32), jrouting.HeavyKeyDetector(32)
    det.update(b.src, b.src_label)
    jdet.update(b.src, b.src_label)
    rep = tskt.recommend_budget(spec, det, query_counts)
    jrep = jskt.recommend_budget(jspec, jdet, query_counts)
    assert rep.to_json() == jrep.to_json()
    if query_counts is None:  # the ingest load alone: HOT's shard splits
        assert rep.routing.splits[0][:2] == (HOT, 1)
        home = int(tskt.shard_assignment(spec, [HOT], [1])[0])
        assert rep.combined[home] == max(rep.combined)
    # an existing split is kept
    seeded = spec.replace(routing=trouting.RoutingTable(((3, 0, 2),)))
    assert (3, 0, 2) in tskt.recommend_budget(seeded, det).routing.splits


def test_prune_routing_drops_decayed_keys_and_round_trips():
    det, jdet = trouting.HeavyKeyDetector(64), jrouting.HeavyKeyDetector(64)
    b = _heavy(seed=50, n=1000, frac=0.3)
    det.update(b.src, b.src_label)
    jdet.update(b.src, b.src_label)
    splits = ((HOT, 1, 4), (3, 0, 2), (99, 2, 2))
    table, jtable = trouting.RoutingTable(splits), \
        jrouting.RoutingTable(splits)
    for th in (0.01, 0.1, 0.5):
        got = tskt.prune_routing(table, det, th)
        assert got.splits == jskt.prune_routing(jtable, jdet, th).splits
    assert tskt.prune_routing(table, det, 0.1).splits == ((HOT, 1, 4),)
    assert not tskt.prune_routing(table, det, 0.9)
    empty = trouting.RoutingTable()
    assert tskt.prune_routing(empty, det, 0.1) is empty
    assert trouting.RoutingTable.from_json(table.to_json()) == table
