"""The plain reference against the program at tiny sizes on the CPU: the
addressing bit for bit, every state leaf after each batch (both insert
routes, batches that stay in a subwindow and ones that span several),
every query kind on both read paths, the tenant pool's rows and answers,
and one-sided answers against the frozen ground truth."""

import numpy as np
import pytest
import torch

from sketchbench.reference import hashing as rh
from sketchbench.reference import sketch as ref
from sketchbench.traffic import stream as ts

from repro_torch import sketch as skt
from repro_torch.core import hashing as ph
from repro_torch.core.lsketch import edge_probes, precompute
from repro_torch.core.types import EdgeBatch, LSketchConfig

SK = dict(d=16, n_blocks=2, F=1024, r=8, s=8, c=4, k=4, window_size=40,
          pool_capacity=48, pool_probes=8, seed=1234)
PARAMS = ts.StreamParams(n_vertices=300, n_vertex_labels=3, n_edge_labels=5,
                         zipf_a=1.2, duplicate_rate=0.2,
                         edges_per_window=300, window_size=40, subwindow=10,
                         base_windows=2)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(n_shards=2):
    return skt.SketchSpec(kind="lsketch", config=LSketchConfig(**SK),
                          n_shards=n_shards)


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32)


def test_addressing_matches_the_port_bit_for_bit():
    cfg = ref.Config.from_dict(SK)
    rng = np.random.default_rng(5)
    v = np.concatenate([rng.integers(-2**31, 2**31, 500),
                        [0, -1, 2**31 - 1, -2**31]])
    lab = rng.integers(-50, 50, len(v))
    mine = rh.addressing(cfg, v, lab)
    theirs = precompute(LSketchConfig(**SK), _t(v), _t(lab))
    for k in ("m", "s", "f", "offs", "vid"):
        np.testing.assert_array_equal(mine[k], getattr(theirs, k).numpy())
    pr = rh.edge_probes(cfg, v, lab, v[::-1], lab[::-1])
    theirs = edge_probes(LSketchConfig(**SK), theirs, precompute(
        LSketchConfig(**SK), _t(v[::-1]), _t(lab[::-1])))
    for k in ("rows", "cols", "keys", "pid_src", "pid_dst"):
        np.testing.assert_array_equal(pr[k], getattr(theirs, k).numpy())
    np.testing.assert_array_equal(
        rh.pool_slots(cfg, pr["pid_src"], pr["pid_dst"]),
        ph.pool_slot_seq(_t(pr["pid_src"]), _t(pr["pid_dst"]),
                         cfg.pool_capacity, cfg.pool_probes,
                         cfg.seed).numpy())
    np.testing.assert_array_equal(
        rh.edge_label_bucket(cfg, lab),
        ph.edge_label_bucket(_t(lab), cfg.c, cfg.seed).numpy())
    for n in (1, 2, 4):
        np.testing.assert_array_equal(
            rh.shard_of(cfg, n, v, lab),
            skt.shard_assignment(_spec(n), v.astype(np.int32),
                                 lab.astype(np.int32)))


def _batches(replay, n_edges, size, cut=True):
    pos = 0
    while pos < n_edges:
        end = replay.next_cut(pos, size) if cut else min(
            pos + size, n_edges, (pos // replay.n + 1) * replay.n)
        yield replay.columns(pos, end)
        pos = end


def _leaves(state):
    return dict(zip(ref.LEAVES, state.live().leaves()))


def _assert_leaves(got, want):
    for k in ref.LEAVES:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("path,cut", [("cuda", True), ("scan", True),
                                      ("scan", False)])
def test_insert_matches_the_port_leaf_for_leaf(path, cut):
    cfg = ref.Config.from_dict(SK)
    spec = _spec(2)
    replay = ts.Replay(PARAMS, ts.make_base(PARAMS, 11))
    st = skt.create(spec, "cpu")
    mine = ref.empty_leaves(cfg, 2, "cpu")
    for cols in _batches(replay, 2 * replay.n + 200, 96, cut):
        st = skt.ingest(spec, st, EdgeBatch(**cols), path=path)
        rows = rh.shard_of(cfg, 2, cols["src"], cols["src_label"])
        ref.apply(cfg, mine, rows, cols)
        _assert_leaves(_leaves(st), mine)
    assert int(mine["pool_lost"].sum()) > 0  # the pool overflowed
    assert int((mine["pool_key"] != -1).all(-1).sum()) > 0


def _queries(rng, n, replay, pos):
    e = replay.at(rng.integers(max(0, pos - 300), pos, n))
    return dict(src=e["src"], la=e["src_label"], dst=e["dst"],
                lb=e["dst_label"], le=e["edge_label"], v=e["src"],
                lv=e["src_label"])


def _port_query(spec, st, kind, q, with_le, last, direction, path):
    le = q["le"] if with_le else None
    if kind == "edge":
        qb = skt.QueryBatch.edges(q["src"], q["la"], q["dst"], q["lb"],
                                  edge_label=le, last=last)
    elif kind == "vertex":
        qb = skt.QueryBatch.vertices(q["v"], q["lv"], edge_label=le,
                                     direction=direction, last=last)
    else:
        qb = skt.QueryBatch.labels(q["lv"], edge_label=le,
                                   direction=direction, last=last)
    return skt.query(spec, st, qb, path=path).numpy()


@pytest.mark.parametrize("path", ["cuda", "scan"])
def test_queries_match_the_port(path):
    cfg = ref.Config.from_dict(SK)
    spec = _spec(2)
    replay = ts.Replay(PARAMS, ts.make_base(PARAMS, 12))
    st = skt.create(spec, "cpu")
    n = replay.n + 150
    for cols in _batches(replay, n, 128):
        st = skt.ingest(spec, st, EdgeBatch(**cols))
    leaves = _leaves(st)
    rng = np.random.default_rng(3)
    q = _queries(rng, 40, replay, n)
    q["src"][:8] = rng.integers(0, 300, 8)  # random pairs: the pool path
    for kind in ("edge", "vertex", "label"):
        for with_le in (False, True):
            for last in (None, 1, 3):
                for direction in (("out",) if kind == "edge"
                                  else ("out", "in")):
                    want = ref.answer(cfg, leaves, [0, 1], kind, q, with_le,
                                      last, direction)
                    got = _port_query(spec, st, kind, q, with_le, last,
                                      direction, path)
                    np.testing.assert_array_equal(got, want)
                    assert want.any()


def test_tenant_pool_rows_and_answers_match():
    cfg = ref.Config.from_dict(SK)
    spec = _spec(2)
    pool = skt.TenantPool(spec, n_slots=3, device="cpu")
    mine = ref.empty_leaves(cfg, 6, "cpu")
    reps = [ts.Replay(PARAMS, ts.make_base(PARAMS, 20 + t, t0=10 * t))
            for t in range(3)]
    pos = [0, 0, 0]
    for _ in range(12):
        pairs = []
        for t in range(3):
            b = reps[t].next_cut(pos[t], 40)
            cols = reps[t].columns(pos[t], b)
            pos[t] = b
            pairs.append((t, EdgeBatch(**cols)))
            ref.apply(cfg, mine, 2 * t + rh.shard_of(
                cfg, 2, cols["src"], cols["src_label"]), cols)
        pool.submit(pairs)
    _assert_leaves(_leaves(pool.state), mine)
    rng = np.random.default_rng(4)
    for t in range(3):
        q = _queries(rng, 16, reps[t], pos[t])
        for kind in ("edge", "vertex", "label"):
            want = ref.answer(cfg, mine, [2 * t, 2 * t + 1], kind, q, True,
                              None, "out")
            qb = (skt.QueryBatch.edges(q["src"], q["la"], q["dst"], q["lb"],
                                       edge_label=q["le"]) if kind == "edge"
                  else skt.QueryBatch.vertices(q["v"], q["lv"],
                                               edge_label=q["le"])
                  if kind == "vertex" else
                  skt.QueryBatch.labels(q["lv"], edge_label=q["le"]))
            got = pool.query_many([(t, qb)], path="cuda")[0].numpy()
            np.testing.assert_array_equal(got, want)


def test_answers_are_one_sided_against_the_ground_truth():
    cfg = ref.Config.from_dict(SK)
    replay = ts.Replay(PARAMS, ts.make_base(PARAMS, 13))
    mine = ref.empty_leaves(cfg, 1, "cpu")
    truth = ts.GroundTruth(PARAMS.window_size, SK["k"])
    for cols in _batches(replay, 500, 100):
        ref.apply(cfg, mine, np.zeros(len(cols["src"]), np.int64), cols)
        truth.insert(cols)
    e = replay.at(np.arange(400, 500))
    q = dict(src=e["src"], la=e["src_label"], dst=e["dst"],
             lb=e["dst_label"])
    est = ref.answer(cfg, mine, [0], "edge", q, False, None)
    lost = int(mine["pool_lost"].sum())
    exact = [truth.edge_weight(int(a), int(b))
             for a, b in zip(q["src"], q["dst"])]
    assert all(x >= y - lost for x, y in zip(est, exact))
    assert (est == exact).mean() > 0.5
