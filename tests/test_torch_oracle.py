"""The paper's oracle in the port (``core/ref_prime.py``, ``core/theory.py``,
``data/stream.py``'s ``GraphStream``/``GroundTruth``/``edge_batches``)
against ``repro``'s, and the port's sketch against the port's oracle
(CPU). Tolerance: exact, except the Theorem 1 floats (1e-12 relative).

  * ``PrimeLSketch``: the port's and ``repro``'s on the same seeded
    stream give the same answer to every query;
  * the port's ``LSketch`` equals the port's ``PrimeLSketch`` on every
    query (the cases of ``tests/test_core_vs_prime.py``);
  * the sharded handle is one-sided against the port's ``GroundTruth``
    (``est >= truth``, or ``>= truth - pool_lost`` once the pool is full;
    the pattern of ``tests/test_oracle_conformance.py``), at 1 and 4
    shards on both routes;
  * ``theory.*``, ``GraphStream`` and ``GroundTruth`` (windowed and
    ``no_window``) equal ``repro``'s.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import theory as j_theory
from repro.core.ref_prime import PrimeLSketch as JPrime
from repro.core.types import LSketchConfig as JConfig
from repro.data import stream as jstream

from repro_torch import sketch as tskt
from repro_torch.core import LSketch, LSketchConfig, PrimeLSketch, theory
from repro_torch.core import hashing as thash
from repro_torch.core import ref_prime
from repro_torch.data import stream as tstream

KW = dict(d=64, n_blocks=4, F=512, r=4, s=4, c=4, k=4, window_size=400,
          pool_capacity=512, pool_probes=16)
CFG = LSketchConfig(**KW)
FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
          "time")


def _random_stream(seed, n=400, n_vertices=40, tmax=800, weighted=True):
    """The reference tests' ``random_stream`` (``tests/conftest.py``)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n).astype(np.int32)
    dst = rng.integers(0, n_vertices, n).astype(np.int32)
    la, lb = (src % 3).astype(np.int32), (dst % 3).astype(np.int32)
    le = rng.integers(0, 5, n).astype(np.int32)
    w = (rng.integers(1, 4, n) if weighted else np.ones(n)).astype(np.int32)
    t = np.sort(rng.integers(0, tmax, n)).astype(np.int32)
    return src, dst, la, lb, le, w, t


def _feed(oracle, arrays):
    for i in range(len(arrays[0])):
        oracle.insert(*[int(x[i]) for x in arrays])
    return oracle


def _build_both(cfg, arrays):
    """The port's LSketch and the port's oracle over one stream."""
    sk = LSketch(cfg, device="cpu").insert(*arrays)
    return sk, _feed(PrimeLSketch(cfg), arrays)


def test_hash_family_copy_matches_the_tensor_hashing():
    """The oracle's own copy of the hash family equals ``core/hashing.py``
    bit for bit (the oracle imports nothing of the tensor path)."""
    import torch
    rng = np.random.default_rng(0)
    x = rng.integers(-2**31, 2**31, 64).astype(np.int64)
    got = [ref_prime.hash31(int(v) & ref_prime.MASK32, 77) for v in x]
    want = thash.hash31(torch.from_numpy(x.astype(np.int32)), 77)
    assert got == want.tolist()
    f = rng.integers(0, 512, 8)
    for v in f:
        assert ref_prime.candidate_offsets(int(v), 4) == \
            thash.candidate_offsets(torch.tensor([int(v)]), 4)[0].tolist()


@pytest.mark.parametrize("seed,tmax,window", [(0, 800, 400), (1, 2000, 400),
                                              (2, 300, 0)])
def test_prime_oracle_matches_reference(seed, tmax, window):
    """Every edge and vertex query, with and without the edge label, at
    every horizon, of the port's oracle and ``repro``'s on one stream (a
    small pool, so the pool and its losses are exercised too)."""
    kw = dict(KW, window_size=window, k=4 if window else 1, pool_capacity=8,
              d=16)
    arrays = _random_stream(seed, tmax=tmax)
    mine = _feed(PrimeLSketch(LSketchConfig(**kw)), arrays)
    ref = _feed(JPrime(JConfig(**kw)), arrays)
    assert mine.pool_lost == ref.pool_lost > 0
    assert mine.t_n == ref.t_n and len(mine.cells) == len(ref.cells)
    src, dst, la, lb, le = arrays[:5]
    for i in range(0, len(src), 3):
        a, b = int(src[i]), int(dst[i])
        for last in (None, 1, 2, 4):
            for lab in (None, int(le[i])):
                assert mine.edge_weight(a, int(la[i]), b, int(lb[i]), lab,
                                        last) == \
                    ref.edge_weight(a, int(la[i]), b, int(lb[i]), lab, last)
    for v in range(40):
        for direction in ("out", "in"):
            for last in (None, 1):
                for lab in (None, v % 5):
                    assert mine.vertex_weight(v, v % 3, lab, direction,
                                              last) == \
                        ref.vertex_weight(v, v % 3, lab, direction, last)


@pytest.mark.parametrize("seed,tmax", [(0, 800), (1, 2000), (2, 300)])
def test_lsketch_edge_queries_equal_the_oracle(seed, tmax):
    arrays = _random_stream(seed, tmax=tmax)
    sk, oracle = _build_both(CFG, arrays)
    assert int(sk.state.pool_lost) == oracle.pool_lost == 0
    src, dst, la, lb, le = arrays[:5]
    for i in range(0, len(src), 7):
        e = (int(src[i]), int(la[i]), int(dst[i]), int(lb[i]))
        for last in (None, 1, 2):
            assert sk.edge_weight(*e, last=last) == \
                oracle.edge_weight(*e, last=last)
            assert sk.edge_weight(*e, le=int(le[i]), last=last) == \
                oracle.edge_weight(*e, le=int(le[i]), last=last)


def test_lsketch_vertex_queries_equal_the_oracle():
    sk, oracle = _build_both(CFG, _random_stream(3))
    for v in range(0, 40, 3):
        for direction in ("out", "in"):
            for last in (None, 2):
                assert sk.vertex_weight(v, v % 3, direction=direction,
                                        last=last) == \
                    oracle.vertex_weight(v, v % 3, direction=direction,
                                         last=last)
        assert sk.vertex_weight(v, v % 3, le=1) == \
            oracle.vertex_weight(v, v % 3, le=1)


@pytest.mark.parametrize("cfg", [
    CFG.replace(window_size=0, k=1),
    # 4 blocks with 3:1:2:2 widths over d=64 (paper §3.5)
    CFG.replace(block_bounds=((0, 24), (24, 8), (32, 16), (48, 16)))],
    ids=["unweighted-no-window", "skewed-blocking"])
def test_lsketch_equals_the_oracle_unwindowed_and_skewed(cfg):
    arrays = _random_stream(4 if cfg.window_size == 0 else 5,
                            weighted=cfg.window_size != 0)
    sk, oracle = _build_both(cfg, arrays)
    src, dst, la, lb, le = arrays[:5]
    for i in range(0, len(src), 11):
        e = (int(src[i]), int(la[i]), int(dst[i]), int(lb[i]))
        assert sk.edge_weight(*e) == oracle.edge_weight(*e)
        assert sk.edge_weight(*e, le=int(le[i])) == \
            oracle.edge_weight(*e, le=int(le[i]))


def test_theory_equals_reference():
    for kw in (KW, dict(KW, d=2048, F=1024, n_blocks=4, c=16, k=8)):
        mine, ref = LSketchConfig(**kw), JConfig(**kw)
        for m, dv, nl in ((1000, 10, 3), (500_000, 1200, 20), (50, 60, 1)):
            pairs = [
                (theory.p_no_collision(m, dv, 1024 * 512, 4 * 512, nl),
                 j_theory.p_no_collision(m, dv, 1024 * 512, 4 * 512, nl)),
                (theory.p_no_collision_cfg(mine, m, dv, nl),
                 j_theory.p_no_collision_cfg(ref, m, dv, nl))]
            for nel in (None, 5):
                pairs += [
                    (theory.edge_query_accuracy(mine, m, dv, nl, nel),
                     j_theory.edge_query_accuracy(ref, m, dv, nl, nel)),
                    (theory.vertex_query_accuracy(mine, m, 400, dv, nl, nel),
                     j_theory.vertex_query_accuracy(ref, m, 400, dv, nl,
                                                    nel)),
                    (theory.subgraph_query_accuracy(mine, m, dv, nl, 4, nel),
                     j_theory.subgraph_query_accuracy(ref, m, dv, nl, 4,
                                                      nel))]
            for got, want in pairs:
                assert got == pytest.approx(want, rel=1e-12, abs=0)
                assert 0.0 <= got <= 1.0


@pytest.mark.parametrize("name", ["phone", "comfs"])
def test_graph_stream_and_ground_truth_equal_reference(name):
    """``generate`` gives a ``GraphStream`` with the reference's columns;
    ``slice``, ``edge_batches`` and ``GroundTruth`` (windowed, at a
    horizon, and ``no_window``) answer as the reference's."""
    n = 2500
    js = jstream.generate(dataclasses.replace(jstream.SPECS[name],
                                              n_edges=n), 5, True)
    ts = tstream.generate(dataclasses.replace(tstream.SPECS[name],
                                              n_edges=n), 5, True)
    assert isinstance(ts, tstream.GraphStream) and len(ts) == len(js) == n
    assert ts.spec.name == name
    sl = ts.slice(100, 350)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
        np.testing.assert_array_equal(getattr(sl, f), getattr(js, f)[100:350])
    batches = list(tstream.edge_batches(ts, 1000))
    assert [len(b) for b in batches] == [1000, 1000, 500]
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(b, f) for b in batches]), getattr(ts, f))
    rng = np.random.default_rng(1)
    for k, no_window in ((8, False), (4, False), (1, True)):
        mine = tstream.GroundTruth(ts.spec, k, no_window).insert_stream(ts)
        ref = jstream.GroundTruth(js.spec, k, no_window).insert_stream(js)
        assert mine.cur_widx == ref.cur_widx
        for i in rng.integers(0, n, 40):
            a, b, le = int(ts.src[i]), int(ts.dst[i]), int(ts.edge_label[i])
            for last in (None, 1, 3):
                for lab in (None, le):
                    assert mine.edge_weight(a, b, lab, last) == \
                        ref.edge_weight(a, b, lab, last)
        for v in rng.integers(0, 60, 4):
            for direction in ("out", "in"):
                assert mine.vertex_weight(int(v), None, direction, 1) == \
                    ref.vertex_weight(int(v), None, direction, 1)
        pairs = [(int(ts.src[i]), int(ts.dst[i]))
                 for i in rng.integers(0, n, 3)]
        for a, b in pairs:
            assert mine.reachable(a, b, max_hops=3) == \
                ref.reachable(a, b, max_hops=3)
        sub = [(a, b, None) for a, b in pairs]
        assert mine.subgraph_count(sub) == ref.subgraph_count(sub)


@pytest.mark.parametrize("n_shards,path", [(1, "scan"), (4, "cuda")])
@pytest.mark.parametrize("pool", [4096, 8], ids=["roomy-pool", "full-pool"])
def test_handle_is_one_sided_against_ground_truth(n_shards, path, pool):
    """Edge estimates of the sharded handle never under-count the exact
    in-window truth: ``est >= truth``, and once the pool saturates
    ``est >= truth - pool_lost`` with ``pool_lost > 0``; streamed through
    ``edge_batches`` across many window wraps."""
    spec_s = dataclasses.replace(tstream.PHONE, n_edges=3000, n_vertices=300,
                                 window_size=400)
    st = tstream.generate(spec_s, seed=7, weighted=True)
    cfg = LSketchConfig(d=16 if pool == 8 else 64, n_blocks=2, F=512, r=4,
                        s=4, c=4, k=4, window_size=400, pool_capacity=pool,
                        pool_probes=4)
    spec = tskt.make_spec("lsketch", n_shards=n_shards, config=cfg)
    state = tskt.create(spec, device="cpu")
    for b in tstream.edge_batches(st, 1000):
        state = tskt.ingest(spec, state, b, path=path)
    gt = tstream.GroundTruth(spec_s, cfg.k).insert_stream(st)
    lost = int(state.shards.pool_lost.sum())
    assert (lost > 0) == (pool == 8)
    i = np.random.default_rng(8).integers(0, len(st), 256)
    for last in (None, 1, 2):
        for le in (None, st.edge_label[i]):
            got = tskt.query(spec, state, tskt.QueryBatch.edges(
                st.src[i], st.src_label[i], st.dst[i], st.dst_label[i], le,
                last=last), path=path).numpy()
            truth = np.array([gt.edge_weight(
                int(st.src[j]), int(st.dst[j]),
                None if le is None else int(st.edge_label[j]), last)
                for j in i])
            assert (got >= truth - lost).all(), (last, le is None)
            assert (truth > 0).any()
