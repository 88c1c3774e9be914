"""The single-shard entry and the object API of the port against ``repro``
(CPU, exact int32 equality, tolerance zero): the engine's single-shard
insert on both routes and the per-subwindow reference, the ``LSketch``
object's state and every scalar and batched answer, the single-sketch
drop-ins of the insert, probe and scan kernels (their plain versions on
the CPU), and a state carried across from ``repro`` mid-stream."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LSketch as JLSketch
from repro.core import LSketchConfig as JConfig
from repro.core import init_state as j_init
from repro.core import state_bytes as j_state_bytes
from repro.core.lsketch import insert_window_batch as j_window_batch
from repro.core.types import EdgeBatch as JBatch
from repro.data.stream import PHONE as J_PHONE
from repro.data.stream import GroundTruth
from repro.data.stream import generate as j_generate
from repro.engine import insert as j_insert
from repro.engine.window import pad_to_bucket as j_pad
from repro.kernels.sketch_insert.ops import \
    insert_window_batch_pallas as j_window_pallas
from repro.kernels.sketch_query.ops import edge_query_pallas as j_eq_pallas
from repro.kernels.vertex_scan.ops import vertex_query_pallas as j_vq_pallas

from repro_torch import sketch as tskt
from repro_torch.core import LSketch, LSketchConfig, init_state, state_bytes
from repro_torch.core.lsketch import insert_window_batch
from repro_torch.core.queries import edge_query, vertex_query
from repro_torch.core.types import EdgeBatch
from repro_torch.data.stream import PHONE, generate
from repro_torch.engine import insert as t_insert
from repro_torch.engine import query_batch as t_qb
from repro_torch.engine.window import pad_to_bucket
from repro_torch.kernels.sketch_insert.ops import insert_window_batch_pallas
from repro_torch.kernels.sketch_query import kernel as probe_kernel
from repro_torch.kernels.sketch_query.ops import edge_query_pallas
from repro_torch.kernels.vertex_scan.ops import vertex_query_pallas

KW = dict(d=64, n_blocks=2, F=1024, r=8, s=8, c=16, k=8, pool_capacity=256,
          pool_probes=8)
FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
          "time")
CPU = "cpu"


def _cfgs(**kw):
    kw = dict(KW, **kw)
    return JConfig(**kw), LSketchConfig(**kw)


def _phone(n=3000, seed=1):
    """The PHONE analog at a small size, as (repro stream, port batch)."""
    js = j_generate(dataclasses.replace(J_PHONE, n_edges=n, n_vertices=150),
                    seed=seed, weighted=True)
    tb = generate(dataclasses.replace(PHONE, n_edges=n, n_vertices=150),
                  seed=seed, weighted=True)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(tb, f))
    return js, tb


def _random(seed, n=300, tmax=800, n_vertices=40, zero_weights=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n)
    dst = rng.integers(0, n_vertices, n)
    w = rng.integers(0 if zero_weights else 1, 4, n)
    t = np.sort(rng.integers(0, tmax, n))
    return EdgeBatch.from_arrays(src, dst, src % 3, dst % 3,
                                 rng.integers(0, 5, n), w, t)


def _jb(b: EdgeBatch) -> JBatch:
    return JBatch(*[jnp.asarray(getattr(b, f), jnp.int32) for f in FIELDS])


def _cols(b):
    return [np.asarray(getattr(b, f)) for f in FIELDS]


def _equal(jstate, tstate):
    leaves = tskt.to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(jstate), leaves, strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_state_bytes_and_pad_to_bucket():
    for kw in (KW, dict(KW, k=1, c=1, n_blocks=1, pool_capacity=4096),
               dict(d=2048, n_blocks=4, c=16, k=8, window_size=1440,
                    pool_capacity=16384)):
        assert state_bytes(LSketchConfig(**kw)) == j_state_bytes(
            JConfig(**kw))
    for n in (1, 63, 64, 65, 200):
        x = np.arange(n, dtype=np.int32) * 3
        want = np.asarray(j_pad(jnp.asarray(x)))
        np.testing.assert_array_equal(pad_to_bucket(x), want)
        np.testing.assert_array_equal(pad_to_bucket(torch.from_numpy(x)),
                                      want)


@pytest.mark.parametrize("seed,tmax", [(0, 300), (1, 2500), (2, 799)])
def test_fused_scan_and_chunked_match_reference(seed, tmax):
    """Few boundaries, ring wraparound, one full window: the fused scan and
    the per-subwindow reference equal ``repro``'s fused scan (which its own
    tests hold to its chunked reference)."""
    jc, tc = _cfgs(window_size=400, k=4, c=4)
    b = _random(seed, tmax=tmax)
    ref = j_insert.insert_batch(jc, j_init(jc), _jb(b), path="scan")
    for path in ("scan", "chunked"):
        st = t_insert.insert_batch(tc, init_state(tc, CPU), b, path=path)
        _equal(ref, st)


def test_kernel_route_matches_reference_single_and_multi():
    """``path="cuda"`` against ``repro``'s ``path="pallas"``: a batch
    spanning subwindows takes the scan route, one inside a subwindow the
    kernel route (each kernel's plain version on the CPU)."""
    jc, tc = _cfgs(window_size=400, k=4, c=4)
    b = _random(3, tmax=1200)
    one = EdgeBatch(*(_cols(b)[:6] + [np.full(len(b), 7, np.int32)]))
    for batch, route in ((b, "scan"), (one, "kernel")):
        before = dict(t_insert.ROUTE_EDGES)
        ref = j_insert.insert_batch(jc, j_init(jc), _jb(batch),
                                    path="pallas")
        st = t_insert.insert_batch(tc, init_state(tc, CPU), batch,
                                   path="cuda")
        _equal(ref, st)
        assert t_insert.ROUTE_EDGES[route] - before[route] == len(batch)


def test_pool_overflow_and_incremental_batches():
    jc, tc = _cfgs(window_size=400, k=4, c=4, pool_capacity=8,
                   pool_probes=2, d=8, n_blocks=2, F=256, r=2, s=2)
    b = _random(4, n=500, n_vertices=400, tmax=1500)
    ref = j_insert.insert_batch(jc, j_init(jc), _jb(b), path="scan")
    assert int(ref.pool_lost) > 0, "the stream must saturate the pool"
    _equal(ref, t_insert.insert_batch(tc, init_state(tc, CPU), b,
                                      path="scan"))
    inc = init_state(tc, CPU)
    for a in range(0, len(b), 64):  # many scan batches compose to one
        inc = t_insert.insert_batch(tc, inc, b.slice(a, a + 64), path="scan")
    _equal(ref, inc)


def test_zero_weights_separate_the_two_routes():
    """The scan claims a key for a zero-weight item, the kernel does not:
    each port route equals its ``repro`` counterpart, and they differ."""
    jc, tc = _cfgs(window_size=400, k=4, c=4)
    b = _random(5, n=200, zero_weights=True)
    b = EdgeBatch(*(_cols(b)[:6] + [np.full(len(b), 30, np.int32)]))
    states = {}
    for path, jpath in (("scan", "scan"), ("cuda", "pallas")):
        ref = j_insert.insert_batch(jc, j_init(jc), _jb(b), path=jpath)
        states[path] = t_insert.insert_batch(tc, init_state(tc, CPU), b,
                                             path=path)
        _equal(ref, states[path])
    assert not torch.equal(states["scan"].key, states["cuda"].key)


def test_empty_batch_is_a_noop():
    _, tc = _cfgs()
    st = init_state(tc, CPU)
    assert t_insert.insert_batch(tc, st, _random(9).slice(0, 0)) is st
    sk = LSketch(tc, device=CPU)
    handle = sk.handle
    sk.insert(np.array([], np.int32), np.array([], np.int32))
    assert sk.handle is handle and not handle.spent


def _object_pair(path):
    """``repro``'s object and the port's, fed the same PHONE-analog batches
    (cut at subwindow boundaries, then one that spans the rest), states
    compared after each."""
    js, tb = _phone()
    jc, tc = _cfgs(window_size=PHONE.window_size)
    jsk = JLSketch(jc, insert_path="pallas" if path == "cuda" else "scan")
    tsk = LSketch(tc, insert_path=path, query_path=path, device=CPU)
    widx = tb.time // tc.subwindow_size
    cuts = [0] + (np.flatnonzero(np.diff(widx)) + 1).tolist()[:5] + [len(tb)]
    for a, z in zip(cuts[:-1], cuts[1:]):
        jsk.insert(*_cols(tb.slice(a, z)))
        tsk.insert(*_cols(tb.slice(a, z)))
        _equal(jsk.state, tsk.state)
    return js, tb, jsk, tsk


@pytest.fixture(scope="module")
def pair():
    return _object_pair("cuda")


HORIZONS = [None, 1, 3]


def _reference_answers(jsk, tb, i):
    """``repro``'s answers to every kind x edge label at HORIZONS, one
    multi-horizon dispatch each: {(kind, with_le): [H, B]}."""
    from repro import sketch as jskt
    Q = jskt.QueryBatch
    e = (tb.src[i], tb.src_label[i], tb.dst[i], tb.dst_label[i])
    lab = np.arange(PHONE.n_vertex_labels)
    out = {}
    for with_le in (False, True):
        le = tb.edge_label[i] if with_le else None
        qs = {"edge": Q.edges(*e, le, last=HORIZONS),
              "out": Q.vertices(e[0], e[1], le, "out", last=HORIZONS),
              "in": Q.vertices(e[0], e[1], le, "in", last=HORIZONS),
              "label-out": Q.labels(lab, None if le is None else le[:2],
                                    "out", last=HORIZONS),
              "label-in": Q.labels(lab, None if le is None else le[:2],
                                   "in", last=HORIZONS)}
        for kind, q in qs.items():
            out[(kind, with_le)] = np.asarray(jskt.query(
                jsk.spec, jsk.state, q, path="pallas"))
    return out


@pytest.mark.parametrize("path", ["cuda", "scan"])
def test_object_state_and_answers_match_reference(path, pair):
    """``LSketch.insert`` leaf for leaf against ``repro``'s object (the
    kernel route of the cut batches and the scan route of the spanning
    one, or the scan throughout), then every batched answer against
    ``repro``'s, with and without the edge label, at three horizons; the
    scalar calls equal the batched ones, and on the kernel path the
    planes are built once per horizon."""
    js, tb, jsk, tsk = pair if path == "cuda" else _object_pair(path)
    i = np.random.default_rng(3).integers(0, len(tb), 12)
    e = (tb.src[i], tb.src_label[i], tb.dst[i], tb.dst_label[i])
    lab = np.arange(PHONE.n_vertex_labels)
    want = _reference_answers(jsk, tb, i)
    tskt.clear_plane_cache(tsk.handle)
    builds = tskt.PLANES_BUILD_COUNTS["build"]
    for h, last in enumerate(HORIZONS):
        for with_le in (False, True):
            le = tb.edge_label[i] if with_le else None
            got = t_qb.edge_weight_batch(tsk, *e, le, last, path=path)
            np.testing.assert_array_equal(got.numpy(),
                                          want[("edge", with_le)][h])
            for j in range(0, 12, 5):
                assert tsk.edge_weight(
                    int(e[0][j]), int(e[1][j]), int(e[2][j]), int(e[3][j]),
                    le=None if le is None else int(le[j]), last=last) == \
                    int(got[j])
            for direction in ("out", "in"):
                got = tsk.vertex_weight(e[0], e[1], le, direction, last)
                np.testing.assert_array_equal(got,
                                              want[(direction, with_le)][h])
                assert tsk.vertex_weight(
                    int(e[0][0]), int(e[1][0]),
                    le=None if le is None else int(le[0]),
                    direction=direction, last=last) == int(got[0])
                got = tsk.label_aggregate(lab, None if le is None else
                                          le[:2], direction, last)
                np.testing.assert_array_equal(
                    got, want[("label-" + direction, with_le)][h])
                assert tsk.label_aggregate(
                    1, None if le is None else int(le[1]), direction,
                    last) == int(got[1])
    built = tskt.PLANES_BUILD_COUNTS["build"] - builds
    assert built == (len(HORIZONS) if path == "cuda" else 0)
    assert isinstance(tsk.edge_weight(int(e[0][0]), 0, int(e[2][0]), 0),
                      int)
    arr = tsk.edge_weight(*[x[:5] for x in e])
    assert isinstance(arr, np.ndarray) and arr.shape == (5,)


def test_object_queries_follow_the_reference_and_the_truth(pair):
    """The patterns of the reference's query tests on the port's object:
    over-estimates only (whole window, label-restricted, windowed, vertex),
    reachability, subgraph counts and the scalar analytics, the latter
    three equal to ``repro``'s object."""
    js, tb, jsk, tsk = pair
    gt = GroundTruth(dataclasses.replace(J_PHONE, n_edges=3000,
                                         n_vertices=150), k=8)
    gt.insert_stream(js)
    i = np.arange(0, 120, 7)
    e = (tb.src[i], tb.src_label[i], tb.dst[i], tb.dst_label[i])
    whole = tsk.edge_weight(*e)
    for last in (None, 1, 2, 4):
        est = tsk.edge_weight(*e, last=last)
        assert (est <= whole).all()
        assert all(x >= gt.edge_weight(int(a), int(b), last=last)
                   for x, a, b in zip(est, e[0], e[2]))
    est = tsk.edge_weight(*e, le=tb.edge_label[i])
    assert all(x >= gt.edge_weight(int(a), int(b), le=int(le))
               for x, a, b, le in zip(est, e[0], e[2], tb.edge_label[i]))
    est = tsk.vertex_weight(e[0], e[1])
    assert all(x >= gt.vertex_weight(int(v)) for x, v in zip(est, e[0]))
    for i in (0, 8):
        a, b = int(tb.src[i]), int(tb.dst[(i + 31) % len(tb)])
        la, lb = int(tb.src_label[i]), int(tb.dst_label[(i + 31) % len(tb)])
        est = tsk.reachable(a, la, b, lb, max_hops=3)
        assert est == jsk.reachable(a, la, b, lb, max_hops=3)
        if gt.reachable(a, b, max_hops=3):
            assert est
    edges = [(int(tb.src[i]), int(tb.src_label[i]), int(tb.dst[i]),
              int(tb.dst_label[i]), int(tb.edge_label[i])) for i in range(3)]
    for with_le, last in ((False, None), (True, 2)):
        assert tsk.subgraph_count(edges, with_le, last) == \
            jsk.subgraph_count(edges, with_le, last)
    assert tsk.subgraph_count([(9999, 0, 9998, 0)]) == 0
    assert tsk.subgraph_count(edges) == min(
        tsk.edge_weight(*x[:4]) for x in edges)
    for direction, last in (("out", None), ("in", 1)):
        assert tsk.heavy_hitters(8, direction, last) == \
            [tuple(x) for x in jsk.heavy_hitters(8, direction, last)]
    assert tsk.heavy_edges(8, last=1) == \
        [tuple(x) for x in jsk.heavy_edges(8, last=1)]
    assert tsk.triangle_count(4) == jsk.triangle_count(4)
    # the handle's analytics (the decode's plain version) agree
    vid, w = tskt.heavy_vertices(tsk.spec, tsk.handle, 8)
    assert list(zip(vid.tolist(), w.tolist())) == tsk.heavy_hitters(8)


def _window_batch(rng, n, t, nv=60):
    return EdgeBatch.from_arrays(
        rng.integers(0, nv, n), rng.integers(0, nv, n),
        rng.integers(0, 3, n), rng.integers(0, 3, n), rng.integers(0, 6, n),
        rng.integers(1, 4, n), np.full(n, t))


@pytest.mark.parametrize("d,nb,F,r,s,c,k", [
    (32, 2, 256, 2, 2, 2, 1),
    (64, 4, 512, 4, 4, 4, 4),
    (128, 8, 2048, 4, 8, 16, 4),
])
def test_insert_window_batch_drop_in_sweep(d, nb, F, r, s, c, k):
    """The single-sketch entry of the insert kernel against the sequential
    reference, in both packages."""
    kw = dict(d=d, n_blocks=nb, F=F, r=r, s=s, c=c, k=k,
              window_size=0 if k == 1 else 100, pool_capacity=256,
              pool_probes=8)
    jc, tc = JConfig(**kw), LSketchConfig(**kw)
    b = _window_batch(np.random.default_rng(d + r), 200, 10)
    want = j_window_pallas(jc, j_init(jc), _jb(b), 0)
    for x, y in zip(jax.tree.leaves(j_window_batch(jc, j_init(jc), _jb(b),
                                                   0)),
                    jax.tree.leaves(want)):
        assert jnp.array_equal(x, y)
    _equal(want, insert_window_batch_pallas(tc, init_state(tc, CPU), b, 0))
    _equal(want, insert_window_batch(tc, init_state(tc, CPU), b, 0))


def test_insert_window_batch_drop_in_sequential_batches():
    kw = dict(d=64, n_blocks=4, F=512, r=4, s=4, c=4, k=4, window_size=100,
              pool_capacity=256, pool_probes=8)
    jc, tc = JConfig(**kw), LSketchConfig(**kw)
    rng = np.random.default_rng(0)
    b1, b2 = _window_batch(rng, 100, 10), _window_batch(rng, 100, 60)
    ref = j_window_batch(jc, j_window_batch(jc, j_init(jc), _jb(b1), 0),
                         _jb(b2), 2)
    st = insert_window_batch_pallas(tc, init_state(tc, CPU), b1, 0)
    st = insert_window_batch_pallas(tc, st, b2, 2)
    _equal(ref, st)


@pytest.mark.parametrize("d,nb,s,c,lasts", [(32, 2, 4, 4, (None, 2)),
                                             (64, 4, 8, 8, (None,))])
def test_query_drop_ins_match_reference(d, nb, s, c, lasts):
    """``edge_query_pallas``/``vertex_query_pallas`` (the single-sketch
    entries of the probe and the scan) against ``repro``'s drop-ins and
    the port's dense queries, both outputs."""
    kw = dict(d=d, n_blocks=nb, F=512, r=4, s=s, c=c, k=4, window_size=200,
              pool_capacity=256, pool_probes=8)
    jc, tc = JConfig(**kw), LSketchConfig(**kw)
    b = _random(2 + d, n=300, tmax=500, n_vertices=50)
    jsk = JLSketch(jc).insert(*_cols(b))
    tsk = LSketch(tc, device=CPU).insert(*_cols(b))
    _equal(jsk.state, tsk.state)
    q = slice(0, 128)
    lab = (b.src_label[q], b.dst_label[q], b.edge_label[q])
    t = torch.from_numpy
    vq = np.arange(30, dtype=np.int32)
    vl = (vq % 3, b.edge_label[:30])
    for last in lasts:
        want = j_eq_pallas(jc, jsk.state, jnp.asarray(b.src[q]),
                           jnp.asarray(b.dst[q]),
                           tuple(jnp.asarray(x) for x in lab), last)
        got = edge_query_pallas(tc, tsk.state, b.src[q], b.dst[q], lab, last)
        dense = edge_query(tc, tsk.state, t(b.src[q]), t(b.dst[q]),
                           tuple(t(x) for x in lab), True, last)
        for x, y, z in zip(want, got, dense, strict=True):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
            assert torch.equal(y, z)
        for direction in ("out", "in"):
            want = j_vq_pallas(jc, jsk.state, jnp.asarray(vq),
                               tuple(jnp.asarray(x) for x in vl), direction,
                               last)
            got = vertex_query_pallas(tc, tsk.state, vq, vl, direction, last)
            dense = vertex_query(tc, tsk.state, t(vq),
                                 tuple(t(x) for x in vl), direction, True,
                                 last)
            for x, y, z in zip(want, got, dense, strict=True):
                np.testing.assert_array_equal(np.asarray(x), y.numpy())
                assert torch.equal(y, z)


def test_edge_probe_block_table_is_keyed_by_value():
    """Equal config objects share one block table, and the cache keeps no
    config object alive."""
    import gc
    import weakref

    probe_kernel._BLOCKS.clear()
    a, b = LSketchConfig(**KW), LSketchConfig(**KW)
    assert a is not b
    ta = probe_kernel._block_table(a, torch.device(CPU))
    assert probe_kernel._block_table(b, torch.device(CPU)) is ta
    assert len(probe_kernel._BLOCKS) == 1
    starts, widths = a.block_start_width()
    assert torch.equal(ta, torch.cat([starts, widths]))
    probe_kernel._block_table(LSketchConfig(**dict(KW, n_blocks=4)),
                              torch.device(CPU))
    assert len(probe_kernel._BLOCKS) == 2
    ref = weakref.ref(a)
    del a
    gc.collect()
    assert ref() is None
    probe_kernel._BLOCKS.clear()


@pytest.mark.parametrize("path", ["cuda", "scan"])
def test_state_carries_across_from_the_reference(path):
    """Half a stream inserted in ``repro``, carried across as numpy arrays
    (``LSketch.from_numpy``), the rest inserted in both packages: leaf for
    leaf equal, and so are the answers."""
    js, tb = _phone(n=1200, seed=4)
    jc, tc = _cfgs(window_size=PHONE.window_size)
    jpath = "pallas" if path == "cuda" else "scan"
    jsk = JLSketch(jc, insert_path=jpath)
    half = 600
    jsk.insert(*_cols(tb.slice(0, half)))
    tsk = LSketch.from_numpy(tc, [np.asarray(x) for x in
                                  jax.tree.leaves(jsk.state)], CPU,
                             insert_path=path)
    _equal(jsk.state, tsk.state)
    plain = tskt.from_numpy(tsk.spec, tskt.to_numpy(tsk.state), CPU,
                            plain=True)
    _equal(jsk.state, plain)
    with pytest.raises(ValueError, match="shape"):
        tskt.from_numpy(tsk.spec, tskt.to_numpy(tsk.handle), CPU, plain=True)
    widx = tb.time // tc.subwindow_size
    cut = half + int(np.flatnonzero(widx[half:] != widx[half])[0])
    for a, z in ((half, cut), (cut, len(tb))):
        jsk.insert(*_cols(tb.slice(a, z)))
        tsk.insert(*_cols(tb.slice(a, z)))
        _equal(jsk.state, tsk.state)
    i = np.arange(0, len(tb), 97)
    e = (tb.src[i], tb.src_label[i], tb.dst[i], tb.dst_label[i])
    np.testing.assert_array_equal(tsk.edge_weight(*e, last=2),
                                  np.asarray(jsk.edge_weight(*e, last=2)))
