"""The paper's two baselines in the port against ``repro`` (CPU, exact int32
equality, tolerance zero): the ``GSS`` object (the degenerate LSketch on
the LSketch engine: one label block, no labels, no window) and the ``LGS``
object (count-min matrices with the subwindow ring), their states leaf
for leaf and every answer, and the ``gss``/``lgs`` kinds through the
handle layer (spec, create, ingest, query, analytics) at 1 and 4 shards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import sketch as jskt
from repro.core import GSS as JGSS
from repro.core import LGS as JLGS
from repro.core import LGSConfig as JLGSConfig
from repro.core.types import EdgeBatch as JBatch
from repro.data.stream import PHONE as J_PHONE
from repro.data.stream import generate as j_generate
from repro.engine import query_batch as j_qb

from repro_torch import sketch as tskt
from repro_torch.core import GSS, LGS, LGSConfig, gss_config
from repro_torch.core.lgs import lgs_state_bytes
from repro_torch.core.types import EdgeBatch
from repro_torch.data.stream import PHONE, generate
from repro_torch.engine import query_batch as t_qb

FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
          "time")
CPU = "cpu"
N = 2000
LGS_KW = dict(d=32, copies=6, c=8, k=8, window_size=PHONE.window_size)


@pytest.fixture(scope="module")
def stream():
    js = j_generate(dataclasses.replace(J_PHONE, n_edges=N, n_vertices=150),
                    seed=5, weighted=True)
    tb = generate(dataclasses.replace(PHONE, n_edges=N, n_vertices=150),
                  seed=5, weighted=True)
    return js, tb


def _cols(b):
    return [np.asarray(getattr(b, f)) for f in FIELDS]


def _cuts(tb, subwindow):
    """Batches cut at subwindow boundaries, the last one spanning the rest."""
    widx = tb.time // subwindow
    cuts = [0] + (np.flatnonzero(np.diff(widx)) + 1).tolist()[:2] + [len(tb)]
    return list(zip(cuts[:-1], cuts[1:]))


def _equal(jstate, tstate):
    for a, b in zip(jax.tree.leaves(jstate), tskt.to_numpy(tstate),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)


def _jb(b: EdgeBatch) -> JBatch:
    return JBatch(*[jnp.asarray(getattr(b, f), jnp.int32) for f in FIELDS])


@pytest.mark.parametrize("path", ["cuda", "scan"])
def test_gss_object_matches_reference(stream, path):
    """Every GSS batch is one subwindow (times normalized to 0), so
    ``path="cuda"`` takes the kernel route in one bin of the one block;
    state and answers equal ``repro``'s GSS, whatever labels, edge label
    or horizon the caller passes."""
    js, tb = stream
    jg = JGSS(d=32)
    jg.insert_path = "pallas" if path == "cuda" else "scan"
    tg = GSS(d=32, device=CPU)
    tg.insert_path = tg.query_path = path
    for a, z in ((0, N // 2), (N // 2, N)):
        jg.insert(*_cols(tb.slice(a, z)))
        tg.insert(*_cols(tb.slice(a, z)))
        _equal(jg.state, tg.state)
    assert tg.cfg == gss_config(d=32) and tg.spec.kind == "gss"
    i = np.arange(0, N, 41)
    want = np.asarray(j_qb.edge_weight_batch(jg, tb.src[i], 0, tb.dst[i], 0))
    for la, le, last in ((0, None, None), (tb.src_label[i], tb.edge_label[i],
                                           2)):
        got = tg.edge_weight(tb.src[i], la, tb.dst[i], la, le=le, last=last)
        np.testing.assert_array_equal(got, want)
    assert tg.edge_weight(int(tb.src[0]), 1, int(tb.dst[0]), 1) == \
        jg.edge_weight(int(tb.src[0]), 0, int(tb.dst[0]), 0)
    for direction in ("out", "in"):
        want = np.asarray(j_qb.vertex_weight_batch(jg, tb.src[i], 0,
                                                   direction=direction))
        got = tg.vertex_weight(tb.src[i], 1, le=3, direction=direction,
                               last=1)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tg.label_aggregate(np.arange(3)),
        np.asarray(j_qb.label_aggregate_batch(jg, np.arange(3))))
    a, b = int(tb.src[9]), int(tb.dst[14])
    assert tg.reachable(a, 3, b, 4, max_hops=2) == \
        jg.reachable(a, 0, b, 0, max_hops=2)
    assert tg.heavy_edges(6) == [tuple(x) for x in jg.heavy_edges(6)]


def test_lgs_object_matches_reference(stream):
    """LGS state leaf for leaf over batches cut at subwindow boundaries and
    one that spans several; edge and vertex answers with and without the
    edge label at two horizons; reachability; no label aggregate."""
    js, tb = stream
    jl, tl = JLGS(**LGS_KW), LGS(**LGS_KW, device=CPU)
    assert tl.cfg == LGSConfig(*JLGSConfig(**LGS_KW).key())
    assert lgs_state_bytes(tl.cfg) == sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(jl.state))
    for a, z in _cuts(tb, tl.cfg.subwindow_size):
        jl.insert(*_cols(tb.slice(a, z)))
        tl.insert(*_cols(tb.slice(a, z)))
        _equal(jl.state, tl.state)
    i = np.arange(0, N, 37)
    e = (tb.src[i], tb.src_label[i], tb.dst[i], tb.dst_label[i])
    for last in (None, 2):
        for le in (None, tb.edge_label[i]):
            np.testing.assert_array_equal(
                tl.edge_weight(*e, le=le, last=last),
                np.asarray(jl.edge_weight(*e, le=le, last=last)))
            for direction in ("out", "in"):
                np.testing.assert_array_equal(
                    tl.vertex_weight(e[0], e[1], le, direction, last),
                    np.asarray(jl.vertex_weight(e[0], e[1], le, direction,
                                                last)))
    assert tl.edge_weight(int(e[0][0]), int(e[1][0]), int(e[2][0]),
                          int(e[3][0])) == int(tl.edge_weight(*e)[0])
    for k in (0, 11, 23):
        a, b = int(tb.src[k]), int(tb.dst[k + 7])
        for hops in (1, 8):
            assert tl.reachable(a, int(tb.src_label[k]), b,
                                int(tb.dst_label[k + 7]), max_hops=hops) == \
                jl.reachable(a, int(tb.src_label[k]), b,
                             int(tb.dst_label[k + 7]), max_hops=hops)
    with pytest.raises(NotImplementedError):
        tl.label_aggregate(1)
    with pytest.raises(NotImplementedError):
        t_qb.label_aggregate_batch(tl, np.arange(2))


def test_lgs_one_batch_equals_per_subwindow_replay(stream):
    """The fused count-min insert of a batch spanning many subwindows equals
    a replay one subwindow at a time, and an empty batch is a no-op."""
    _, tb = stream
    one = LGS(**LGS_KW, device=CPU).insert(*_cols(tb))
    ref = LGS(**LGS_KW, device=CPU)
    widx = tb.time // ref.cfg.subwindow_size
    for wv in np.unique(widx):
        m = widx == wv
        ref.insert(*[c[m] for c in _cols(tb)])
    for x, y in zip(one.state.leaves(), ref.state.leaves()):
        assert np.array_equal(x.numpy(), y.numpy())
    handle = ref.handle
    ref.insert(np.array([], np.int32), np.array([], np.int32))
    assert ref.handle is handle


def test_lgs_state_carries_across(stream):
    """Half a stream in ``repro``'s LGS, carried across as numpy arrays
    (``LGS.from_numpy``), the rest inserted in both: equal states."""
    _, tb = stream
    jl = JLGS(**LGS_KW).insert(*_cols(tb.slice(0, 900)))
    tl = LGS.from_numpy(LGSConfig(**LGS_KW),
                        [np.asarray(x) for x in jax.tree.leaves(jl.state)],
                        CPU)
    _equal(jl.state, tl.state)
    jl.insert(*_cols(tb.slice(900, N)))
    tl.insert(*_cols(tb.slice(900, N)))
    _equal(jl.state, tl.state)


def _handles(kind, n_shards, tb):
    kw = dict(d=32, pool_capacity=64) if kind == "gss" else LGS_KW
    jspec = jskt.make_spec(kind, n_shards=n_shards, **kw)
    tspec = tskt.make_spec(kind, n_shards=n_shards, **kw)
    assert tspec.kind == kind and tspec.n_shards == n_shards
    js, ts = jskt.create(jspec), tskt.create(tspec, device=CPU)
    for a, z in _cuts(tb, LGS_KW["window_size"] // LGS_KW["k"]):
        js = jskt.ingest(jspec, js, _jb(tb.slice(a, z)),
                         path="pallas" if kind == "gss" else "auto")
        ts = tskt.ingest(tspec, ts, tb.slice(a, z), path="cuda")
        _equal(js.shards, ts)
    return jspec, js, tspec, ts


@pytest.mark.parametrize("kind", ["gss", "lgs"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_handles_of_both_kinds_match_reference(stream, kind, n_shards):
    """make_spec/create/ingest/query of the ``gss`` and ``lgs`` kinds, at 1
    and 4 shards, with a horizon sweep; the analytics raise for ``lgs``
    and drop the window for ``gss``."""
    _, tb = stream
    jspec, js, tspec, ts = _handles(kind, n_shards, tb)
    i = np.arange(0, N, 53)
    e = (tb.src[i], tb.src_label[i], tb.dst[i], tb.dst_label[i])
    hz = [None, 1, 3]
    for with_le in (False, True):
        le = tb.edge_label[i] if with_le else None
        for mk in (lambda Q: Q.edges(*e, le, last=hz),
                   lambda Q: Q.vertices(e[0], e[1], le, "in", last=hz)):
            want = np.asarray(jskt.query(jspec, js, mk(jskt.QueryBatch)))
            for path in ("cuda", "scan"):
                got = tskt.query(tspec, ts, mk(tskt.QueryBatch), path=path)
                np.testing.assert_array_equal(got.numpy(), want)
    if kind == "lgs":
        with pytest.raises(NotImplementedError):
            tskt.query(tspec, ts, tskt.QueryBatch.labels(np.arange(2)))
        for fn in (lambda: tskt.heavy_edges(tspec, ts, 4),
                   lambda: tskt.reachable_many(tspec, ts, e[0], e[1], e[2],
                                               e[3])):
            with pytest.raises(NotImplementedError):
                fn()
        return
    for path in ("cuda", "scan"):
        want = jskt.heavy_edges(jspec, js, 6)
        for x, y in zip(want, tskt.heavy_edges(tspec, ts, 6, last=1,
                                               path=path)):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        sweep = tskt.heavy_vertices(tspec, ts, 6, horizons=[None, 2],
                                    path=path)
        for x, y in zip(jskt.heavy_vertices(jspec, js, 6,
                                            horizons=[None, 2]), sweep):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    got = tskt.reachable_many(tspec, ts, e[0][:4], 0, e[2][:4], 0,
                              max_hops=2, horizons=[1, None])
    np.testing.assert_array_equal(got, jskt.reachable_many(
        jspec, js, e[0][:4], 0, e[2][:4], 0, max_hops=2, horizons=[1, None]))


def test_spec_kinds_and_configs():
    for kind in ("lsketch", "gss", "lgs"):
        spec = tskt.make_spec(kind, n_shards=2)
        assert spec.kind == kind
        assert spec.config == (LGSConfig() if kind == "lgs" else
                               tskt.make_spec(kind).config)
    with pytest.raises(TypeError):
        tskt.SketchSpec("lgs", gss_config())
    with pytest.raises(TypeError):
        tskt.SketchSpec("gss", LGSConfig())
    with pytest.raises(ValueError):
        tskt.make_spec("tcm")
    assert LGSConfig(d=8) == LGSConfig(d=8) and \
        hash(LGSConfig(d=8)) == hash(LGSConfig(d=8))
