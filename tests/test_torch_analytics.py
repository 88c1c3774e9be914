"""The analytics slice of the port against the JAX package (CPU, exact
int32 equality): the reversibility seam ``decode_line_vid``, the
cell-owner decode's plain version (against the XLA twin and the Pallas
kernel run by the interpreter), the top-k epilogue, the handle-layer
portfolio (heavy vertices / edges / labels, reachability) on both port
paths at single horizons and horizon sweeps, the host reference, the
one-pass multi-horizon planes and list-``last`` queries.

The planted stream wraps the window ring three times and overflows the
pool (``pool_lost`` > 0) at 1 and 4 shards; states are built by the JAX
package and carried over with ``from_numpy``, except in the one case that
ingests the same stream through both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sketch as jskt
from repro.core import analytics as jan
from repro.core import hashing as jh
from repro.core import queries as jq
from repro.core.types import EdgeBatch as JBatch
from repro.kernels.heavy_hitters import kernel as jk
from repro.kernels.heavy_hitters import ops as jops

from repro_torch import sketch as tskt
from repro_torch.core import analytics as tan
from repro_torch.core import hashing as th
from repro_torch.core import queries as tq
from repro_torch.core.lsketch import precompute
from repro_torch.core.types import EdgeBatch
from repro_torch.kernels.heavy_hitters.kernel import (
    cell_decode_kernel_sharded, cell_decode_plain)
from repro_torch.kernels.heavy_hitters.ops import segment_topk
from repro_torch.sketch.query import _with_global_window

KW = dict(d=16, n_blocks=2, F=512, r=4, s=8, c=4, k=4, window_size=400,
          pool_capacity=32, pool_probes=4)
K = KW["k"]
LASTS = [None, 1, K]
SWEEP = [None, 1, K, 1]  # None and a duplicate
KINDS = [("heavy_vertices", {"direction": "out"}),
         ("heavy_vertices", {"direction": "in"}),
         ("heavy_edges", {}),
         ("top_labels", {"direction": "out"}),
         ("top_labels", {"direction": "in"})]
KIND_IDS = ["vertex-out", "vertex-in", "edge", "label-out", "label-in"]
# uniform blocks, and a skewed layout of non-power-of-two widths
LAYOUTS = {"uniform": (32, None), "skewed": (30, ((0, 10), (10, 7), (17, 13)))}
FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
          "time")


def _planted(seed=2, n=3000) -> EdgeBatch:
    """Heavy vertex 7, heavy edge (7, 9) and the chain 7->9->11->7 in
    random traffic over 12 subwindows (the ring of 4 wraps)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 400, n)
    dst = rng.integers(0, 400, n)
    src[:400], dst[:250] = 7, 9
    src[400:450], dst[400:450] = 9, 11
    src[450:500], dst[450:500] = 11, 7
    perm = rng.permutation(n)
    src, dst = src[perm], dst[perm]
    return EdgeBatch.from_arrays(src, dst, src % 2, dst % 2,
                                 rng.integers(0, 6, n), rng.integers(1, 4, n),
                                 np.sort(rng.integers(0, 1200, n)))


def _jbatch(b: EdgeBatch):
    return JBatch(*[jnp.asarray(getattr(b, f), jnp.int32) for f in FIELDS])


@pytest.fixture(scope="module")
def handles():
    """{n_shards: (jspec, jstate, tspec, tstate)}: a JAX-built state and
    the same state carried into the port."""
    out = {}
    for ns in (1, 4):
        jspec = jskt.make_spec("lsketch", n_shards=ns, **KW)
        tspec = tskt.make_spec("lsketch", n_shards=ns, **KW)
        jst = jskt.ingest(jspec, jskt.create(jspec), _jbatch(_planted()))
        assert int(jnp.min(jst.shards.pool_lost)) > 0  # every pool overflowed
        tst = tskt.from_numpy(
            tspec, [np.asarray(x) for x in jax.tree.leaves(jst)], "cpu")
        out[ns] = (jspec, jst, tspec, tst)
    return out


def _eq(ref, got):
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --------------------------------------------------------------------------
# decode seam and the decode kernel's plain version
# --------------------------------------------------------------------------

def _layout(name):
    d, bounds = LAYOUTS[name]
    if bounds is None:
        return d, tuple(range(0, d, d // 4)), (d // 4,) * 4
    return d, tuple(s for s, _ in bounds), tuple(w for _, w in bounds)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_line_vid_matches_reference(layout):
    d, starts, widths = _layout(layout)
    rng = np.random.default_rng(0)
    r, F, n = 8, 1024, 4000
    lines = rng.integers(0, d, n).astype(np.int32)
    idx = rng.integers(0, r, n).astype(np.int32)
    f = rng.integers(0, F, n).astype(np.int32)
    ref = jh.decode_line_vid(jnp.asarray(lines), jnp.asarray(idx),
                             jnp.asarray(f), jnp.asarray(starts),
                             jnp.asarray(widths), r, F)
    got = th.decode_line_vid(torch.from_numpy(lines), torch.from_numpy(idx),
                             torch.from_numpy(f), starts, widths, r, F)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cell_decode_plain_matches_xla_twin_and_kernel(layout):
    """Random packed keys (40 % EMPTY) on a [3, 2, d, d] plane: the plain
    decode equals the XLA twin and the Pallas kernel body run by the
    interpreter; on a CPU tensor the wrapper is the plain version and
    counts no launch."""
    d, starts, widths = _layout(layout)
    rng = np.random.default_rng(1)
    r, F, shape = 8, 1024, (3, 2, d, d)
    key = np.asarray(th.pack_key(*[torch.from_numpy(rng.integers(0, hi, shape))
                                   for hi in (r, r, F, F)], F))
    key = np.where(rng.random(shape) < 0.4, -1, key).astype(np.int32)
    kw = dict(starts=starts, widths=widths, r=r, F=F)
    got = cell_decode_plain(torch.from_numpy(key), **kw)
    twin = jk.cell_decode_xla(jnp.asarray(key), starts=jnp.asarray(starts),
                              widths=jnp.asarray(widths), r=r, F=F)
    kern = jk.cell_decode_kernel_sharded(jnp.asarray(key), n_shards=3,
                                         interpret=True, **kw)
    _eq(twin, got)
    _eq(kern, got)
    before = cell_decode_kernel_sharded.launches
    _eq(got, cell_decode_kernel_sharded(torch.from_numpy(key), **kw))
    assert cell_decode_kernel_sharded.launches == before


@pytest.mark.parametrize("n_cols", [1, 2])
def test_segment_topk_matches_reference(n_cols):
    """Ties, duplicate identities, dead rows, zero and negative weights,
    totals that wrap past int32, k above the live count, and no live row
    at all."""
    rng = np.random.default_rng(5 + n_cols)
    n = 600
    cols = [rng.integers(0, 40, n) for _ in range(n_cols)]
    dead = rng.random(n) < 0.2
    cols = [np.where(dead, -1 - rng.integers(0, 3, n), c).astype(np.int32)
            for c in cols]
    w = rng.integers(-2, 6, n).astype(np.int32)
    w[:4] = 2**30  # four rows of one identity wrap to a negative total
    for c in cols:
        c[:4] = 39
    for k in (1, 7, 2000):
        ref = jops.segment_topk(tuple(jnp.asarray(c) for c in cols),
                                jnp.asarray(w), k)
        got = segment_topk(tuple(torch.from_numpy(c) for c in cols),
                           torch.from_numpy(w), k)
        _eq(ref[0], got[0])
        np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    dead = [np.full(9, -1, np.int32)] * n_cols
    ref = jops.segment_topk(tuple(map(jnp.asarray, dead)), jnp.asarray(w[:9]),
                            3)
    got = segment_topk(tuple(map(torch.from_numpy, dead)),
                       torch.from_numpy(w[:9]), 3)
    _eq(ref[0] + (ref[1],), got[0] + (got[1],))


# --------------------------------------------------------------------------
# the handle-layer portfolio
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("kind", range(len(KINDS)), ids=KIND_IDS)
def test_topk_matches_reference(handles, n_shards, kind):
    """Both port paths at last in {None, 1, k} and over a horizon sweep
    equal the JAX package's "pallas" sweep and its "scan" path."""
    name, kw = KINDS[kind]
    jspec, jst, tspec, tst = handles[n_shards]
    sweep = getattr(jskt, name)(jspec, jst, 6, horizons=SWEEP,
                                path="pallas", **kw)
    _eq([x[1] for x in sweep],
        getattr(tskt, name)(tspec, tst, 6, last=1, path="scan", **kw))
    _eq(getattr(jskt, name)(jspec, jst, 6, last=1, path="scan", **kw),
        getattr(tskt, name)(tspec, tst, 6, last=1, path="cuda", **kw))
    for path in ("scan", "cuda"):
        _eq(sweep, getattr(tskt, name)(tspec, tst, 6, horizons=SWEEP,
                                       path=path, **kw))
        for i, last in enumerate(SWEEP[:3]):
            _eq([x[i] for x in sweep], getattr(tskt, name)(
                tspec, tst, 6, last=last, path=path, **kw))


def test_topk_finds_the_planted_heavies(handles):
    _, _, tspec, tst = handles[4]
    v7, v9 = (int(precompute(tspec.config, torch.tensor([v]),
                             torch.tensor([v % 2])).vid[0]) for v in (7, 9))
    ids, _ = tskt.heavy_vertices(tspec, tst, 3, path="cuda")
    assert int(ids[0]) == v7
    s, t, _ = tskt.heavy_edges(tspec, tst, 3, path="cuda")
    assert (int(s[0]), int(t[0])) == (v7, v9)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_reachable_many_matches_reference(handles, n_shards):
    """The planted chain, an unreachable vertex and random pairs, on a
    horizon sweep and at single horizons."""
    jspec, jst, tspec, tst = handles[n_shards]
    b = _planted()
    rng = np.random.default_rng(3)
    pick = rng.integers(0, len(b), 5)
    src = np.r_[7, 7, 9990, b.src[pick]]
    sl = np.r_[1, 1, 0, b.src_label[pick]]
    dst = np.r_[11, 9990, 7, b.dst[pick[::-1]]]
    dl = np.r_[1, 0, 1, b.dst_label[pick[::-1]]]
    hz = [None, 1] if n_shards == 4 else None
    ref = np.asarray(jskt.reachable_many(jspec, jst, src, sl, dst, dl,
                                         max_hops=3, horizons=hz))
    got = tskt.reachable_many(tspec, tst, src, sl, dst, dl, max_hops=3,
                              horizons=hz)
    np.testing.assert_array_equal(ref, got)
    assert got.dtype == bool and ref.reshape(-1, len(src))[0, :3].tolist() \
        == [True, False, False]
    if hz is not None:
        for i, last in enumerate(hz):
            np.testing.assert_array_equal(ref[i], tskt.reachable_many(
                tspec, tst, src, sl, dst, dl, max_hops=3, last=last))


def test_core_analytics_matches_reference(handles):
    """The host reference on one plain shard, including triangles."""
    jspec, jst, tspec, tst = handles[1]
    jcfg, tcfg = jspec.config, tspec.config
    js, ts = jskt.unstack_state(jst, 0), tskt.unstack_state(tst, 0)
    for last in (None, 1):
        for direction in ("out", "in"):
            assert jan.heavy_hitter_vertices(jcfg, js, 8, direction, last) \
                == tan.heavy_hitter_vertices(tcfg, ts, 8, direction, last)
            assert jan.top_label_blocks(jcfg, js, 3, direction, last) \
                == tan.top_label_blocks(tcfg, ts, 3, direction, last)
        assert jan.heavy_hitter_edges(jcfg, js, 8, last) \
            == tan.heavy_hitter_edges(tcfg, ts, 8, last)
    tri = jan.triangle_estimate(jcfg, js, 8)
    assert tri >= 1 and tri == tan.triangle_estimate(tcfg, ts, 8)


def test_multi_planes_rows_match_reference(handles):
    """Every row of the one-pass build equals the JAX ``MultiPlanes`` row
    and the port's own single-horizon planes."""
    jspec, jst, tspec, tst = handles[4]
    hs = (1, 2, K)
    gw = jnp.max(jst.shards.cur_widx)
    jshards = dataclasses.replace(
        jst.shards, cur_widx=jnp.full_like(jst.shards.cur_widx, gw))
    ref = jq.build_query_planes_multi(jspec.config, jshards, hs)
    tshards = _with_global_window(tst.live())
    got = tq.build_query_planes_multi(tspec.config, tshards, hs)
    names = ("key", "cw", "pw", "pool_key", "pool_cw", "pool_pw")
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(ref, n)),
                                      getattr(got, n).numpy())
    for i, h in enumerate(hs):
        one = tq.build_query_planes(tspec.config, tshards, h)
        row = tq.slice_horizon(got, i)
        for n in names:
            assert torch.equal(getattr(one, n), getattr(row, n)), (h, n)
    with pytest.raises(ValueError, match="strictly increasing"):
        tq.build_query_planes_multi(tspec.config, tshards, (2, 1))


def _list_queries(b: EdgeBatch, rng):
    i = rng.integers(0, len(b), 40)
    v = np.r_[b.src[i[:15]], b.dst[i[15:30]], -1, 5000]
    lv = np.r_[b.src_label[i[:15]], b.dst_label[i[15:30]], 0, 1]
    le = rng.integers(0, 6, v.shape[0])
    lab = np.arange(-1, 4)
    return {
        "edge": lambda Q, last, wl: Q.edges(
            b.src[i], b.src_label[i], b.dst[i], b.dst_label[i],
            b.edge_label[i] if wl else None, last=last),
        "vertex-out": lambda Q, last, wl: Q.vertices(
            v, lv, le if wl else None, direction="out", last=last),
        "vertex-in": lambda Q, last, wl: Q.vertices(
            v, lv, le if wl else None, direction="in", last=last),
        "label-out": lambda Q, last, wl: Q.labels(
            lab, lab % 6 if wl else None, direction="out", last=last),
        "label-in": lambda Q, last, wl: Q.labels(
            lab, lab % 6 if wl else None, direction="in", last=last)}


@pytest.mark.parametrize("kind", ["edge", "vertex-out", "vertex-in",
                                  "label-out", "label-in"])
def test_list_last_query_matches_reference(handles, kind):
    """A list ``last`` gives [H, B] rows equal to the JAX sweep and to the
    port's own single-horizon answers, on both paths."""
    jspec, jst, tspec, tst = handles[4]
    make = _list_queries(_planted(), np.random.default_rng(4))[kind]
    for wl in (False, True):
        ref = np.asarray(jskt.query(jspec, jst, make(jskt.QueryBatch, SWEEP,
                                                     wl), path="pallas"))
        for path in ("scan", "cuda"):
            got = tskt.query(tspec, tst, make(tskt.QueryBatch, SWEEP, wl),
                             path=path)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(ref, got.numpy())
            for i, last in enumerate(SWEEP):
                assert torch.equal(got[i], tskt.query(
                    tspec, tst, make(tskt.QueryBatch, last, wl), path=path))


def test_sweep_arguments_are_checked(handles):
    _, _, tspec, tst = handles[1]
    with pytest.raises(ValueError, match="not both"):
        tskt.heavy_vertices(tspec, tst, 3, last=1, horizons=[1])
    with pytest.raises(ValueError, match="at least one"):
        tskt.heavy_edges(tspec, tst, 3, horizons=[])
    with pytest.raises(ValueError, match="not both"):
        tskt.reachable_many(tspec, tst, [7], [1], [9], [1], last=1,
                            horizons=[1])
    with pytest.raises(ValueError, match="at least one"):
        tskt.query(tspec, tst, tskt.QueryBatch.labels([0], last=[]))


def test_ingest_through_both_packages_then_analytics():
    """The same stream ingested by each package (port kernel route, in
    flushes) gives the same state and the same analytics."""
    b = _planted(seed=8, n=1500)
    jspec = jskt.make_spec("lsketch", n_shards=2, **KW)
    tspec = tskt.make_spec("lsketch", n_shards=2, **KW)
    jst = jskt.ingest(jspec, jskt.create(jspec), _jbatch(b))
    tst = tskt.create(tspec, device="cpu")
    for a in range(0, len(b), 500):
        tst = tskt.ingest(tspec, tst, b.slice(a, a + 500), path="cuda")
    for x, y in zip(jax.tree.leaves(jst.shards), tskt.to_numpy(tst)):
        np.testing.assert_array_equal(np.asarray(x), y)
    _eq(jskt.heavy_edges(jspec, jst, 5, horizons=[None, 1], path="pallas"),
        tskt.heavy_edges(tspec, tst, 5, horizons=[None, 1], path="cuda"))
    _eq(jskt.top_labels(jspec, jst, 2, direction="in", path="pallas"),
        tskt.top_labels(tspec, tst, 2, direction="in", path="scan"))
