"""create -> ingest -> query of the port against ``repro.sketch`` (CPU,
exact int32 equality): states leaf for leaf after every flush, and every
query kind x edge label x horizon on both query paths. The stream wraps
the window ring several times, overflows a tiny pool (``pool_lost`` > 0)
and mixes flushes cut at subwindow boundaries (kernel route) with flushes
that span them (scan route)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import sketch as jskt
from repro.core.types import EdgeBatch as JBatch

from repro_torch import sketch as tskt
from repro_torch.core.types import EdgeBatch
from repro_torch.engine import insert as t_insert

KW = dict(d=16, n_blocks=2, F=256, r=4, s=4, c=4, k=4, window_size=100,
          pool_capacity=8, pool_probes=2)
HORIZONS = [None, 1, 2, 3, 4]
FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
          "time")


def _stream(seed, n=900, zero_weights=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 150, n)
    dst = rng.integers(0, 150, n)
    w = rng.integers(0 if zero_weights else 1, 4, n)
    t = np.sort(rng.integers(0, 420, n))  # subwindows of 25: ring wraps
    return EdgeBatch.from_arrays(src, dst, src % 3, dst % 3,
                                 rng.integers(0, 6, n), w, t)


def _flush_cuts(b: EdgeBatch):
    """Alternate single-subwindow flushes with boundary-spanning ones."""
    widx = b.time // (KW["window_size"] // KW["k"])
    starts = np.flatnonzero(np.diff(widx)) + 1
    cuts, a = [0], 0
    for i, s in enumerate(starts):
        if i % 3 == 2:
            continue  # the next flush spans this boundary
        cuts.append(int(s))
    cuts.append(len(b))
    return [(a, z) for a, z in zip(cuts[:-1], cuts[1:]) if z > a]


def _jbatch(b: EdgeBatch):
    return JBatch(*[jnp.asarray(getattr(b, f), jnp.int32) for f in FIELDS])


def _assert_states_equal(jstate, tstate):
    for a, b in zip(jax.tree.leaves(jstate.shards), tskt.to_numpy(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _queries(b: EdgeBatch, rng):
    idx = rng.integers(0, len(b), 24)
    e = dict(src=b.src[idx], src_label=b.src_label[idx], dst=b.dst[idx],
             dst_label=b.dst_label[idx], edge_label=b.edge_label[idx])
    v = np.concatenate([b.src[idx[:8]], b.dst[idx[8:16]], [-1, 5000]])
    lv = np.concatenate([b.src_label[idx[:8]], b.dst_label[idx[8:16]],
                         [0, 1]])
    le = rng.integers(0, 6, v.shape[0])
    lab = np.arange(-1, 5)
    return [
        ("edge", lambda Q, with_le, last: Q.edges(
            e["src"], e["src_label"], e["dst"], e["dst_label"],
            e["edge_label"] if with_le else None, last=last)),
        ("vertex-out", lambda Q, with_le, last: Q.vertices(
            v, lv, le if with_le else None, direction="out", last=last)),
        ("vertex-in", lambda Q, with_le, last: Q.vertices(
            v, lv, le if with_le else None, direction="in", last=last)),
        ("label-out", lambda Q, with_le, last: Q.labels(
            lab, lab % 6 if with_le else None, direction="out", last=last)),
        ("label-in", lambda Q, with_le, last: Q.labels(
            lab, lab % 6 if with_le else None, direction="in", last=last)),
    ]


def _check_queries(jspec, jstate, tspec, tstate, b, rng):
    for _, make in _queries(b, rng):
        for with_le in (False, True):
            # one multi-horizon JAX dispatch answers every horizon (bit-
            # identical to its single-horizon scan path in the reference)
            ref = np.asarray(jskt.query(
                jspec, jstate, make(jskt.QueryBatch, with_le, HORIZONS),
                path="pallas"))
            for path in ("scan", "cuda"):
                for h, last in enumerate(HORIZONS):
                    got = tskt.query(tspec, tstate,
                                     make(tskt.QueryBatch, with_le, last),
                                     path=path)
                    np.testing.assert_array_equal(ref[h], got.numpy())


@pytest.mark.parametrize("n_shards,path,zero_weights", [
    (1, "cuda", False),
    (1, "scan", False),
    (4, "cuda", True),
    (4, "scan", True),
])
def test_create_ingest_query_matches_reference(n_shards, path, zero_weights):
    """Zero weights make the two insert routes differ (the kernel claims a
    key only for w > 0, the scan also for w == 0): each port route must
    follow its JAX counterpart ("pallas" / "scan")."""
    b = _stream(n_shards + 10 * zero_weights, zero_weights=zero_weights)
    jspec = jskt.make_spec("lsketch", n_shards=n_shards, **KW)
    tspec = tskt.make_spec("lsketch", n_shards=n_shards, **KW)
    jstate, tstate = jskt.create(jspec), tskt.create(tspec, device="cpu")
    jpath = "pallas" if path == "cuda" else "scan"
    before = dict(t_insert.ROUTE_EDGES)
    rng = np.random.default_rng(0)
    for i, (a, z) in enumerate(_flush_cuts(b)):
        jstate = jskt.ingest(jspec, jstate, _jbatch(b.slice(a, z)),
                             path=jpath)
        tstate = tskt.ingest(tspec, tstate, b.slice(a, z), path=path)
        _assert_states_equal(jstate, tstate)
        if i == 4:  # mid-stream: the plane cache of a live handle
            _check_queries(jspec, jstate, tspec, tstate, b.slice(0, z), rng)
    assert int(jnp.sum(jstate.shards.pool_lost)) > 0  # pool overflowed
    _check_queries(jspec, jstate, tspec, tstate, b, rng)
    routed = {k: t_insert.ROUTE_EDGES[k] - before[k] for k in before}
    if path == "cuda":
        assert routed["kernel"] > 0 and routed["scan"] > 0
    else:
        assert routed == {"kernel": 0, "scan": len(b)}


def test_from_numpy_carries_a_jax_built_state():
    """A state built by the JAX package answers identically in the port
    and keeps ingesting identically."""
    b = _stream(21)
    jspec = jskt.make_spec("lsketch", n_shards=4, **KW)
    tspec = tskt.make_spec("lsketch", n_shards=4, **KW)
    jstate = jskt.create(jspec)
    for a, z in ((0, 500), (500, 620)):
        jstate = jskt.ingest(jspec, jstate, _jbatch(b.slice(a, z)))
    tstate = tskt.from_numpy(
        tspec, [np.asarray(x) for x in jax.tree.leaves(jstate)], "cpu")
    _assert_states_equal(jstate, tstate)
    _check_queries(jspec, jstate, tspec, tstate, b.slice(0, 620),
                   np.random.default_rng(1))
    jstate = jskt.ingest(jspec, jstate, _jbatch(b.slice(620, 900)))
    tstate = tskt.ingest(tspec, tstate, b.slice(620, 900), path="scan")
    _assert_states_equal(jstate, tstate)
