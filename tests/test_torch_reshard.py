"""Merge, key-space reshard and restore across shard counts of the port
(``repro_torch.core.merge``, ``sketch.merge_all``/``shards_compatible``,
``sketch.reshard``, ``sketch.restore``) against ``repro`` on the CPU,
exactly.

States are built by ``repro``'s ingest and carried across with
``from_numpy``, so every comparison starts from the same leaves: the
configs and streams of ``tests/test_reshard.py`` (grow, shrink, pool
overflow, a contended state, fully expired records), the three routed
reshard cases of ``tests/test_routing.py``, the refusals, the card
route's landing rule run on the CPU through the kernels' plain versions
against the plain host loop, and checkpoints written by ``repro`` at N
shards restored by the port at M != N.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sketch as jskt
from repro.core import LSketchConfig as JConfig
from repro.core import merge as jmerge
from repro.core.gss import gss_config as j_gss_config
from repro.core.types import EdgeBatch as JBatch
from repro.sketch.routing import RoutingTable as JTable

from repro_torch import sketch as tskt
from repro_torch.core import merge as tmerge
from repro_torch.core.gss import gss_config
from repro_torch.core.lsketch import precompute
from repro_torch.core.types import EdgeBatch, LSketchConfig
from repro_torch.sketch.routing import RoutingTable

treshard = importlib.import_module("repro_torch.sketch.reshard")

LS = dict(d=64, n_blocks=2, F=512, r=4, s=4, c=4, k=4, window_size=4000,
          pool_capacity=512, pool_probes=8)
TINY = dict(d=8, n_blocks=2, F=256, r=2, s=2, c=4, k=4, window_size=4000,
            pool_capacity=8, pool_probes=2)
CONTENDED = dict(LS, d=32, s=2)
ROUTE = dict(d=32, n_blocks=2, F=256, r=4, s=4, c=4, k=4, window_size=400,
             pool_capacity=512, pool_probes=8)
HOT = 7
CPU = "cpu"


def _cfgs(kind, kw):
    if kind == "gss":
        return (gss_config(d=64, r=4, s=4, pool_capacity=512),
                j_gss_config(d=64, r=4, s=4, pool_capacity=512))
    return LSketchConfig(**kw), JConfig(**kw)


def _specs(kind, kw, ns):
    tc, jc = _cfgs(kind, kw)
    return (tskt.SketchSpec(kind=kind, config=tc, n_shards=ns),
            jskt.SketchSpec(kind=kind, config=jc, n_shards=ns))


def _stream(kind, seed=0, n=800, n_vertices=60):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n).astype(np.int32)
    dst = rng.integers(0, n_vertices, n).astype(np.int32)
    le = rng.integers(0, 5, n).astype(np.int32)
    w = rng.integers(1, 4, n).astype(np.int32)
    t = np.sort(rng.integers(0, 3999, n)).astype(np.int32)
    if kind == "gss":
        z = np.zeros(n, np.int32)
        return src, dst, z, z, z, w, z
    return src, dst, src % 3, dst % 3, le, w, t


def _jb(arrays) -> JBatch:
    return JBatch(*[jnp.asarray(x, jnp.int32) for x in arrays])


def _carry(tspec, jstate):
    """The port's handle over a ``repro`` handle's leaves (CPU)."""
    return tskt.from_numpy(tspec, [np.asarray(x) for x in
                                   jax.tree.leaves(jstate.shards)], CPU)


def _equal(tstate, jstate):
    tl = tskt.to_numpy(tstate)
    jl = [np.asarray(x) for x in jax.tree.leaves(jstate.shards)]
    assert len(tl) == len(jl)
    for i, (x, y) in enumerate(zip(tl, jl)):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


def _equal_plain(tplain, jplain):
    for i, (x, y) in enumerate(zip(tplain.leaves(),
                                   jax.tree.leaves(jplain))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=f"leaf {i}")


def _built(kind, kw, ns, arrays, jbatches=None):
    """(port spec, repro spec, port handle, repro handle) after ``repro``
    ingests ``arrays`` (or the batches given) into ``ns`` shards."""
    tspec, jspec = _specs(kind, kw, ns)
    jst = jskt.create(jspec)
    for b in (jbatches or [_jb(arrays)]):
        jst = jskt.ingest(jspec, jst, b)
    return tspec, jspec, _carry(tspec, jst), jst


def _lagging(kw=TINY):
    """A 2-shard state whose shard 1 lags a whole window: an early burst
    over many vertices, then late traffic routed to shard 0 only."""
    tspec, jspec = _specs("lsketch", kw, 2)
    rng = np.random.default_rng(5)
    n = 600
    src = rng.integers(0, 400, n).astype(np.int32)
    dst = rng.integers(0, 400, n).astype(np.int32)
    z = np.zeros(n, np.int32)
    early = (src, dst, src % 3, dst % 3, z, np.ones(n, np.int32), z)
    cand = np.arange(1000, 5000, dtype=np.int32)
    cand = cand[jskt.shard_assignment(jspec, cand, cand % 3) == 0]
    vs, vd = cand[:4], cand[4:8]
    m = 200
    ls = rng.choice(vs, m).astype(np.int32)
    ld = rng.choice(vd, m).astype(np.int32)
    lt = np.sort(rng.integers(4000, 8000, m)).astype(np.int32)
    late = (ls, ld, ls % 3, ld % 3, np.zeros(m, np.int32),
            np.ones(m, np.int32), lt)
    out = _built("lsketch", kw, 2, None, [_jb(early), _jb(late)])
    cw = np.asarray(out[3].shards.cur_widx)
    assert cw[1] < cw[0], "shard 1 must lag"
    return out


# --------------------------------------------------------------------------
# merge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["lsketch", "gss", "lagging", "contended",
                                  "lgs"])
def test_merge_all_and_compatibility_match_repro(case):
    if case == "lagging":
        tspec, jspec, tst, jst = _lagging()
    elif case == "lgs":
        tspec = tskt.make_spec("lgs", n_shards=3, d=32, copies=2, c=4, k=4,
                               window_size=4000)
        jspec = jskt.make_spec("lgs", n_shards=3, d=32, copies=2, c=4, k=4,
                               window_size=4000)
        jst = jskt.ingest(jspec, jskt.create(jspec),
                          _jb(_stream("lsketch", seed=6)))
        tst = _carry(tspec, jst)
    else:
        kind = "gss" if case == "gss" else "lsketch"
        kw = CONTENDED if case == "contended" else LS
        tspec, jspec, tst, jst = _built(kind, kw, 4, _stream(kind, seed=3))
    _equal_plain(tskt.merge_all(tspec, tst), jskt.merge_all(jspec, jst))
    ok = tskt.shards_compatible(tspec, tst)
    assert ok.dim() == 0 and ok.dtype == torch.bool
    assert bool(ok) == bool(jskt.shards_compatible(jspec, jst))
    if case == "contended":
        assert not bool(ok)
    if case == "lgs":
        return
    # the pairwise primitives on shards 0 and 1 of the same stack
    ta, tb = tskt.unstack_state(tst, 0), tskt.unstack_state(tst, 1)
    ja, jb = (jax.tree.map(lambda x, i=i: x[i], jst.shards) for i in (0, 1))
    assert bool(tmerge.keys_compatible(ta, tb)) == \
        bool(jmerge.keys_compatible(ja, jb))
    _equal_plain(tmerge.merge_counters(tspec.config, ta, tb),
                 jmerge.merge_counters(jspec.config, ja, jb))


def _disjoint_sources(cfg, count):
    """Source entities whose candidate rows are pairwise disjoint: no
    two shards can then contend for a matrix cell."""
    out, used = [], set()
    for v in range(4000):
        pre = precompute(cfg, torch.tensor([v]), torch.tensor([v % 3]))
        rows = set((pre.start[:, None] + (pre.s[:, None] + pre.offs)
                    % pre.width[:, None]).flatten().tolist())
        if not used & rows:
            used |= rows
            out.append(v)
            if len(out) == count:
                return np.asarray(out, np.int32)
    raise AssertionError("too few disjoint sources")


def test_merge_all_equals_single_sketch_ingest_when_compatible():
    """Sources on disjoint rows (no cross-shard contention) over a stream
    that wraps the ring three times: the merge of a 4-shard ingest is the
    1-shard ingest of the same stream, leaf for leaf, in the port alone
    and against ``repro``'s merge."""
    cfg = LSketchConfig(**LS)
    rng = np.random.default_rng(1)
    n = 400
    src = rng.choice(_disjoint_sources(cfg, 8), n).astype(np.int32)
    dst = rng.integers(0, 5000, n).astype(np.int32)
    arrays = (src, dst, src % 3, dst % 3, rng.integers(0, 4, n),
              rng.integers(1, 4, n), np.sort(rng.integers(0, 12000, n)))
    arrays = tuple(np.asarray(x, np.int32) for x in arrays)
    tspec4, jspec4, tst4, jst4 = _built("lsketch", LS, 4, arrays)
    assert bool(tskt.shards_compatible(tspec4, tst4))
    assert (tst4.shards.key != -1).flatten(1).any(1).all()  # every shard
    tspec1 = tspec4.replace(n_shards=1)
    one = tskt.ingest(tspec1, tskt.create(tspec1, device=CPU),
                      EdgeBatch.from_arrays(*arrays))
    merged = tskt.merge_all(tspec4, tst4)
    for x, y in zip(merged.leaves(), tskt.unstack_state(one, 0).leaves()):
        assert torch.equal(x, y)
    _equal_plain(merged, jskt.merge_all(jspec4, jst4))


# --------------------------------------------------------------------------
# reshard
# --------------------------------------------------------------------------

RESHARD_CASES = [
    ("lsketch", LS, 1, 4, 0), ("lsketch", LS, 4, 2, 0),
    ("gss", LS, 1, 4, 1), ("gss", LS, 4, 2, 1),
    ("overflow", TINY, 1, 4, 2), ("contended", CONTENDED, 4, 2, 3),
    ("contended", CONTENDED, 4, 8, 3), ("expired", TINY, 2, 1, 5)]


@pytest.mark.parametrize("case,kw,ns,m,seed", RESHARD_CASES)
def test_reshard_matches_repro(case, kw, ns, m, seed):
    """``reshard`` (the plain host loop on CPU tensors) leaf for leaf
    against ``repro``'s, the result on the input's device; the card route
    through the kernels' plain versions gives the same leaves."""
    kind = "gss" if case == "gss" else "lsketch"
    if case == "expired":
        tspec, jspec, tst, jst = _lagging()
    else:
        n, nv = (500, 400) if case == "overflow" else (800, 60)
        tspec, jspec, tst, jst = _built(kind, kw, ns,
                                        _stream(kind, seed, n, nv))
    if case == "overflow":
        assert int(jst.shards.pool_lost.sum()) > 0
    got = tskt.reshard(tspec, tst, m)
    want = jskt.reshard(jspec, jst, m)
    assert got.device == torch.device(CPU) and got.shards.key.shape[0] == m
    _equal(got, want)
    split = dict(treshard.RESHARD_SPLIT)
    assert split["records"] > 0 and {"decode_s", "claim_s",
                                     "scatter_s"} <= set(split)
    card = treshard._reshard(tspec, tst, tspec.replace(n_shards=m),
                             card=True)
    _equal(card, want)
    tst.live()  # the input is not consumed


def _heavy(seed, n=400, frac=0.5):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 40, n).astype(np.int32)
    dst = rng.integers(0, 40, n).astype(np.int32)
    le = rng.integers(0, 5, n).astype(np.int32)
    w = rng.integers(1, 4, n).astype(np.int32)
    t = np.sort(rng.integers(0, ROUTE["window_size"] - 1, n)).astype(
        np.int32)
    take = np.random.default_rng(seed + 1).random(n) < frac
    src[take] = HOT
    return src, dst, src % 3, dst % 3, le, w, t


def _routed(ns, splits=()):
    tspec, jspec = _specs("lsketch", ROUTE, ns)
    if splits:
        tspec = tspec.with_splits(splits)
        jspec = jspec.with_splits(splits)
    return tspec, jspec


@pytest.mark.parametrize("case", ["routing", "fold-back", "still-hot"])
def test_routed_reshard_matches_repro(case):
    """The reshard cases of ``tests/test_routing.py``: ``routing=`` a
    table, and ``detector=``/``heat_threshold=`` with a decayed detector
    (the splits fold back to the plain hash) and a hot one (the routed
    layout stays); each leaf for leaf against ``repro``, both routes."""
    arrays = _heavy(10 if case == "routing" else 21)
    splits = () if case == "routing" else [(HOT, HOT % 3, 4)]
    tspec, jspec = _routed(2, splits)
    jst = jskt.ingest(jspec, jskt.create(jspec), _jb(arrays), path="scan")
    tst = _carry(tspec, jst)
    if case == "routing":
        kw = dict(routing=RoutingTable(((HOT, HOT % 3, 4),)))
        jkw = dict(routing=JTable(((HOT, HOT % 3, 4),)))
    else:
        tdet, jdet = tskt.HeavyKeyDetector(capacity=8), \
            jskt.HeavyKeyDetector(capacity=8)
        if case == "fold-back":
            tdet.update([1, 2, 3] * 50)
            jdet.update([1, 2, 3] * 50)
        else:
            tdet.update(arrays[0], arrays[2])
            jdet.update(arrays[0], arrays[2])
        kw = dict(detector=tdet, heat_threshold=0.05)
        jkw = dict(detector=jdet, heat_threshold=0.05)
    got = tskt.reshard(tspec, tst, 4, **kw)
    want = jskt.reshard(jspec, jst, 4, **jkw)
    _equal(got, want)
    target = treshard._target(tspec, 4, kw.get("routing"),
                              kw.get("detector"), kw.get("heat_threshold"))
    _equal(treshard._reshard(tspec, tst, target, card=True), want)
    if case == "fold-back":
        plain = tskt.reshard(tspec.replace(routing=None), tst, 4)
        for x, y in zip(tskt.to_numpy(got), tskt.to_numpy(plain)):
            np.testing.assert_array_equal(x, y)
    if case == "still-hot":
        for x, y in zip(tskt.to_numpy(got),
                        tskt.to_numpy(tskt.reshard(tspec, tst, 4))):
            np.testing.assert_array_equal(x, y)


def test_reshard_refusals():
    lgs = tskt.make_spec("lgs", d=32, copies=2, c=4, k=4, window_size=400)
    with pytest.raises(NotImplementedError, match="key space"):
        tskt.reshard(lgs, tskt.create(lgs, device=CPU), 4)
    tspec, _ = _specs("lsketch", LS, 2)
    st = tskt.create(tspec, device=CPU)
    with pytest.raises(ValueError, match="n_shards"):
        tskt.reshard(tspec, st, 0)
    with pytest.raises(ValueError, match="heat_threshold"):
        tskt.reshard(tspec, st, 4, detector=tskt.HeavyKeyDetector())
    with pytest.raises(ValueError, match="heat_threshold"):
        tskt.reshard(tspec, st, 4, heat_threshold=0.1)
    empty = tskt.reshard(tspec, st, 3)  # nothing stored: fresh shards
    for x, y in zip(tskt.to_numpy(empty), tskt.to_numpy(
            tskt.create(tspec.replace(n_shards=3), device=CPU))):
        np.testing.assert_array_equal(x, y)


def test_landing_rule_equals_the_plain_loop_on_crowded_records():
    """The card route's landing rule (the first probe position whose
    final key is the record's own, else the first pool slot holding its
    pair) through the kernels' plain versions against the plain loop,
    on records that crowd the matrix, repeat pairs and overflow the pool:
    a tiny matrix fed many endpoint pairs at 1 shard, replayed to 1 and
    2 shards."""
    tspec, jspec, tst, jst = _built("lsketch", TINY, 3,
                                    _stream("lsketch", 8, 700, 120))
    assert int(jst.shards.pool_lost.sum()) > 0
    for m in (1, 2):
        target = tspec.replace(n_shards=m)
        plain = treshard._reshard(tspec, tst, target, card=False)
        card = treshard._reshard(tspec, tst, target, card=True)
        for x, y in zip(tskt.to_numpy(plain), tskt.to_numpy(card)):
            np.testing.assert_array_equal(x, y)
        assert int(plain.shards.pool_lost.sum()) > \
            int(tst.shards.pool_lost.sum())  # the replay dropped records


# --------------------------------------------------------------------------
# restore across shard counts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,n,m", [("lsketch", 1, 4), ("lsketch", 4, 2),
                                      ("gss", 2, 3), ("lgs", 2, 1),
                                      ("lgs", 2, 3)])
def test_repro_checkpoint_restores_across_shard_counts(kind, n, m, tmp_path):
    """A checkpoint ``repro`` wrote at ``n`` shards, restored by the port
    at ``m``: leaf for leaf ``repro``'s restore (lsketch/gss reshard; lgs
    merges into shard 0 or appends empty shards). A routed spec reshards
    under the requested spec's table."""
    if kind == "lgs":
        jspec = jskt.make_spec("lgs", n_shards=n, d=32, copies=2, c=4, k=4,
                               window_size=4000)
        tspec = tskt.make_spec("lgs", n_shards=n, d=32, copies=2, c=4, k=4,
                               window_size=4000)
        jst = jskt.ingest(jspec, jskt.create(jspec),
                          _jb(_stream("lsketch", seed=6)))
    else:
        tspec, jspec, _, jst = _built(kind, LS, n, _stream(kind, seed=4))
        if kind == "lsketch":
            tspec = tspec.with_splits([(3, 0, 2)])
            jspec = jspec.with_splits([(3, 0, 2)])
    jskt.save(jspec, jst, str(tmp_path))
    want = jskt.restore(jspec.replace(n_shards=m), str(tmp_path))
    got = tskt.restore(tspec.replace(n_shards=m), str(tmp_path), device=CPU)
    assert got.shards.leaves()[0].shape[0] == m
    _equal(got, want)
