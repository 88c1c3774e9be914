"""Bit parity of the port's hashing, addressing, window ring, sequential
reference insert, partition and stream generator against the JAX package
(CPU, exact int32 equality)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core.lsketch import edge_probes as j_edge_probes
from repro.core.lsketch import insert_window_batch
from repro.core.lsketch import precompute as j_precompute
from repro.core.types import EdgeBatch as JBatch
from repro.core.types import LSketchConfig as JConfig
from repro.core.types import init_state as j_init_state
from repro.data import stream as jstream
from repro.engine.window import WindowRing as JRing
from repro.sketch import spec as jspec

from repro_torch.core import hashing as th
from repro_torch.core.lsketch import (_insert_loop, advance_window,
                                      edge_probes, precompute, window_index)
from repro_torch.core.types import LSketchConfig, init_state
from repro_torch.data import stream as tstream
from repro_torch.engine.window import WindowRing
from repro_torch.sketch import spec as tspec

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _inputs(seed=0, n=512):
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, -1, -2, I32_MAX, I32_MIN, I32_MAX - 1, 2047, 2048,
                     1024, -1024], np.int32)
    rand = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
    return np.concatenate([edge, rand])


def _eq(j, t):
    a = np.asarray(j).astype(np.int64)
    b = t.numpy().astype(np.int64) if isinstance(t, torch.Tensor) \
        else np.asarray(t).astype(np.int64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1234, 0x7FFFFFFF, -5])
def test_mix_and_hash31(seed):
    x = _inputs(abs(seed) % 97)
    _eq(jh.mix32(jnp.asarray(x), seed), th.mix32(torch.from_numpy(x), seed))
    _eq(jh.hash31(jnp.asarray(x), seed), th.hash31(torch.from_numpy(x), seed))


@pytest.mark.parametrize("F,width", [(1024, 512), (256, 16), (2048, 7)])
def test_fingerprint_and_lcg_chains(F, width):
    x = _inputs(3)
    h = np.abs(x.astype(np.int64)).clip(0, I32_MAX).astype(np.int32)
    for jv, tv in zip(jh.fingerprint_split(jnp.asarray(h), F, width),
                      th.fingerprint_split(torch.from_numpy(h), F, width)):
        _eq(jv, tv)
    _eq(jh.lcg_next(jnp.asarray(x)), th.lcg_next(torch.from_numpy(x)))
    f = np.remainder(x, F).astype(np.int32)
    _eq(jh.candidate_offsets(jnp.asarray(f), 8),
        th.candidate_offsets(torch.from_numpy(f), 8))
    for jv, tv in zip(jh.sample_pairs(jnp.asarray(x), jnp.asarray(x[::-1]),
                                      8, 16),
                      th.sample_pairs(torch.from_numpy(x),
                                      torch.from_numpy(x[::-1].copy()), 8,
                                      16)):
        _eq(jv, tv)


def test_pack_unpack_and_label_hashes():
    x = _inputs(5)
    rng = np.random.default_rng(5)
    ia, ib = (rng.integers(0, 16, x.shape[0]).astype(np.int32)
              for _ in range(2))
    fa, fb = (rng.integers(0, 1024, x.shape[0]).astype(np.int32)
              for _ in range(2))
    for args in ((ia, ib, fa, fb), (x, x[::-1].copy(), x, x)):
        _eq(jh.pack_key(*map(jnp.asarray, args), 1024),
            th.pack_key(*map(torch.from_numpy, args), 1024))
        _eq(jh.pack_vertex_id(*map(jnp.asarray, args[:3]), 1024),
            th.pack_vertex_id(*map(torch.from_numpy, args[:3]), 1024))
    for jv, tv in zip(jh.unpack_key(jnp.asarray(x), 1024),
                      th.unpack_key(torch.from_numpy(x), 1024)):
        _eq(jv, tv)
    for jv, tv in zip(jh.unpack_vertex_id(jnp.asarray(x), 512),
                      th.unpack_vertex_id(torch.from_numpy(x), 512)):
        _eq(jv, tv)
    _eq(jh.vertex_label_block(jnp.asarray(x), 4, 99),
        th.vertex_label_block(torch.from_numpy(x), 4, 99))
    _eq(jh.edge_label_bucket(jnp.asarray(x), 16, 99),
        th.edge_label_bucket(torch.from_numpy(x), 16, 99))
    _eq(jh.pool_slot_seq(jnp.asarray(x), jnp.asarray(x[::-1]), 16384, 16, 7),
        th.pool_slot_seq(torch.from_numpy(x),
                         torch.from_numpy(x[::-1].copy()), 16384, 16, 7))


@pytest.mark.parametrize("kw", [
    dict(d=64, n_blocks=4, F=1024, r=8, s=8),
    dict(d=2048, n_blocks=4, F=1024, r=8, s=8, c=16, k=8),
    dict(d=48, n_blocks=1, F=256, r=4, s=16,
         block_bounds=((0, 16), (16, 32))),
])
def test_precompute_and_edge_probes(kw):
    jcfg, tcfg = JConfig(**kw), LSketchConfig(**kw)
    x = _inputs(7)
    lab = np.random.default_rng(7).integers(-3, 40, x.shape[0]).astype(
        np.int32)
    ja = j_precompute(jcfg, jnp.asarray(x), jnp.asarray(lab))
    jb = j_precompute(jcfg, jnp.asarray(lab), jnp.asarray(x))
    ta = precompute(tcfg, torch.from_numpy(x), torch.from_numpy(lab))
    tb = precompute(tcfg, torch.from_numpy(lab), torch.from_numpy(x))
    for jv, tv in zip(ja, ta):
        _eq(jv, tv)
    for jv, tv in zip(j_edge_probes(jcfg, ja, jb), edge_probes(tcfg, ta, tb)):
        _eq(jv, tv)


@pytest.mark.parametrize("seed", range(4))
def test_window_plan_matches_reference(seed):
    rng = np.random.default_rng(seed)
    k, S, B = 4, 3, 40
    slot_widx = rng.integers(-2, 12, (S, k)).astype(np.int32)
    slot_widx[0, 1] = -(2**30)
    cur = slot_widx.max(1).astype(np.int32)
    widx = np.sort(rng.integers(0, 20, (S, B)), axis=1).astype(np.int32)
    valid = np.arange(B)[None, :] < rng.integers(0, B + 1, S)[:, None]
    ring, tring = JRing(k), WindowRing(k)
    tp = tring.plan(torch.from_numpy(slot_widx), torch.from_numpy(cur),
                    torch.from_numpy(widx), torch.from_numpy(valid))
    for s in range(S):
        jp = ring.plan(jnp.asarray(slot_widx[s]), jnp.asarray(cur[s]),
                       jnp.asarray(widx[s]), valid=jnp.asarray(valid[s]))
        for jv, tv in zip(jp, tp):
            _eq(jv, tv[s])
    for last in (None, 1, 2, 9):
        _eq(ring.valid_mask(jnp.asarray(slot_widx[1]), jnp.asarray(cur[1]),
                            last),
            tring.valid_mask(torch.from_numpy(slot_widx[1]),
                             torch.tensor(cur[1]), last))


def test_partition_hash_and_stream_generator():
    x = _inputs(11)
    _eq(jspec._hash31_np(x, 77), tspec._hash31_np(x, 77))
    jsp = jspec.make_spec("lsketch", n_shards=4, d=32, n_blocks=2)
    tsp = tspec.make_spec("lsketch", n_shards=4, d=32, n_blocks=2)
    lab = x[::-1].copy()
    _eq(jspec.shard_assignment(jsp, x, lab),
        tspec.shard_assignment(tsp, x, lab))
    for name in ("phone", "comfs"):
        js = dataclasses.replace(jstream.SPECS[name], n_edges=3000)
        ts = dataclasses.replace(tstream.SPECS[name], n_edges=3000)
        a, b = jstream.generate(js, 3, True), tstream.generate(ts, 3, True)
        for f in ("src", "dst", "src_label", "dst_label", "edge_label",
                  "weight", "time"):
            _eq(getattr(a, f), getattr(b, f))


def test_sequential_reference_insert_matches_jax():
    """``advance_window`` + ``_insert_loop`` (one subwindow per call) equal
    the reference's ``insert_window_batch`` leaf for leaf, through ring
    reuse and a tiny pool."""
    kw = dict(d=16, n_blocks=2, F=256, r=4, s=4, c=4, k=2, window_size=50,
              pool_capacity=8, pool_probes=2)
    jcfg, tcfg = JConfig(**kw), LSketchConfig(**kw)
    rng = np.random.default_rng(13)
    jst, tst = j_init_state(jcfg), init_state(tcfg, device="cpu")
    for t in (3, 30, 60, 61, 140):
        n = 60
        cols = [rng.integers(0, 90, n), rng.integers(0, 90, n),
                rng.integers(0, 3, n), rng.integers(0, 3, n),
                rng.integers(0, 6, n), rng.integers(0, 3, n), np.full(n, t)]
        cols = [c.astype(np.int32) for c in cols]
        widx = int(window_index(tcfg, t))
        jst = insert_window_batch(jcfg, jst, JBatch(*map(jnp.asarray, cols)),
                                  widx)
        tc = [torch.from_numpy(c) for c in cols]
        probes = edge_probes(tcfg, precompute(tcfg, tc[0], tc[2]),
                             precompute(tcfg, tc[1], tc[3]))
        le = th.edge_label_bucket(tc[4], tcfg.c, tcfg.seed)
        tst, slot, live = advance_window(tcfg, tst, widx)
        _insert_loop(tcfg, tst, slot, live, probes, le, tc[5])
        for a, b in zip(jax.tree.leaves(jst), tst.leaves()):
            _eq(a, b)
    assert int(jst.pool_lost) > 0
