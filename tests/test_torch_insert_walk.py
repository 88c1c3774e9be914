"""The redesigned write path's arithmetic on the CPU, against the JAX
package (exact int32 equality).

``emulate_walk`` replays the three steps of ``csrc/sketch_insert.cu`` in
torch: the pre-flush gather of every walked edge's 2s candidate cells, the
per-bin walk in speculative rounds of up to 32 edges that decides from the
gathered values plus the bin's claim table (its capacity, with claims past
it stored to and read back from the key plane) and commits up to the
first edge whose claimed cell an earlier edge of the round claims, and
one scatter-add of the counters. It is held equal to ``sketch_insert_plain``,
to the JAX package's interpreted hardware kernel and to
``sketch_insert_stream_walk`` over several flushes into one state. The
pool pass's plain version is held against ``repro``'s ``_pool_pass``. The
CUDA kernels themselves are held against the plain versions on the card
by ``tests/test_torch_gpu.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core.lsketch import EdgeProbes as JProbes
from repro.core.lsketch import edge_probes as j_edge_probes
from repro.core.lsketch import precompute as j_precompute
from repro.core.types import LSketchConfig as JConfig
from repro.core.types import init_state as j_init_state
from repro.kernels.sketch_insert.kernel import sketch_insert_stream_walk
from repro.kernels.sketch_insert.ops import _bin_plan as j_bin_plan
from repro.kernels.sketch_insert.ops import _pool_pass as j_pool_pass
from repro.kernels.sketch_insert.ops import \
    matrix_insert_binned_sharded as j_insert

from repro_torch.core import hashing as th
from repro_torch.core.lsketch import edge_probes, precompute
from repro_torch.core.types import EMPTY, LSketchConfig, init_leaves
from repro_torch.kernels.sketch_insert.kernel import (
    claim_table_log2, pool_pass_kernel_sharded, pool_pass_plain,
    sketch_insert_plain)
from repro_torch.kernels.sketch_insert.ops import _bin_plan
from torch_walk_emulation import compact, emulate_pool_rounds


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                  t.numpy().astype(np.int64))


def emulate_walk(rows, cols, keys, w, le, slot, order, offs, counts, key, C,
                 P, max_bin: int, log2t: int):
    """The CUDA insert's three steps, in place on ``key``/``C``/``P``
    (the wrapper's contract). Returns ``(inserted [S, B] bool, stats)``;
    ``stats`` counts the claims stored past the table, the lookups that
    read the key plane and the rounds."""
    S, B, s = rows.shape
    d, nb2, ncand = key.shape[1], counts.shape[1], 2 * rows.shape[2]
    flat = key.view(S, d * d * 2)
    # (a) the gather, every sorted position at once
    pl = torch.arange(B).expand(S, B).contiguous()
    bins = torch.searchsorted(offs.long().contiguous(), pl, right=True) - 1
    walked = (pl - offs.long().gather(1, bins)) < \
        counts.long().gather(1, bins).clamp(max=max_bin)
    sidx = torch.arange(S)[:, None]
    e = order.long()
    cell = ((rows[sidx, e].long() * d + cols[sidx, e].long()) * 2
            )[..., None] + torch.arange(2)
    cell = cell.reshape(S, B, ncand)
    kq = keys[sidx, e].long()[..., None].expand(S, B, s, 2).reshape(S, B,
                                                                   ncand)
    pre = flat.long().gather(1, cell.reshape(S, -1)).reshape(S, B, ncand)
    wq = torch.where(walked, w[sidx, e], 0)
    # (b) the walk: one bin at a time, 32 edges a chunk, in speculative
    # rounds: every undecided edge decides from the state at the round's
    # start; the edges before the first one whose claimed cell an earlier
    # edge of the round also claims commit, in stream order
    cap = 1 << (log2t - 1)  # claims the table holds
    plane = flat.clone()  # the key plane as the walk sees it
    land = [[-1] * B for _ in range(S)]
    stats = {"plane_claims": 0, "plane_lookups": 0, "rounds": 0}
    cell_l, kq_l, pre_l, w_l = (x.tolist() for x in (cell, kq, pre, wq))
    for sh in range(S):
        for nb in range(nb2):
            n = min(int(counts[sh, nb]), max_bin)
            base = int(offs[sh, nb])
            table, n_claims = {}, 0
            for c0 in range(base, base + n, 32):
                m = min(32, base + n - c0)
                start = 0
                while start < m:
                    dec = {}
                    for j in range(start, m):
                        p = c0 + j
                        if w_l[sh][p] <= 0:
                            continue
                        for q in range(ncand):
                            cl, kk = cell_l[sh][p][q], kq_l[sh][p][q]
                            cur = pre_l[sh][p][q]
                            if cur == EMPTY:
                                if cl in table:
                                    cur = table[cl]
                                elif n_claims > cap:
                                    cur = int(plane[sh, cl])
                                    stats["plane_lookups"] += 1
                            if cur == EMPTY or cur == kk:
                                dec[j] = (q, cl, kk, cur == EMPTY)
                                break
                    end, seen = m, set()
                    for j in range(start, m):
                        if j in dec and dec[j][3]:
                            if dec[j][1] in seen:
                                end = j
                                break
                            seen.add(dec[j][1])
                    for j in range(start, end):
                        if j not in dec:
                            continue
                        q, cl, kk, claim = dec[j]
                        land[sh][c0 + j] = q
                        if claim:
                            if n_claims < cap:
                                table[cl] = kk
                            else:
                                plane[sh, cl] = kk
                                stats["plane_claims"] += 1
                            n_claims += 1
                    stats["rounds"] += 1
                    start = end
    # (c) one scatter-add of the counters at the landing cells
    land = torch.tensor(land)
    hit = land >= 0
    q = land.clamp(min=0)[..., None]
    lc, lk = cell.gather(2, q)[..., 0][hit], kq.gather(2, q)[..., 0][hit]
    sh = sidx.expand(S, B)[hit]
    ws = wq[hit]
    sl = slot.long()[sh]
    flat[sh, lc] = lk.to(flat.dtype)
    C.view(S, d * d * 2, -1).index_put_((sh, lc, sl), ws, accumulate=True)
    P.view(S, d * d * 2, C.shape[-1], -1).index_put_(
        (sh, lc, sl, le[sidx, e][hit].long()), ws, accumulate=True)
    inserted = torch.zeros(S, B, dtype=torch.bool)
    inserted[sh, e[hit]] = True
    return inserted, stats


# (config, S, B, vertices, max_bin, log2 of the claim table, flushes, seed)
WALK_CASES = {
    # a loaded state over four flushes; a 4-claim table overflows to the
    # key plane in every bin
    "loaded": (dict(d=32, n_blocks=2, F=256, r=4, s=4, c=4, k=4,
                    window_size=100, pool_capacity=32, pool_probes=4),
               2, 96, 50, None, 3, 4, 0),
    # small d: a 4 x 4 tile, bins full of same-cell collisions
    "small-d": (dict(d=8, n_blocks=2, F=64, r=4, s=4, c=3, k=2,
                     window_size=100, pool_capacity=16, pool_probes=4),
                3, 64, 30, None, 2, 3, 1),
    # repeated edges, zero weights and a biting max_bin
    "repeats-zeros-max-bin": (dict(d=16, n_blocks=2, F=128, r=4, s=3, c=4,
                                   k=3, window_size=90, pool_capacity=16,
                                   pool_probes=4),
                              2, 80, 6, 5, 2, 3, 2),
    # the table sized as the wrapper sizes it: no claim passes it
    "wrapper-table": (dict(d=32, n_blocks=2, F=256, r=4, s=4, c=4, k=4,
                           window_size=100, pool_capacity=32,
                           pool_probes=4),
                      2, 96, 50, None, None, 3, 3),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_emulation_matches_plain_and_jax(case):
    kw, S, B, nv, max_bin, log2t, n_flush, seed = WALK_CASES[case]
    jcfg, tcfg = JConfig(**kw), LSketchConfig(**kw)
    n, b = tcfg.n_blocks, tcfg.b
    max_bin = B if max_bin is None else max_bin
    rng = np.random.default_rng(seed)
    emu = init_leaves(tcfg, (S,), "cpu")
    plain = init_leaves(tcfg, (S,), "cpu")
    jstate = jax.tree.map(lambda x: jnp.stack([x] * S), j_init_state(jcfg))
    run_j = jax.jit(lambda st, jp, jle, jw, jslot: j_insert(
        jcfg, st, jp, jle, jw, jslot, max_bin=max_bin, interpret=False,
        _kernel_interpret=True))
    plane_lookups = rounds = chunks = walked = 0
    for _ in range(n_flush):
        src = rng.integers(0, nv, (S, B))
        dst = rng.integers(0, nv, (S, B))
        w = rng.integers(0, 3, (S, B)).astype(np.int32)
        le = rng.integers(0, 6, (S, B)).astype(np.int32)
        slot = rng.integers(0, tcfg.k, S).astype(np.int32)
        tp = edge_probes(tcfg, precompute(tcfg, _t(src), _t(src % 3)),
                         precompute(tcfg, _t(dst), _t(dst % 3)))
        jp = j_edge_probes(jcfg, j_precompute(jcfg, jnp.asarray(src, jnp.int32),
                                              jnp.asarray(src % 3, jnp.int32)),
                           j_precompute(jcfg, jnp.asarray(dst, jnp.int32),
                                        jnp.asarray(dst % 3, jnp.int32)))
        tle = th.edge_label_bucket(_t(le), tcfg.c, tcfg.seed)
        jle = jh.edge_label_bucket(jnp.asarray(le), jcfg.c, jcfg.seed)
        _, _, order, counts, offs = _bin_plan(tcfg, tp, _t(w))
        args = (tp.rows.contiguous(), tp.cols.contiguous(),
                tp.keys.contiguous(), _t(w), tle, _t(slot), order, offs,
                counts)
        pre = emu.key.clone()
        lg = claim_table_log2(counts, max_bin) if log2t is None else log2t
        ins, stats = emulate_walk(*args, emu.key, emu.C, emu.P, max_bin, lg)
        plane_lookups += stats["plane_lookups"]
        rounds += stats["rounds"]
        fills = counts.clamp(max=max_bin)
        chunks += int(((fills + 31) // 32).sum())
        walked += int(fills.sum())
        if log2t is None:
            assert stats["plane_claims"] == 0
        ins_plain = sketch_insert_plain(*args, plain.key, plain.C, plain.P,
                                        max_bin)
        assert torch.equal(ins, ins_plain)
        for a, c in zip((emu.key, emu.C, emu.P),
                        (plain.key, plain.C, plain.P)):
            assert torch.equal(a, c)
        # the invariant: no cell that held a key before the flush changes
        held = pre != EMPTY
        assert torch.equal(emu.key[held], pre[held])
        # the stream walk: the same key plane and landing cells
        jbid0, _, jorder, jcounts, joffs = jax.vmap(
            lambda p, ww: j_bin_plan(jcfg, p, ww))(jp, jnp.asarray(w))
        jkey, enc = jax.jit(lambda *a: sketch_insert_stream_walk(
            *a, n_shards=S, n_blocks=n, b=b, max_bin=max_bin))(
                jp.rows % b, jp.cols % b, jp.keys, jnp.asarray(w), jorder,
                joffs, jcounts, jnp.moveaxis(jstate.key, 3, 1))
        _eq(jnp.moveaxis(jkey, 1, 3), emu.key)
        _eq(enc > 0, ins)
        # the interpreted hardware kernel (its pool pass leaves key/C/P)
        jstate = run_j(jstate, jp, jle, jnp.asarray(w), jnp.asarray(slot))
        for a, c in zip((jstate.key, jstate.C, jstate.P),
                        (emu.key, emu.C, emu.P)):
            _eq(a, c)
    if case == "loaded":
        assert plane_lookups > 0  # the past-the-table path was taken
    assert rounds < walked  # a round commits several edges
    if case == "small-d":
        assert rounds > chunks  # some decisions were voided and redone


def test_claim_table_is_sized_from_the_largest_walked_bin():
    counts = _t([[0, 7, 3], [2, 1, 0]])
    assert claim_table_log2(counts, 100) == 4  # 2 x 7 -> 16 slots
    assert claim_table_log2(counts, 2) == 2    # capped at max_bin
    assert claim_table_log2(_t([[0, 0]]), 10) == 1
    assert claim_table_log2(_t([[100_000]]), 10 ** 6) == 14


def _pool_inputs(rng, S, B, Q, probes, nv, rates, k, c, w_hi=4):
    """Pool-pass inputs and a pre-loaded pool (numpy): ``rates`` is each
    shard's share of eligible items."""
    pid_s = rng.integers(0, nv, (S, B)).astype(np.int32)
    pid_d = rng.integers(0, nv, (S, B)).astype(np.int32)
    w = rng.integers(0, w_hi, (S, B)).astype(np.int32)  # zeros included
    elig = (rng.random((S, B)) < np.asarray(rates)[:, None]).astype(np.int32)
    le = rng.integers(0, c, (S, B)).astype(np.int32)
    slot = rng.integers(0, k, S).astype(np.int32)
    pool_key = rng.integers(0, nv, (S, Q, 2)).astype(np.int32)
    pool_key[rng.random((S, Q)) < 0.6] = EMPTY
    pool_C = rng.integers(0, 5, (S, Q, k)).astype(np.int32)
    pool_P = rng.integers(0, 5, (S, Q, k, c)).astype(np.int32)
    lost = rng.integers(0, 3, S).astype(np.int32)
    return pid_s, pid_d, w, elig, le, slot, (pool_key, pool_C, pool_P, lost)


# (S, B, Q, probes, pid values, eligible share per shard, seed)
POOL_CASES = {
    "uneven": (3, 120, 64, 4, 40, (0.5, 0.05, 0.0), 0),
    "repeated-pairs": (2, 150, 32, 4, 5, (0.7, 0.4), 1),
    "zero-weights": (2, 100, 64, 8, 30, (0.9, 0.3), 2),
    "saturated": (2, 100, 8, 2, 60, (0.8, 0.6), 3),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_pass_plain_matches_jax(case):
    S, B, Q, probes, nv, rates, seed = POOL_CASES[case]
    kw = dict(d=16, n_blocks=2, F=128, r=4, s=4, c=3, k=4, window_size=100,
              pool_capacity=Q, pool_probes=probes)
    jcfg = JConfig(**kw)
    rng = np.random.default_rng(seed)
    pid_s, pid_d, w, elig, le, slot, pool = _pool_inputs(
        rng, S, B, Q, probes, nv, rates, jcfg.k, jcfg.c)
    if case == "zero-weights":
        assert ((w == 0) & (elig == 1)).any()
    # repro's pass, one shard at a time (vmapped), from the same pool
    base = jax.tree.map(lambda x: jnp.stack([x] * S), j_init_state(jcfg))
    base = dataclasses.replace(base, **{f: jnp.asarray(v) for f, v in zip(
        ("pool_key", "pool_C", "pool_P", "pool_lost"), pool)})
    z = jnp.zeros((S, B, 4), jnp.int32)
    jpr = JProbes(z, z, z, jnp.asarray(pid_s), jnp.asarray(pid_d))
    ref = jax.jit(jax.vmap(lambda st, sl, pr, l, ww, fl: j_pool_pass(
        jcfg, st, sl, pr, l, ww, fl)))(
            base, jnp.asarray(slot), jpr, jnp.asarray(le), jnp.asarray(w),
            jnp.asarray(elig > 0))
    got = [_t(x).clone() for x in pool]
    pool_pass_plain(_t(pid_s), _t(pid_d), _t(w), _t(w),
                    _t(np.repeat(slot[:, None], B, 1)), _t(le), _t(elig),
                    *got, probes=probes, seed=jcfg.seed)
    for a, c in zip((ref.pool_key, ref.pool_C, ref.pool_P, ref.pool_lost),
                    got):
        _eq(a, c)
    changed = [not np.array_equal(p, c.numpy()) for p, c in zip(pool, got)]
    assert any(changed)
    if case == "saturated":
        assert (got[3].numpy() > pool[3]).any()  # weight was lost
    if case == "uneven":
        assert torch.equal(got[0][2], _t(pool[0][2]))  # nothing eligible


def test_pool_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the pool wrapper is its plain version (separate
    w_count and w_key) and counts no launch."""
    S, B, Q, probes = 2, 60, 16, 4
    rng = np.random.default_rng(7)
    pid_s, pid_d, w, elig, le, slot, pool = _pool_inputs(
        rng, S, B, Q, probes, 12, (0.6, 0.3), 3, 2)
    wk = np.where(rng.random((S, B)) < 0.3, 0, w)
    sl = _t(rng.integers(0, 3, (S, B)))
    outs = []
    before = pool_pass_kernel_sharded.launches
    for fn in (pool_pass_plain, pool_pass_kernel_sharded):
        leaves = [_t(x).clone() for x in pool]
        fn(_t(pid_s), _t(pid_d), _t(w), _t(wk), sl, _t(le), _t(elig),
           *leaves, probes=probes, seed=1234)
        outs.append(leaves)
    assert pool_pass_kernel_sharded.launches == before
    for a, c in zip(*outs):
        assert torch.equal(a, c)


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_round_emulation_matches_plain(case):
    """The pool kernel's speculative rounds (separate w_count and w_key,
    per-item ring slots), read through the chunked compaction, against
    the plain pass, under the same-pair rule and under the old rule; the
    same-pair rule never takes more rounds."""
    S, B, Q, probes, nv, rates, seed = POOL_CASES[case]
    k, c = 4, 3
    rng = np.random.default_rng(seed + 10)
    pid_s, pid_d, w, elig, le, _, pool = _pool_inputs(
        rng, S, B, Q, probes, nv, rates, k, c)
    wk = np.where(rng.random((S, B)) < 0.2, 0, w).astype(np.int32)
    sl = rng.integers(0, k, (S, B)).astype(np.int32)
    want = [_t(x).clone() for x in pool]
    pool_pass_plain(_t(pid_s), _t(pid_d), _t(w), _t(wk), _t(sl), _t(le),
                    _t(elig), *want, probes=probes, seed=1234)
    rounds = {}
    for same_pair in (True, False):
        got = [x.copy() for x in pool]
        stats = emulate_pool_rounds(pid_s, pid_d, w, wk, sl, le, elig, *got,
                                    probes=probes, seed=1234,
                                    same_pair=same_pair, chunk=16)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy())
        rounds[same_pair] = sum(stats["rounds"])
        if same_pair:
            assert sum(stats["voided_same_pair"]) == 0
        else:
            assert sum(stats["merged_same_pair"]) == 0
    n_items = int(elig.sum())
    chunks = sum(-(-int(x) // 32) for x in elig.sum(1))
    assert rounds[True] <= rounds[False] < n_items
    if case == "repeated-pairs":
        # the old rule redid rounds for repeated pairs; the new one fewer
        assert rounds[False] > chunks
        assert rounds[True] < rounds[False]


@pytest.mark.parametrize("pattern,want", [
    ("one-pair", {True: 1, False: 2}),
    ("pairs-twice", {True: 1, False: 17}),
    ("one-slot-distinct-pairs", {True: 32, False: 32})])
def test_same_pair_rule_round_counts(pattern, want):
    """A group of 32 items on an empty pool. One pair 32 times: the old
    rule commits the first claim alone, then every other item matches it
    (2 rounds); the same-pair rule commits all in one. 16 pairs, each twice
    in a row: the old rule redoes a round at every second item (17). 32
    distinct pairs on one probe sequence: each lane's claim is voided by
    the lane before it under both rules (32). Each equals the plain
    pass."""
    Q, probes = 1 << 14, 32  # the 16 pairs' first slots all differ
    if pattern == "one-pair":
        pid_s, pid_d = np.full((1, 32), 7), np.full((1, 32), 9)
    elif pattern == "pairs-twice":
        pid_s, pid_d = np.repeat(np.arange(16), 2)[None], np.full((1, 32), 3)
    else:  # pairs whose first probe slot is the same
        Q = 64
        base = th.pool_slot_seq(_t(np.arange(4000)), _t(np.zeros(4000)), Q,
                                1, 1234).numpy()[:, 0]
        pid_s = np.flatnonzero(base == base[0])[:32][None]
        pid_d = np.zeros((1, 32), np.int64)
        assert pid_s.shape == (1, 32)
    pid_s, pid_d = pid_s.astype(np.int32), pid_d.astype(np.int32)
    w = np.full((1, 32), 2, np.int32)
    zero = np.zeros((1, 32), np.int32)
    elig = np.ones((1, 32), np.int32)
    pool = (np.full((1, Q, 2), EMPTY, np.int32), np.zeros((1, Q, 1), np.int32),
            np.zeros((1, Q, 1, 1), np.int32), np.zeros(1, np.int32))
    ref = [_t(x).clone() for x in pool]
    pool_pass_plain(_t(pid_s), _t(pid_d), _t(w), _t(w), _t(zero), _t(zero),
                    _t(elig), *ref, probes=probes, seed=1234)
    for same_pair in (True, False):
        got = [x.copy() for x in pool]
        stats = emulate_pool_rounds(pid_s, pid_d, w, w, zero, zero, elig,
                                    *got, probes=probes, seed=1234,
                                    same_pair=same_pair)
        assert stats["rounds"] == [want[same_pair]]
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b.numpy())


def test_compaction_reads_items_in_stream_order():
    """Chunk-local ranks plus a search over the chunk offsets give the
    eligible items in stream order, with empty chunks between."""
    rng = np.random.default_rng(5)
    elig = (rng.random(300) < 0.3).astype(np.int32)
    elig[40:200] = 0  # whole chunks with nothing eligible
    for chunk in (16, 32, 1024):
        np.testing.assert_array_equal(compact(elig, chunk),
                                      np.flatnonzero(elig))
    assert len(compact(np.zeros(50, np.int32), 16)) == 0
