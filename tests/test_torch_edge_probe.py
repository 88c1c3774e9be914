"""The redesigned edge probe (``csrc/sketch_query.cu``, ``csrc/
addressing.cuh``) emulated on the CPU and held to the port's plain
versions and to the JAX package (exact int32 equality).

* a numpy-uint32 mirror of ``addressing.cuh``, one candidate at a time as
  a lane derives it, against the port's ``precompute`` / ``edge_probes`` /
  ``edge_label_bucket`` / ``pool_slot_seq`` and ``repro.core.lsketch``;
* a mirror of the half-warp walk (16-lane chunks in candidate order,
  the lowest ballot bit of match | EMPTY is the stop) and of the pool
  probe (16-lane chunks, the first match among every probe, empty slots
  do not stop it) against ``sketch_query_plain``, ``edge_query_plain``
  and the Pallas kernel run by the interpreter, with 2s > 16 and
  pool_probes > 16 among the configurations;
* ``edge_query_plain`` on ``MultiPlanes`` against the reference's
  ``edge_query_planes`` on 5-dim planes, and a list-``last`` edge query
  against its per-horizon rows.

Mirror any change to the kernel's rules (chunk width, stop, pool winner,
addressing) in ``mirror_*`` / ``emulate_*`` below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sketch as jskt
from repro.core import hashing as jh
from repro.core.lsketch import edge_probes as j_edge_probes
from repro.core.lsketch import precompute as j_precompute
from repro.core.queries import build_query_planes as j_build_planes
from repro.core.queries import build_query_planes_multi as j_build_multi
from repro.core.types import EdgeBatch as JBatch
from repro.core.types import LSketchConfig as JConfig
from repro.kernels.sketch_query.kernel import \
    sketch_query_kernel_sharded as j_query_kernel
from repro.kernels.sketch_query.ops import edge_query_planes as j_edge_planes
from repro.sketch.query import _with_global_window as j_global_window

from repro_torch import sketch as tskt
from repro_torch.core import hashing as th
from repro_torch.core.lsketch import edge_probes, precompute
from repro_torch.core.queries import MultiPlanes, QueryPlanes
from repro_torch.core.types import EdgeBatch, LSketchConfig
from repro_torch.kernels.sketch_query.kernel import (
    edge_query_kernel, edge_query_plain, sketch_query_kernel_sharded,
    sketch_query_plain)
from repro_torch.kernels.sketch_query.ops import edge_query_planes

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
U32 = np.uint32
LANES = 16  # LSK_QGROUP

# the deployment's shape rules at small widths; s = 12 (24 candidates,
# two chunks) with 20 pool probes (two chunks)
SMALL = dict(d=32, n_blocks=2, F=256, r=4, s=4, c=4, k=4, window_size=100,
             pool_capacity=32, pool_probes=4)
WIDE = dict(d=16, n_blocks=2, F=256, r=8, s=12, c=4, k=4, window_size=100,
            pool_capacity=64, pool_probes=20)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _eq(j, t):
    a = np.asarray(j).astype(np.int64)
    b = t.numpy().astype(np.int64) if isinstance(t, torch.Tensor) \
        else np.asarray(t).astype(np.int64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


# ---- the mirror of addressing.cuh (numpy uint32 wraps like the card) ----

def _u(x):
    return np.asarray(x, np.int64).astype(np.int32).view(U32)


def mirror_mix32(x, seed):
    h = _u(x) ^ U32(seed & 0xFFFFFFFF)
    h ^= h >> U32(16)
    h *= U32(0x85EBCA6B)
    h ^= h >> U32(13)
    h *= U32(0xC2B2AE35)
    h ^= h >> U32(16)
    return h


def mirror_hash31(x, seed):
    return (mirror_mix32(x, seed) & U32(0x7FFFFFFF)).astype(np.int64)


def mirror_lcg_steps(x, n):
    """lcg^n(x) for a per-element step count ``n``."""
    x, n = np.broadcast_arrays(np.asarray(x, U32), np.asarray(n))
    x = x.copy()
    for i in range(int(n.max(initial=0))):
        nxt = (U32(1103515245) * x + U32(12345)) & U32(0x7FFFFFFF)
        x = np.where(i < n, nxt, x)
    return x


def mirror_precompute(cfg, v, label):
    """(start, width, s, f, vid) of each endpoint, as lsk_precompute."""
    starts, widths = (np.asarray(t.numpy(), np.int64)
                      for t in cfg.block_start_width())
    seed = cfg.seed & 0xFFFFFFFF
    m = mirror_hash31(label, seed ^ 0x5B1D) % cfg.n_blocks
    start, width = starts[m], widths[m]
    h = mirror_hash31(v, seed)
    f = h % cfg.F
    s = (h // cfg.F) % width
    vid = ((m.astype(U32) * U32(2048) + s.astype(U32)) * U32(cfg.F) +
           f.astype(U32)).view(np.int32)
    return dict(start=start, width=width, s=s, f=f, vid=vid)


def mirror_probe(cfg, a, b, pi):
    """(row, col, key) of probe ``pi`` ([B] or [B, n]), as lsk_edge_probe;
    also whether s + offset wrapped in int32 on either side."""
    fa, fb = a["f"][:, None], b["f"][:, None]
    x = mirror_lcg_steps(fa.astype(U32) + fb.astype(U32),
                         pi + 1).astype(np.int64)
    ai, bi = (x // cfg.r) % cfg.r, x % cfg.r
    oa = mirror_lcg_steps(np.broadcast_to(fa, ai.shape), ai + 1)
    ob = mirror_lcg_steps(np.broadcast_to(fb, bi.shape), bi + 1)
    sa = (a["s"][:, None].astype(U32) + oa).view(np.int32).astype(np.int64)
    sb = (b["s"][:, None].astype(U32) + ob).view(np.int32).astype(np.int64)
    row = a["start"][:, None] + np.mod(sa, a["width"][:, None])  # floor
    col = b["start"][:, None] + np.mod(sb, b["width"][:, None])
    key = ((((ai.astype(U32) * U32(16) + bi.astype(U32)) * U32(cfg.F) +
             fa.astype(U32)) * U32(cfg.F)) + fb.astype(U32)).view(np.int32)
    return row, col, key, (sa < 0) | (sb < 0)


def mirror_label_bucket(cfg, le):
    return mirror_hash31(le, (cfg.seed & 0xFFFFFFFF) ^ 0x77E1) % cfg.c


def mirror_pool_base(cfg, vid_a, vid_b, q):
    x = (_u(vid_a) * U32(0x9E3779B9)) ^ _u(vid_b)
    h0 = mirror_mix32(x.view(np.int32), (cfg.seed & 0xFFFFFFFF) ^ 0x0031)
    return (h0 & U32(0x7FFFFFFF)).astype(np.int64) % q


def _queries(rng, n, nv):
    """Seeded int32 queries with the corners: EMPTY (-1) padding rows, 0,
    INT32_MIN / INT32_MAX as vertex and label."""
    corner = np.array([-1, 0, I32_MIN, I32_MAX, -2, 1], np.int64)
    cols = []
    for hi in (nv, 3, nv, 3, 6):
        x = rng.integers(0, hi, n)
        x[:len(corner)] = rng.permutation(corner)
        cols.append(x.astype(np.int32))
    return cols  # src, la, dst, lb, le


def _wrapping_vertices(cfg, n):
    """``n`` vertices whose s + offset wraps in int32 for some candidate
    (found by the mirror; needs a block width near 2^24)."""
    v = np.arange(1, 400_000, dtype=np.int32)
    a = mirror_precompute(cfg, v, np.zeros_like(v))
    offs = mirror_lcg_steps(np.broadcast_to(a["f"][:, None], (len(v), cfg.r)),
                            np.arange(1, cfg.r + 1)).astype(np.int64)
    wraps = (a["s"][:, None] + offs > I32_MAX).any(1)
    assert wraps.sum() >= n
    return v[wraps][:n]


@pytest.mark.parametrize("kw", [
    SMALL, WIDE, dict(SMALL, seed=-5),
    # a 2^23-wide block: s + offset wraps for ~1 % of candidates
    dict(d=2**24, n_blocks=2, F=1024, r=16, s=64, c=16, k=4,
         window_size=0, pool_capacity=16384, pool_probes=16,
         seed=0x7FFFFFFF)], ids=["small", "wide", "neg-seed", "wraps"])
def test_addressing_mirror_is_bit_exact(kw):
    cfg, jcfg = LSketchConfig(**kw), JConfig(**kw)
    rng = np.random.default_rng(3)
    src, la, dst, lb, le = _queries(rng, 400, 1 << 30)
    src[:50] = _wrapping_vertices(cfg, 50) if cfg.d == 2**24 else src[:50]
    ma, mb = mirror_precompute(cfg, src, la), mirror_precompute(cfg, dst, lb)
    pi = np.arange(cfg.s)
    row, col, key, wrapped = mirror_probe(cfg, ma, mb, pi[None, :])
    if cfg.d == 2**24:
        assert wrapped.any()  # the int32 wrap and the floor modulo ran
    bucket = mirror_label_bucket(cfg, le)
    base = mirror_pool_base(cfg, ma["vid"], mb["vid"], cfg.pool_capacity)
    slots = (base[:, None] + np.arange(cfg.pool_probes)) % cfg.pool_capacity

    pa, pb = precompute(cfg, _t(src), _t(la)), precompute(cfg, _t(dst), _t(lb))
    tp = edge_probes(cfg, pa, pb)
    ja = j_precompute(jcfg, jnp.asarray(src), jnp.asarray(la))
    jb = j_precompute(jcfg, jnp.asarray(dst), jnp.asarray(lb))
    jp = j_edge_probes(jcfg, ja, jb)
    for name, mine in (("start", ma["start"]), ("width", ma["width"]),
                       ("s", ma["s"]), ("f", ma["f"]), ("vid", ma["vid"])):
        _eq(mine, getattr(pa, name))
        _eq(mine, getattr(ja, name))
    for mine, t, j in ((row, tp.rows, jp.rows), (col, tp.cols, jp.cols),
                       (key, tp.keys, jp.keys),
                       (mb["vid"], tp.pid_dst, jp.pid_dst)):
        _eq(mine, t)
        _eq(mine, j)
    _eq(bucket, th.edge_label_bucket(_t(le), cfg.c, cfg.seed))
    _eq(bucket, jh.edge_label_bucket(jnp.asarray(le), cfg.c, cfg.seed))
    _eq(slots, th.pool_slot_seq(tp.pid_src, tp.pid_dst, cfg.pool_capacity,
                                cfg.pool_probes, cfg.seed))
    _eq(slots, jh.pool_slot_seq(jp.pid_src, jp.pid_dst, cfg.pool_capacity,
                                cfg.pool_probes, cfg.seed))
    # one lane's candidate j: probe j // 2 alone gives the same cell
    lane_row, _, lane_key, _ = mirror_probe(cfg, ma, mb,
                                            np.full((1, 1), cfg.s - 1))
    _eq(lane_row[:, 0], row[:, -1])
    _eq(lane_key[:, 0], key[:, -1])


# ---- the mirror of the half-warp walk and the pool probe ----------------

def _ffs(ballot):
    """Index of the lowest set bit of each non-zero ballot (__ffs - 1)."""
    low = ballot & -ballot
    return np.where(ballot > 0, np.log2(np.maximum(low, 1)).astype(np.int64),
                    -1)


def emulate_walk(rows, cols, keys, key):
    """Per (shard, query): the stop's candidate index (-1: none), whether
    it matched, and its cell (tz, row, col), chunk by chunk of 16 lanes."""
    S = key.shape[0]
    nq, s = rows.shape
    n = 2 * s
    stop = np.full((S, nq), -1)
    match = np.zeros((S, nq), bool)
    sh = np.arange(S)[:, None, None]
    for j0 in range(0, n, LANES):
        j = j0 + np.arange(LANES)
        live = j < n
        pi, tz = np.minimum(j, n - 1) >> 1, j & 1
        cur = key[sh, tz[None, None], rows[None][..., pi], cols[None][..., pi]]
        m = (cur == keys[None][..., pi]) & live
        st = (m | (cur == -1)) & live  # [S, nq, 16]
        ballot = (st.astype(np.int64) << np.arange(LANES)).sum(-1)
        owner = _ffs(ballot)
        new = (stop < 0) & (ballot > 0)
        stop = np.where(new, j0 + owner, stop)
        match = np.where(new, np.take_along_axis(
            m, np.maximum(owner, 0)[..., None], -1)[..., 0], match)
    return stop, match


def emulate_pool(pool_key, vid_a, vid_b, base, probes):
    """Per (shard, query): the winning pool slot (-1: none) — the lowest
    lane of the first 16-lane chunk with a match; empty slots never
    stop the probe."""
    S, Q, _ = pool_key.shape
    win = np.full((S, len(vid_a)), -1)
    for j0 in range(0, probes, LANES):
        j = j0 + np.arange(LANES)
        slot = (base[:, None] + j) % Q  # [nq, 16]
        pk = pool_key[:, slot]  # [S, nq, 16, 2]
        m = (pk[..., 0] == vid_a[:, None]) & (pk[..., 1] == vid_b[:, None]) \
            & (j < probes)
        ballot = (m.astype(np.int64) << np.arange(LANES)).sum(-1)
        owner = _ffs(ballot)
        new = (win < 0) & (ballot > 0)
        win = np.where(new, np.take_along_axis(
            np.broadcast_to(slot, m.shape), np.maximum(owner, 0)[..., None],
            -1)[..., 0], win)
    return win


def emulate_contract(rows, cols, keys, le, key, cw, pw):
    """The contract entry: (w, wl, go_pool) [S, nq]."""
    stop, match = emulate_walk(rows, cols, keys, key)
    S = key.shape[0]
    st = np.maximum(stop, 0)
    pi, tz = st >> 1, st & 1
    rr = np.take_along_axis(np.broadcast_to(rows, (S,) + rows.shape),
                            pi[..., None], -1)[..., 0]
    cc = np.take_along_axis(np.broadcast_to(cols, (S,) + cols.shape),
                            pi[..., None], -1)[..., 0]
    sh = np.arange(S)[:, None]
    w = np.where(match, cw[sh, tz, rr, cc], 0)
    wl = np.where(match, pw[sh, tz, rr, cc, le[None]], 0) \
        if le is not None else np.zeros_like(w)
    return w, wl, (stop < 0).astype(np.int32)


def emulate_fused(cfg, planes, src, la, dst, lb, le):
    """The fused entry on numpy leaves with a leading [H]: (w, wl)
    [H, S, B] — the mirror's addressing, the walk, then the pool."""
    key, pool_key, cw, pw, pool_cw, pool_pw = planes
    a, b = mirror_precompute(cfg, src, la), mirror_precompute(cfg, dst, lb)
    rows, cols, keys, _ = mirror_probe(cfg, a, b, np.arange(cfg.s)[None])
    lab = None if le is None else mirror_label_bucket(cfg, le)
    stop, match = emulate_walk(rows, cols, keys, key)
    S, Q = key.shape[0], pool_key.shape[1]
    base = mirror_pool_base(cfg, a["vid"], b["vid"], Q)
    win = emulate_pool(pool_key, a["vid"], b["vid"], base, cfg.pool_probes)
    win = np.where(stop < 0, win, -1)
    ws, wls = [], []
    for h in range(cw.shape[0]):
        w, wl, _ = emulate_contract(rows, cols, keys, lab, key, cw[h], pw[h])
        sh = np.arange(S)[:, None]
        ws.append(np.where(win >= 0, pool_cw[h][sh, np.maximum(win, 0)], w))
        wls.append(wl if lab is None else np.where(
            win >= 0, pool_pw[h][sh, np.maximum(win, 0), lab[None]], wl))
    return np.stack(ws), np.stack(wls), win


def _jax_state(kw, S, seed, n=400, nv=60, times=(10, 60, 120, 180)):
    """A JAX-built sharded state with wraparound and pool overflow."""
    jcfg = JConfig(**kw)
    rng = np.random.default_rng(seed)
    spec = jskt.SketchSpec(kind="lsketch", config=jcfg, n_shards=S)
    state = jskt.create(spec)
    edges = []
    for t in times:
        cols = (rng.integers(0, nv, n), rng.integers(0, 3, n),
                rng.integers(0, nv, n), rng.integers(0, 3, n),
                rng.integers(0, 6, n))
        edges.append(np.stack(cols))
        src, la, dst, lb, le = cols
        state = jskt.ingest(spec, state, JBatch(
            *[jnp.asarray(x, jnp.int32) for x in (
                src, dst, la, lb, le, rng.integers(1, 4, n),
                np.full(n, t))]))
    return jcfg, j_global_window(state.shards), rng, \
        np.concatenate(edges, 1).astype(np.int32)


def _mixed_queries(rng, edges, n, nv):
    """``_queries`` with every other row an edge of the stream (src, la,
    dst, lb, le), so that walks stop late in the candidate order and in
    the pool."""
    q = _queries(rng, n, nv)
    pick = rng.choice(edges.shape[1], n // 2)
    for col, e in zip(q, edges):
        col[1::2] = e[pick][:len(col[1::2])]
    return q


def _np(planes):
    """Writable numpy copies of the leaves, key and pool_key first."""
    return [np.array(x) for x in (planes.key, planes.pool_key, planes.cw,
                                  planes.pw, planes.pool_cw, planes.pool_pw)]


def _plant(cfg, rng, key, pool_key, rows, cols, keys, a, b, base):
    """Plant, in place, what a stream this small rarely makes: walks whose
    first 16 candidates hold other keys and whose key sits at candidate 17
    (2s > 16 only), and for walks without a stop their pool pair at probe
    p of {0, 1, 3, 16, 17, 19} (those < pool_probes), past an EMPTY slot
    at p - 1 and before a second copy at p + 1 (the first must win)."""
    S, Q = key.shape[0], pool_key.shape[1]
    if 2 * cfg.s > LANES:
        for q in range(0, len(keys), 4):
            for j in range(LANES):
                other = keys[q, j >> 1] + 1
                key[:, j & 1, rows[q, j >> 1], cols[q, j >> 1]] = \
                    other if other != -1 else 7
            key[:, 1, rows[q, 8], cols[q, 8]] = keys[q, 8]
    stop, _ = emulate_walk(rows, cols, keys, key)
    at = [p for p in (0, 1, 3, 16, 17, 19) if p < cfg.pool_probes]
    for sh in range(S):
        for q in np.flatnonzero(stop[sh] < 0):
            p = at[rng.integers(len(at))]
            if p:
                pool_key[sh, (base[q] + p - 1) % Q] = -1
            for i in (p, p + 1):
                pool_key[sh, (base[q] + i) % Q] = (a["vid"][q], b["vid"][q])


@pytest.mark.parametrize("kw,S", [(SMALL, 2), (WIDE, 3)],
                         ids=["s4-probes4", "s12-probes20"])
def test_walk_and_pool_mirror_match_plain_and_jax(kw, S):
    cfg = LSketchConfig(**kw)
    nv = 60 if kw is SMALL else 40
    jcfg, shards, rng, edges = _jax_state(kw, S, 5, n=400, nv=nv)
    jp = jax.jit(lambda sh: j_build_planes(jcfg, sh, None))(shards)
    key, pool_key, cw, pw, pool_cw, pool_pw = _np(jp)
    src, la, dst, lb, le = _mixed_queries(rng, edges, 128, nv)
    a, b = mirror_precompute(cfg, src, la), mirror_precompute(cfg, dst, lb)
    rows, cols, keys, _ = mirror_probe(cfg, a, b, np.arange(cfg.s)[None])
    lab = mirror_label_bucket(cfg, le)
    base = mirror_pool_base(cfg, a["vid"], b["vid"], cfg.pool_capacity)
    _plant(cfg, rng, key, pool_key, rows, cols, keys, a, b, base)
    pool_cw[:] = rng.integers(1, 1000, pool_cw.shape)
    pool_pw[:] = rng.integers(1, 1000, pool_pw.shape)
    jp = type(jp)(*map(jnp.asarray, (key, cw, pw, pool_key, pool_cw,
                                     pool_pw)))
    tpl = QueryPlanes(*[_t(x) for x in (key, cw, pw, pool_key, pool_cw,
                                        pool_pw)])

    # the contract entry: the walk alone
    want = emulate_contract(rows, cols, keys, lab, key, cw, pw)
    stop, _ = emulate_walk(rows, cols, keys, key)
    assert (stop < 0).any() and (stop >= 0).any()
    if 2 * cfg.s > LANES:  # some walks stop in the second chunk
        assert (stop >= LANES).any()
    got = sketch_query_kernel_sharded(_t(rows), _t(cols), _t(keys), _t(lab),
                                      tpl.key, tpl.cw, tpl.pw)
    for x, y in zip(want, got):
        _eq(x, y)
    assert got[2].dtype == torch.int32
    ref = j_query_kernel(*[jnp.asarray(x, jnp.int32) for x in (
        rows, cols, keys, lab)], jp.key, jp.cw, jp.pw, n_shards=S, d=cfg.d,
        s=cfg.s, c=cfg.c, interpret=True)
    for x, y in zip(ref, want):
        _eq(x, y)

    # the fused entry: addressing, walk and pool
    leaves = [key, pool_key, cw[None], pw[None], pool_cw[None],
              pool_pw[None]]
    w, wl, win = emulate_fused(cfg, leaves, src, la, dst, lb, le)
    pos = (win - base[None]) % cfg.pool_capacity
    assert ((win >= 0) & (pos > 0)).any()  # past an empty slot
    if cfg.pool_probes > LANES:  # and in the second chunk of probes
        assert ((win >= 0) & (pos >= LANES)).any()
    for with_le in (True, False):
        got = edge_query_plain(cfg, tpl, *map(_t, (src, la, dst, lb)),
                               _t(le) if with_le else None)
        _eq(w, got[0])
        _eq(wl if with_le else np.zeros_like(wl), got[1])
        ref = jax.jit(lambda p: j_edge_planes(
            jcfg, p, *[jnp.asarray(x) for x in (src, dst)],
            tuple(jnp.asarray(x) for x in (la, lb, le)), with_le=with_le,
            interpret=False, _kernel_interpret=True))(jp)
        _eq(ref[0], got[0][0])
        _eq(ref[1], got[1][0])


def test_edge_query_plain_on_multi_planes_matches_jax():
    """H = 3 horizon-stacked planes: the plain version and the op against
    the reference's 5-dim branch, and the fused mirror against both."""
    kw, S = WIDE, 2
    cfg = LSketchConfig(**kw)
    jcfg, shards, rng, edges = _jax_state(kw, S, 8, n=500, nv=40,
                                          times=(10, 40, 70, 100, 130, 160))
    hs = (1, 2, 4)
    jm = jax.jit(lambda sh: j_build_multi(jcfg, sh, hs))(shards)
    leaves = _np(jm)
    key, pool_key, cw, pw, pool_cw, pool_pw = leaves
    assert key.shape[0] == 3 and not (cw[0] == cw[2]).all()
    tm = MultiPlanes(*[_t(x) for x in (key, cw, pw, pool_key, pool_cw,
                                       pool_pw)])
    src, la, dst, lb, le = _mixed_queries(rng, edges, 96, 40)
    ones = [jax.jit(lambda sh: j_build_planes(jcfg, sh, h))(shards)
            for h in hs]
    ew, ewl, _ = emulate_fused(cfg, [key[0], pool_key[0], cw, pw, pool_cw,
                                     pool_pw], src, la, dst, lb, le)
    for with_le in (True, False):
        lab = _t(le) if with_le else None
        w, wl = edge_query_plain(cfg, tm, *map(_t, (src, la, dst, lb)), lab)
        assert tuple(w.shape) == (3, S, 96)
        ref = jax.jit(lambda p: j_edge_planes(
            jcfg, p, *[jnp.asarray(x) for x in (src, dst)],
            tuple(jnp.asarray(x) for x in (la, lb, le)), with_le=with_le,
            interpret=False, _kernel_interpret=True))(jm)
        _eq(ref[0], w.sum(1, dtype=torch.int64).to(torch.int32))
        _eq(ref[1], wl.sum(1, dtype=torch.int64).to(torch.int32))
        _eq(ew, w)
        _eq(ewl if with_le else np.zeros_like(ewl), wl)
        op = edge_query_planes(cfg, tm, _t(src), _t(dst),
                               (_t(la), _t(lb), _t(le)), with_le=with_le)
        _eq(ref[0], op[0])
        _eq(ref[1], op[1])
        # each horizon equals the single-horizon planes' answer
        for i, one in enumerate(ones):
            tone = QueryPlanes(*[_t(x) for x in (
                one.key, one.cw, one.pw, one.pool_key, one.pool_cw,
                one.pool_pw)])
            w1, wl1 = edge_query_kernel(cfg, tone, *map(_t, (src, la, dst,
                                                             lb)), lab)
            _eq(w1[0], w[i])
            _eq(wl1[0], wl[i])


def test_list_last_edge_query_equals_its_rows():
    """A horizon sweep of edge queries (one call of the fused entry on the
    card; its plain version here) row for row against single-horizon
    queries, on both paths, padding rows included (B = 40 -> 64)."""
    kw = dict(SMALL, window_size=400)
    cfg = LSketchConfig(**kw)
    rng = np.random.default_rng(12)
    spec = tskt.make_spec("lsketch", n_shards=3, config=cfg)
    st = tskt.create(spec, device="cpu")
    for t in range(10, 500, 60):
        n = 200
        st = tskt.ingest(spec, st, EdgeBatch.from_arrays(
            rng.integers(0, 50, n), rng.integers(0, 50, n),
            rng.integers(0, 3, n), rng.integers(0, 3, n),
            rng.integers(0, 6, n), rng.integers(1, 4, n), np.full(n, t)))
    src, dst = rng.integers(0, 50, 40), rng.integers(0, 50, 40)
    sweep = [None, 1, cfg.k, 2, 1]
    for le in (None, rng.integers(0, 6, 40)):
        q = tskt.QueryBatch.edges(src, src % 3, dst, dst % 3, le,
                                  last=sweep)
        got = tskt.query(spec, st, q, path="cuda")
        assert tuple(got.shape) == (len(sweep), 40)
        for i, h in enumerate(sweep):
            one = tskt.QueryBatch.edges(src, src % 3, dst, dst % 3, le,
                                        last=h)
            _eq(tskt.query(spec, st, one, path="cuda").numpy(), got[i])
            _eq(tskt.query(spec, st, one, path="scan").numpy(), got[i])
        assert bool((got > 0).any())
