"""Each CUDA kernel of the port against its plain PyTorch version, on the
card (exact int32 equality for the sketch kernels; the flash-attention
kernel to a stated float tolerance). Imports neither JAX nor ``repro``, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips (inside the test, never at collection)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import sketch as skt
from repro_torch.core import hashing as th
from repro_torch.core.lsketch import edge_probes, precompute
from repro_torch.core.types import EdgeBatch, LSketchConfig, init_leaves
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.heavy_hitters.kernel import (
    cell_decode_kernel_sharded, cell_decode_plain)
from repro_torch.kernels.sketch_insert.kernel import (
    pool_pass_kernel_sharded, pool_pass_plain, pool_stats_buffer,
    pool_stats_split, sketch_insert_kernel_sharded, sketch_insert_plain)
from repro_torch.kernels.sketch_insert.ops import _bin_plan
from repro_torch.core.queries import MultiPlanes
from repro_torch.kernels.sketch_query.kernel import (
    edge_query_kernel, edge_query_plain, sketch_query_kernel_sharded,
    sketch_query_plain)
from repro_torch.kernels.vertex_scan.kernel import (
    vertex_scan_kernel_sharded, vertex_scan_plain)
from torch_walk_emulation import emulate_pool_rounds

CFG = LSketchConfig(d=32, n_blocks=2, F=256, r=4, s=4, c=4, k=4,
                    window_size=100, pool_capacity=32, pool_probes=4)
# s = 20: 2s = 40 candidates > 32 lanes, the insert kernel's lane-group loop
WIDE = LSketchConfig(d=64, n_blocks=2, F=1024, r=8, s=20, c=4, k=2,
                     window_size=100, pool_capacity=32, pool_probes=4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "-m gpu tests/test_torch_gpu.py")


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _planes(seed=7, S=2):
    """Window-reduced planes of a port-built state (CPU)."""
    rng = np.random.default_rng(seed)
    spec = skt.make_spec("lsketch", n_shards=S, config=CFG)
    st = skt.create(spec, device="cpu")
    for t in (10, 60, 120, 180):
        n = 300
        st = skt.ingest(spec, st, EdgeBatch.from_arrays(
            rng.integers(0, 90, n), rng.integers(0, 90, n),
            rng.integers(0, 3, n), rng.integers(0, 3, n),
            rng.integers(0, 6, n), rng.integers(1, 4, n), np.full(n, t)))
    return skt.query_planes(spec, st), rng


def _insert_args(cfg, rng, S, B, nv=80):
    """One flush's insert-kernel inputs (CPU), binned as the engine bins."""
    src, dst = rng.integers(0, nv, (S, B)), rng.integers(0, nv, (S, B))
    tp = edge_probes(cfg, precompute(cfg, _t(src), _t(src % 3)),
                     precompute(cfg, _t(dst), _t(dst % 3)))
    w = _t(rng.integers(0, 3, (S, B)))
    le = th.edge_label_bucket(_t(rng.integers(0, 9, (S, B))), cfg.c,
                              cfg.seed)
    slot = _t(rng.integers(0, cfg.k, S))
    _, _, order, counts, offs = _bin_plan(cfg, tp, w)
    return (tp.rows.contiguous(), tp.cols.contiguous(), tp.keys.contiguous(),
            w, le, slot, order, offs, counts)


def _insert_both(args, ref, st, max_bin):
    """The plain version on ``ref`` (CPU) and the kernel on ``st`` (card),
    compared exactly."""
    ins_ref = sketch_insert_plain(*args, ref.key, ref.C, ref.P, max_bin)
    before = sketch_insert_kernel_sharded.launches
    ins = sketch_insert_kernel_sharded(*[a.cuda() for a in args], st.key,
                                       st.C, st.P, max_bin)
    torch.cuda.synchronize()
    assert sketch_insert_kernel_sharded.launches == before + 1
    assert torch.equal(ins.cpu(), ins_ref)
    for a, b in zip((ref.key, ref.C, ref.P), (st.key, st.C, st.P)):
        assert torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [CFG, WIDE], ids=["s4", "s20"])
def test_cuda_insert_kernel_matches_plain(cfg):
    """Fresh states, then several flushes into one state (the walk's
    pre-flush gather matters only on a loaded state), with and without
    max_bin truncation."""
    _need_card()
    rng = np.random.default_rng(3)
    S, B = 3, 512
    args = _insert_args(cfg, rng, S, B)
    for max_bin in (B, 5):
        _insert_both(args, init_leaves(cfg, (S,), "cpu"),
                     init_leaves(cfg, (S,), "cuda"), max_bin)
    for max_bin in (B, 7):
        ref, st = init_leaves(cfg, (S,), "cpu"), init_leaves(cfg, (S,),
                                                             "cuda")
        for nv in (80, 300, 80, 20, 300):
            _insert_both(_insert_args(cfg, rng, S, B, nv), ref, st, max_bin)
        assert int((ref.key != -1).sum()) > 0


def _pool_case(rng, S, B, Q, probes, nv, rates, k=4, c=3):
    """Pool-pass inputs [S, B] (separate w_count and w_key, zero weights,
    per-item ring slots) and a pre-loaded pool, all on the CPU; the pool
    probe sequences of probes slots from seed 1234."""
    pid_s, pid_d = (_t(rng.integers(0, nv, (S, B))) for _ in range(2))
    w_count = _t(rng.integers(0, 4, (S, B)))
    w_key = torch.where(_t(rng.random((S, B)) < 0.2) > 0, 0, w_count)
    elig = _t(rng.random((S, B)) < np.asarray(rates)[:, None])
    sl, le = _t(rng.integers(0, k, (S, B))), _t(rng.integers(0, c, (S, B)))
    pool_key = _t(rng.integers(0, nv, (S, Q, 2)))
    pool_key[_t(rng.random((S, Q)) < 0.6) > 0] = -1
    pool = [pool_key, _t(rng.integers(0, 5, (S, Q, k))),
            _t(rng.integers(0, 5, (S, Q, k, c))), _t(rng.integers(0, 3, S))]
    return (pid_s, pid_d, w_count, w_key, sl, le, elig), pool


# (S, B, Q, probes, pid values, eligible share per shard): uneven shards
# (one with nothing eligible), repeated pairs, a saturated pool, more
# probes than lanes, and a pool plane too large for shared memory
POOL_GPU_CASES = {
    "uneven": (3, 700, 64, 4, 40, (0.5, 0.05, 0.0)),
    "repeated-pairs": (2, 500, 32, 4, 5, (0.7, 0.4)),
    "saturated": (2, 400, 8, 2, 60, (0.8, 0.6)),
    "probes-40": (2, 300, 128, 40, 200, (0.9, 0.5)),
    "deployment-width": (4, 3000, 16384, 16, 5000, (0.1, 0.2, 0.0, 0.3)),
    "plane-in-global": (2, 3000, 65536, 16, 5000, (0.3, 0.1)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(POOL_GPU_CASES))
def test_cuda_pool_pass_matches_plain(case):
    _need_card()
    S, B, Q, probes, nv, rates = POOL_GPU_CASES[case]
    rng = np.random.default_rng(len(case))
    items, pool = _pool_case(rng, S, B, Q, probes, nv, rates)
    want = [x.clone() for x in pool]
    kw = dict(probes=probes, seed=1234)
    pool_pass_plain(*items, *want, **kw)
    got = [x.cuda() for x in pool]
    before = pool_pass_kernel_sharded.launches
    pool_pass_kernel_sharded(*[x.cuda() for x in items], *got, **kw)
    torch.cuda.synchronize()
    assert pool_pass_kernel_sharded.launches == before + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    assert not torch.equal(want[0], pool[0])
    if case == "saturated":
        assert bool((want[3] > pool[3]).any())


@pytest.mark.gpu
def test_cuda_pool_pass_probe_cluster_counts_rounds():
    """A nearly full shard (80 % of its slots taken and one run of 1,500
    taken slots, so items walk long probe clusters, converge on the free
    slot after one and some are lost) beside a sparse one, fed skewed
    pairs that repeat: the kernel equals the plain pass, and its stats
    buffer counts the rounds, the voided rounds and the same-pair lanes
    that the emulated walk counts."""
    _need_card()
    S, B, Q, probes = 2, 4000, 4096, 16
    rng = np.random.default_rng(21)
    pool_key = np.full((S, Q, 2), -1, np.int64)
    taken = rng.random((S, Q)) < np.array([0.3, 0.8])[:, None]
    taken[1, 1000:2500] = True
    pool_key[taken] = rng.integers(10 ** 5, 2 * 10 ** 5, (int(taken.sum()), 2))
    pid_s = rng.zipf(1.3, (S, B)) % 150
    pid_d = (pid_s * 7 + rng.integers(0, 3, (S, B))) % 500
    w_count = rng.integers(0, 4, (S, B))
    w_key = np.where(rng.random((S, B)) < 0.1, 0, w_count)
    elig = (rng.random((S, B)) < 0.5).astype(np.int64)
    sl, le = rng.integers(0, 4, (S, B)), rng.integers(0, 3, (S, B))
    pool = [pool_key, rng.integers(0, 5, (S, Q, 4)),
            rng.integers(0, 5, (S, Q, 4, 3)), rng.integers(0, 3, S)]
    pool = [x.astype(np.int32) for x in pool]
    items = [x.astype(np.int32) for x in (pid_s, pid_d, w_count, w_key, sl,
                                           le, elig)]
    kw = dict(probes=probes, seed=1234)
    want = [_t(x) for x in pool]
    pool_pass_plain(*map(_t, items), *want, **kw)
    emu = [x.copy() for x in pool]
    emu_stats = emulate_pool_rounds(*items, *emu, **kw)
    for a, b in zip(emu, want):
        np.testing.assert_array_equal(a, b.numpy())
    got = [_t(x).cuda() for x in pool]
    stats = pool_stats_buffer(S, "cuda")
    pool_pass_kernel_sharded(*[_t(x).cuda() for x in items], *got, **kw,
                             stats=stats)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    split = pool_stats_split(stats.cpu())
    for name in ("rounds", "voided_same_pair", "voided_other",
                 "merged_same_pair"):
        assert split[name] == emu_stats[name], name
    assert split["items"] == elig.sum(1).tolist()
    assert split["merged_same_pair"][1] > 0
    assert sum(split["voided_other"]) > 0
    assert split["voided_same_pair"] == [0, 0]
    assert bool((want[3] > _t(pool[3])).any())  # the full shard lost some
    for name in ("compaction_ns", "stage_ns", "walk_ns", "writeback_ns"):
        assert min(split[name]) >= 0, name


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["one-label-block", "hub-line",
                                    "ragged-d"])
@pytest.mark.parametrize("direction", ["out", "in"])
def test_cuda_vertex_scan_at_deployment_width(direction, layout):
    """d = 2048 (the deployment's width): every query's lines inside one
    512-line label block, or besides that one line named by all 3,000
    queries (more references than one shared-memory chunk, on one line
    and in one column tile); and d = 1,000 with F = 48 (a last column
    tile of 8 columns; F not a power of two). Packed keys with small
    fingerprints, so queries match often; sums wrap."""
    _need_card()
    S, d, r, F, c = 2, 2048, 8, 64, 4
    if layout == "ragged-d":
        d, F = 1000, 48
    g = torch.Generator(device="cuda").manual_seed(5)

    def ri(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    shape = (S, 2, d, d)
    key = th.pack_key(ri(r, shape), ri(r, shape), ri(F, shape),
                      ri(F, shape), F).to(torch.int32)
    key = torch.where(ri(4, shape) == 0, key, -1).contiguous()
    cw, pw = ri(1 << 30, shape), ri(1 << 30, shape + (c,))
    nq = 3000 if layout == "hub-line" else 1024
    lines = (ri(d, (nq, r)) if layout == "ragged-d"
             else 512 + ri(512, (nq, r))).contiguous()
    if layout == "hub-line":
        lines[:, 3] = 700
    f, le = ri(F, (nq,)), ri(c, (nq,))
    kw = dict(r=r, F=F, direction=direction)
    for lab in (None, le):
        want = vertex_scan_plain(lines, f, lab, key, cw, pw, **kw)
        before = vertex_scan_kernel_sharded.launches
        got = vertex_scan_kernel_sharded(lines, f, lab, key, cw, pw, **kw)
        torch.cuda.synchronize()
        assert vertex_scan_kernel_sharded.launches == before + 1
        for a, b in zip(want, got):
            assert torch.equal(a, b)
        assert bool((want[0] != 0).any())


@pytest.mark.gpu
def test_cuda_edge_query_kernel_matches_plain():
    _need_card()
    planes, rng = _planes()
    nq, s = 300, CFG.s
    rows = _t(rng.integers(0, CFG.d, (nq, s)))
    cols = _t(rng.integers(0, CFG.d, (nq, s)))
    keys = planes.key[0, 0, rows.long(), cols.long()].contiguous()
    keys[::3] += 1  # some mismatches, some walks to the pool
    le = _t(rng.integers(0, CFG.c, nq))
    g = lambda x: None if x is None else x.cuda()
    pl = (planes.key, planes.cw, planes.pw)
    for lab in (None, le):
        ref = sketch_query_plain(rows, cols, keys, lab, *pl)
        got = sketch_query_kernel_sharded(g(rows), g(cols), g(keys), g(lab),
                                          *map(g, pl))
        torch.cuda.synchronize()
        for a, b in zip(ref, got):
            assert torch.equal(a, b.cpu())


# the deployment's width (d=2048, 4 label blocks, F=1024, r=s=8, pool
# 16,384 x 16 probes) with fewer counters, so a few shards stay small
D2048 = LSketchConfig(d=2048, n_blocks=4, F=1024, r=8, s=8, c=4, k=2,
                      window_size=200, pool_capacity=16384, pool_probes=16)


def _edge_planes(size):
    """(config, planes on the card, raw queries on the card, the rows
    whose walks were forced to the pool): a port-built state with a third
    of the query rows' candidate cells overwritten by other keys and their
    pool pair planted at a probe in {0, 5, 15} (the last probe where the
    config has fewer; past an EMPTY slot; later plants may overwrite
    earlier ones), and EMPTY padding rows at the end."""
    if size == "small":
        cfg, (planes, rng) = CFG, _planes(21)
        planes = dataclasses.replace(planes, **{
            f.name: getattr(planes, f.name).cuda()
            for f in dataclasses.fields(planes)})
        nv = 90
    else:
        cfg, rng, nv = D2048, np.random.default_rng(22), 50_000
        spec = skt.make_spec("lsketch", n_shards=2, config=cfg)
        st = skt.create(spec, device="cuda")
        for t in (10, 80, 150):
            n = 20_000
            st = skt.ingest(spec, st, EdgeBatch.from_arrays(
                rng.integers(0, nv, n), rng.integers(0, nv, n),
                rng.integers(0, 3, n), rng.integers(0, 3, n),
                rng.integers(0, 6, n), rng.integers(1, 4, n),
                np.full(n, t)), path="cuda")
        planes = skt.query_planes(spec, st)
    nq = 300
    q = [rng.integers(0, hi, nq) for hi in (nv, 3, nv, 3, 6)]
    for x in q:
        x[-20:] = -1  # padding rows
    q = [_t(x).cuda() for x in q]
    pr = edge_probes(cfg, precompute(cfg, q[0], q[1]),
                     precompute(cfg, q[2], q[3]))
    forced = torch.arange(0, nq - 20, 3, device="cuda")
    key, pool_key = planes.key.clone(), planes.pool_key.clone()
    for tz in range(2):
        cells = (slice(None), tz, pr.rows[forced].long(),
                 pr.cols[forced].long())
        key[cells] = torch.where(pr.keys[forced] + 1 == -1, 7,
                                 pr.keys[forced] + 1)
    ps = th.pool_slot_seq(pr.pid_src, pr.pid_dst, cfg.pool_capacity,
                          cfg.pool_probes, cfg.seed).long()
    at = torch.tensor([p for p in (0, 5, 15) if p < cfg.pool_probes] or
                      [0, cfg.pool_probes - 1], device="cuda")
    at = at[forced % len(at)]
    pool_key[:, ps[forced, (at - 1).clamp_min(0)]] = -1
    pool_key[:, ps[forced, at], 0] = pr.pid_src[forced]
    pool_key[:, ps[forced, at], 1] = pr.pid_dst[forced]
    gen = torch.Generator(device="cuda").manual_seed(5)
    pool_cw = torch.randint(1, 1000, planes.pool_cw.shape, device="cuda",
                            dtype=torch.int32, generator=gen)
    pool_pw = torch.randint(1, 1000, planes.pool_pw.shape, device="cuda",
                            dtype=torch.int32, generator=gen)
    planes = dataclasses.replace(planes, key=key, pool_key=pool_key,
                                 pool_cw=pool_cw, pool_pw=pool_pw)
    return cfg, planes, q, forced


def _stack3(planes):
    """Three horizons of ``planes``: key and pool_key broadcast (views),
    the counters made to differ per horizon."""
    lead = lambda x: x.expand((3,) + x.shape)  # noqa: E731
    three = lambda x: torch.stack([x, 2 * x + 1, x + 3])  # noqa: E731
    return MultiPlanes(key=lead(planes.key), cw=three(planes.cw),
                       pw=three(planes.pw), pool_key=lead(planes.pool_key),
                       pool_cw=three(planes.pool_cw),
                       pool_pw=three(planes.pool_pw))


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["small", "d2048"])
def test_cuda_edge_query_entries_match_plain(size):
    """Both entries of the edge-probe kernel against their plain versions
    on the card: the fused one (addressing, walk, pool) at H = 1 and 3 and
    the contract one, with and without the label, with pool-resolved
    walks and padding rows; one launch each."""
    _need_card()
    cfg, planes, q, forced = _edge_planes(size)
    for pl in (planes, _stack3(planes)):
        for le in (q[4], None):
            before = sketch_query_kernel_sharded.launches
            got = edge_query_kernel(cfg, pl, *q[:4], le)
            torch.cuda.synchronize()
            assert sketch_query_kernel_sharded.launches == before + 1
            want = edge_query_plain(cfg, pl, *q[:4], le)
            H = pl.cw.shape[0] if pl.cw.dim() == 5 else 1
            assert got[0].shape == (H, planes.key.shape[0], len(q[0]))
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            # forced walks found their planted pool pair
            assert bool((got[0][:, :, forced] > 0).any())
    pr = edge_probes(cfg, precompute(cfg, q[0], q[1]),
                     precompute(cfg, q[2], q[3]))
    le_idx = th.edge_label_bucket(q[4], cfg.c, cfg.seed)
    for le in (le_idx, None):
        args = (pr.rows.contiguous(), pr.cols.contiguous(),
                pr.keys.contiguous(), le, planes.key, planes.cw, planes.pw)
        got = sketch_query_kernel_sharded(*args)
        want = sketch_query_plain(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert bool(got[2][:, forced].all())


@pytest.mark.gpu
def test_cuda_edge_query_raises_on_what_it_does_not_take():
    """A wrong dtype, device, shape or layout raises and launches
    nothing."""
    _need_card()
    cfg, planes, q, _ = _edge_planes("small")
    before = sketch_query_kernel_sharded.launches
    src = q[0]
    for bad in (src.long(), src.cpu(), src[:-1], q[0].repeat(2)[::2]):
        with pytest.raises(ValueError):
            edge_query_kernel(cfg, planes, bad, *q[1:4], q[4])
    with pytest.raises(ValueError):
        edge_query_kernel(cfg, dataclasses.replace(
            planes, cw=planes.cw.float()), *q[:4], q[4])
    rows = torch.zeros((4, cfg.s), dtype=torch.int32, device="cuda")
    for bad in (rows.long(), rows.cpu(), rows.t()):
        with pytest.raises(ValueError):
            sketch_query_kernel_sharded(bad, rows, rows, None, planes.key,
                                        planes.cw, planes.pw)
    assert sketch_query_kernel_sharded.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["out", "in"])
def test_cuda_vertex_scan_kernel_matches_plain(direction):
    _need_card()
    planes, rng = _planes(9)
    nq = 200
    lines = _t(rng.integers(0, CFG.d, (nq, CFG.r)))
    f = _t(rng.integers(0, CFG.F, nq))
    le = _t(rng.integers(0, CFG.c, nq))
    neg = planes.key.clone()  # negative non-EMPTY keys: floor decode
    neg[..., ::5] = -_t(rng.integers(2, 3000, neg[..., ::5].shape))
    g = lambda x: None if x is None else x.cuda()
    for kp in (planes.key, neg):
        for lab in (None, le):
            kw = dict(r=CFG.r, F=CFG.F, direction=direction)
            ref = vertex_scan_plain(lines, f, lab, kp, planes.cw, planes.pw,
                                    **kw)
            got = vertex_scan_kernel_sharded(g(lines), g(f), g(lab), g(kp),
                                             g(planes.cw), g(planes.pw), **kw)
            torch.cuda.synchronize()
            for a, b in zip(ref, got):
                assert torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("d,bounds", [
    (32, ((0, 8), (8, 8), (16, 8), (24, 8))),
    (300, ((0, 100), (100, 77), (177, 123)))], ids=["uniform", "skewed"])
def test_cuda_cell_decode_kernel_matches_plain(d, bounds):
    """Random keys: packed ones, EMPTY and negative non-EMPTY values (the
    floor decode), at a width below and above one 256-thread block."""
    _need_card()
    rng = np.random.default_rng(13)
    r, F, shape = 8, 1024, (2, 2, d, d)
    key = th.pack_key(*[_t(rng.integers(0, hi, shape))
                        for hi in (r, r, F, F)], F)
    key = torch.where(_t(rng.random(shape) < 0.3) > 0, -1, key)
    key[..., ::7] = -_t(rng.integers(2, 3000, key[..., ::7].shape))
    kw = dict(starts=tuple(s for s, _ in bounds),
              widths=tuple(w for _, w in bounds), r=r, F=F)
    ref = cell_decode_plain(key, **kw)
    before = cell_decode_kernel_sharded.launches
    got = cell_decode_kernel_sharded(key.cuda(), **kw)
    torch.cuda.synchronize()
    assert cell_decode_kernel_sharded.launches == before + 1
    for a, b in zip(ref, got):
        assert torch.equal(a, b.cpu())


@pytest.mark.gpu
def test_cuda_end_to_end_equals_cpu():
    """The whole port on the card (kernel route, both query paths, the
    analytics and horizon sweeps) equals the same stream through the plain
    versions on the CPU."""
    _need_card()
    rng = np.random.default_rng(11)
    n = 3000
    b = EdgeBatch.from_arrays(
        rng.integers(0, 300, n), rng.integers(0, 300, n),
        rng.integers(0, 3, n), rng.integers(0, 3, n), rng.integers(0, 6, n),
        rng.integers(1, 4, n), np.sort(rng.integers(0, 300, n)))
    spec = skt.make_spec("lsketch", n_shards=4, config=CFG)
    out = {}
    for dev in ("cpu", "cuda"):
        st = skt.create(spec, device=dev)
        for a in range(0, n, 700):
            st = skt.ingest(spec, st, b.slice(a, a + 700), path="cuda")
        qs = [skt.QueryBatch.edges(b.src[:99], b.src_label[:99], b.dst[:99],
                                   b.dst_label[:99], b.edge_label[:99]),
              skt.QueryBatch.vertices(b.src[:50], b.src_label[:50],
                                      direction="in", last=2),
              skt.QueryBatch.labels(np.arange(3), np.arange(3), last=1)]
        out[dev] = list(skt.to_numpy(st)) + [
            skt.query(spec, st, q, path=p).cpu().numpy()
            for q in qs for p in ("scan", "cuda")] + [
            x.cpu().numpy() for p in ("scan", "cuda") for x in (
                *skt.heavy_vertices(spec, st, 8, direction="in", path=p),
                *skt.heavy_edges(spec, st, 8, horizons=[None, 1], path=p),
                *skt.top_labels(spec, st, 2, last=2, path=p))] + [
            skt.query(spec, st, dataclasses.replace(q, last=[None, 1, 2]),
                      path="cuda").cpu().numpy() for q in qs] + [
            skt.reachable_many(spec, st, b.src[:20], b.src_label[:20],
                               b.dst[20:40], b.dst_label[20:40],
                               max_hops=2, horizons=[None, 1])]
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# flash attention: (B, Hq, Hkv, L, dh, dtype) — Qwen3-8B's and SmolLM-135M's
# prefill attention, a ragged length, bf16, the other head dims, lengths
# that cross the kernel's 16-row fragment and 64-row tile edges (1, 15, 65,
# 129) in both types, bf16 at dh 64, and MHA (Hq == Hkv)
FLASH_SHAPES = [
    (1, 32, 8, 8192, 128, torch.float32),
    (4, 9, 3, 2048, 64, torch.float32),
    (2, 32, 8, 1000, 128, torch.float32),
    (2, 32, 8, 2048, 128, torch.bfloat16),
    (3, 4, 1, 77, 16, torch.float32),
    (1, 6, 2, 130, 32, torch.bfloat16),
    (1, 8, 2, 1, 128, torch.float32),
    (1, 8, 2, 1, 128, torch.bfloat16),
    (2, 4, 2, 15, 64, torch.float32),
    (2, 4, 2, 15, 32, torch.bfloat16),
    (1, 8, 2, 65, 128, torch.float32),
    (1, 8, 2, 65, 128, torch.bfloat16),
    (2, 4, 1, 129, 16, torch.float32),
    (2, 4, 1, 129, 128, torch.bfloat16),
    (2, 16, 4, 1024, 64, torch.bfloat16),
    (2, 8, 8, 300, 128, torch.float32),
    (1, 12, 12, 257, 64, torch.bfloat16),
]
FLASH_IDS = ["qwen3-8k", "smollm-2k", "ragged-1000", "bf16", "dh16", "dh32",
             "L1", "L1-bf16", "L15", "L15-bf16", "L65", "L65-bf16", "L129",
             "L129-bf16", "bf16-dh64", "mha", "mha-bf16"]
# every shape causal; the shapes of at most 2,048 rows also non-causal
FLASH_CASES = [pytest.param(*s, True, id=f"{i}-causal")
               for s, i in zip(FLASH_SHAPES, FLASH_IDS)] + [
    pytest.param(*s, False, id=f"{i}-full")
    for s, i in zip(FLASH_SHAPES, FLASH_IDS) if s[3] <= 2048]


def flash_close(got, want):
    """f32: |got - want| < 2e-5 (the same f32 sums in another order move an
    output ~1e-6); bf16: within one bf16 rounding of the output,
    |got - want| <= 2**-7 max(|want|, 1)."""
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        return bool((d <= 2.0 ** -7 * want.float().abs().clamp_min(1)).all())
    return float(d.max()) < 2e-5


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,L,dh,dtype,causal", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(no_tf32, B, Hq, Hkv, L, dh, dtype,
                                            causal):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(L + dh)
    q, k, v = [torch.randn(s, generator=g, device="cuda").to(dtype)
               for s in ((B, Hq, L, dh), (B, Hkv, L, dh), (B, Hkv, L, dh))]
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal)
    want = flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert flash_close(got, want)


@pytest.mark.gpu
def test_cuda_flash_attention_raises_on_what_it_does_not_take():
    _need_card()
    q = torch.zeros(1, 4, 64, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention_kernel(q, q[:, :2], q[:, :2])
    q = torch.zeros(1, 4, 64, 32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_kernel(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="bad shapes"):
        flash_attention_kernel(q, q[:, :3], q[:, :3])
    q = torch.zeros(4 * 64 * 32 + 1, device="cuda")[1:].view(1, 4, 64, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_kernel(q, q, q)


@pytest.mark.gpu
def test_cuda_prefill_and_decode_match_the_cpu(no_tf32):
    """The reduced Qwen3 forward with the kernel on the card against the
    plain version on the CPU, and the card's decode against its prefill."""
    _need_card()
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get("qwen3-8b", reduced=True)
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 96)).astype(np.int32))
    before = flash_attention_kernel.launches
    got = lm.forward(cfg, params, {"tokens": toks.cuda()})
    assert flash_attention_kernel.launches == before + cfg.n_layers
    params_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    params_cpu.load_state_dict({n: t.cpu() for n, t in
                                params.state_dict().items()})
    want = lm.forward(cfg, params_cpu, {"tokens": toks})
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) / scale < 1e-5
    caches = lm.init_cache(cfg, 2, 96)
    steps = [lm.serve_step(cfg, params, caches, toks[:, i:i + 1].cuda())[0]
             for i in range(96)]
    dec = torch.cat(steps, 1).cpu()
    assert float((dec - got.cpu()).abs().max()) / scale < 1e-5


# --------------------------------------------------------------------------
# the object API at one shard: the single-sketch entries of the insert,
# probe and scan kernels, GSS's one-block single-bin flush, LGS
# --------------------------------------------------------------------------

OBJ_CFG = LSketchConfig(d=64, n_blocks=2, F=1024, r=8, s=8, c=16, k=8,
                        window_size=1440, pool_capacity=64, pool_probes=8)


def _object_stream(n=6000, seed=21):
    rng = np.random.default_rng(seed)
    return EdgeBatch.from_arrays(
        rng.integers(0, 400, n), rng.integers(0, 400, n),
        rng.integers(0, 4, n), rng.integers(0, 4, n), rng.integers(0, 9, n),
        rng.integers(1, 4, n), np.sort(rng.integers(0, 2880, n)))


def _cols(b):
    return [getattr(b, f) for f in ("src", "dst", "src_label", "dst_label",
                                    "edge_label", "weight", "time")]


@pytest.mark.gpu
def test_cuda_lsketch_object_matches_plain():
    """``LSketch.insert`` on the card (the insert and pool kernels at S = 1
    for batches cut at subwindow boundaries, the scan for a spanning one)
    against the same object on the CPU (plain versions), leaf for leaf;
    then its batched, scalar and drop-in queries, equal on both."""
    _need_card()
    from repro_torch.core import LSketch
    from repro_torch.kernels.sketch_insert.ops import \
        insert_window_batch_pallas
    from repro_torch.kernels.sketch_query.ops import edge_query_pallas
    from repro_torch.kernels.vertex_scan.ops import vertex_query_pallas

    b = _object_stream()
    widx = b.time // OBJ_CFG.subwindow_size
    cuts = [0] + (np.flatnonzero(np.diff(widx)) + 1).tolist()[:-1]
    cuts = sorted(set(cuts + [cuts[-1] + 5, len(b)]))  # the last spans
    objs = {dev: LSketch(OBJ_CFG, insert_path="cuda", query_path="cuda",
                         device=dev) for dev in ("cpu", "cuda")}
    before = sketch_insert_kernel_sharded.launches
    for a, z in zip(cuts[:-1], cuts[1:]):
        for o in objs.values():
            o.insert(*[x[a:z] for x in _cols(b)])
        for x, y in zip(skt.to_numpy(objs["cpu"].state),
                        skt.to_numpy(objs["cuda"].state)):
            np.testing.assert_array_equal(x, y)
    assert sketch_insert_kernel_sharded.launches - before == len(cuts) - 2
    i = np.arange(0, len(b), 97)
    e = (b.src[i], b.src_label[i], b.dst[i], b.dst_label[i])
    lab = (e[1], e[3], b.edge_label[i])
    out = {}
    for dev, o in objs.items():
        out[dev] = [o.edge_weight(*e, le=b.edge_label[i], last=2),
                    o.vertex_weight(e[0], e[1], direction="in"),
                    o.label_aggregate(np.arange(4), last=1),
                    np.array([o.edge_weight(int(e[0][0]), int(e[1][0]),
                                            int(e[2][0]), int(e[3][0]))]),
                    *[x.cpu().numpy() for x in edge_query_pallas(
                        OBJ_CFG, o.state, e[0], e[2], lab, 3)],
                    *[x.cpu().numpy() for x in vertex_query_pallas(
                        OBJ_CFG, o.state, e[0], (e[1], lab[2]), "out")]]
        st = insert_window_batch_pallas(
            OBJ_CFG, o.state, b.slice(0, 500), int(widx[-1]))
        out[dev] += skt.to_numpy(st)
    for x, y in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def gss_spill():
    """GSS at d = 2048 (one label block, c = 1, k = 1) on the card and on
    the CPU, fed one flush whose single bin holds more than 2^13 new
    claims: the insert kernel's claim table overflows into the key plane."""
    _need_card()
    from repro_torch.core import GSS, gss_config

    cfg = gss_config(d=2048, pool_capacity=4096)
    rng = np.random.default_rng(5)
    n = 12_000
    src, dst = rng.integers(0, 1 << 24, n), rng.integers(0, 1 << 24, n)
    dup = rng.random(n) < 0.2  # repeats inside the flush: matches
    src[dup], dst[dup] = src[:dup.sum()], dst[:dup.sum()]
    objs = {}
    for dev in ("cpu", "cuda"):
        objs[dev] = GSS(cfg, device=dev)
        objs[dev].insert_path = objs[dev].query_path = "cuda"
    before = sketch_insert_kernel_sharded.launches
    for o in objs.values():
        o.insert(src, dst, weight=np.full(n, 2))
    assert sketch_insert_kernel_sharded.launches == before + 1
    return cfg, objs, src, dst


@pytest.mark.gpu
def test_cuda_gss_single_bin_spill_matches_plain(gss_spill):
    cfg, objs, src, dst = gss_spill
    assert int((objs["cpu"].state.key != -1).sum()) > 1 << 13
    for x, y in zip(skt.to_numpy(objs["cpu"].state),
                    skt.to_numpy(objs["cuda"].state)):
        np.testing.assert_array_equal(x, y)
    for direction in ("out", "in"):
        a = objs["cpu"].vertex_weight(src[:300], 0, direction=direction)
        b = objs["cuda"].vertex_weight(src[:300], 0, direction=direction)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(objs["cpu"].edge_weight(src, 0, dst, 0),
                                  objs["cuda"].edge_weight(src, 0, dst, 0))


@pytest.mark.gpu
def test_cuda_one_block_kernels_match_plain(gss_spill):
    """The edge probe (both entries), the vertex scan (both directions) and
    the cell decode at n_blocks = 1, c = 1, b = d = 2048, on the spilled
    GSS planes, against their plain versions."""
    cfg, objs, src, dst = gss_spill
    spec, handle = objs["cuda"].spec, objs["cuda"].handle
    planes = skt.query_planes(spec, handle)
    assert planes.cw.shape == (1, 2, 2048, 2048) and cfg.b == 2048
    t = lambda x: _t(x).cuda()  # noqa: E731
    z = torch.zeros(len(src), dtype=torch.int32, device="cuda")
    got = edge_query_kernel(cfg, planes, t(src), z, t(dst), z, None)
    want = edge_query_plain(cfg, planes, t(src), z, t(dst), z, None)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    pr = edge_probes(cfg, precompute(cfg, t(src), z), precompute(cfg, t(dst),
                                                               z))
    args = (pr.rows.contiguous(), pr.cols.contiguous(), pr.keys.contiguous(),
            None, planes.key, planes.cw, planes.pw)
    for a, b in zip(sketch_query_kernel_sharded(*args),
                    sketch_query_plain(*args)):
        assert torch.equal(a, b)
    from repro_torch.kernels.vertex_scan.ops import scan_lines
    pre, lines = scan_lines(cfg, t(src[:2000]), z[:2000])
    for direction in ("out", "in"):
        kw = dict(r=cfg.r, F=cfg.F, direction=direction)
        a = vertex_scan_kernel_sharded(lines, pre.f.contiguous(), None,
                                       planes.key, planes.cw, planes.pw,
                                       **kw)
        b = vertex_scan_plain(lines, pre.f.contiguous(), None, planes.key,
                              planes.cw, planes.pw, **kw)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    kw = dict(starts=(0,), widths=(2048,), r=cfg.r, F=cfg.F)
    for a, b in zip(cell_decode_kernel_sharded(planes.key, **kw),
                    cell_decode_plain(planes.key, **kw)):
        assert torch.equal(a, b)
    for path in ("cuda", "scan"):
        top = skt.heavy_edges(spec, handle, 16, path=path)
        assert [x.cpu().tolist() for x in top] == [
            x.tolist() for x in skt.heavy_edges(
                spec, objs["cpu"].handle, 16, path="scan")]


@pytest.mark.gpu
def test_cuda_lgs_handle_matches_cpu_replay():
    """The ``lgs`` kind at 4 shards on the card (count-min scatter-adds)
    against the same flushes on the CPU, leaf for leaf, and its queries."""
    _need_card()
    from repro_torch.core import LGS

    b = _object_stream(n=5000, seed=8)
    spec = skt.make_spec("lgs", n_shards=4, d=128, copies=6, c=16, k=8,
                         window_size=1440)
    out = {}
    for dev in ("cpu", "cuda"):
        st = skt.create(spec, device=dev)
        for a in range(0, len(b), 1300):
            st = skt.ingest(spec, st, b.slice(a, a + 1300))
        i = np.arange(0, len(b), 31)
        out[dev] = skt.to_numpy(st) + [
            skt.query(spec, st, skt.QueryBatch.edges(
                b.src[i], b.src_label[i], b.dst[i], b.dst_label[i],
                b.edge_label[i], last=[None, 2])).cpu().numpy(),
            skt.query(spec, st, skt.QueryBatch.vertices(
                b.src[i], b.src_label[i], direction="in")).cpu().numpy()]
        obj = LGS(spec.config, device=dev).insert(*_cols(b))
        out[dev] += skt.to_numpy(obj.state) + [
            obj.vertex_weight(b.src[i], b.src_label[i], le=b.edge_label[i])]
    for x, y in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(x, y)
