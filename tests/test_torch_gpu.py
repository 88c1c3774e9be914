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
    HEAD_DIMS, flash_attention_backward_kernel, flash_attention_backward_plain,
    flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.heavy_hitters.kernel import (
    cell_decode_kernel_sharded, cell_decode_plain)
from repro_torch.kernels.sketch_insert.kernel import (
    pool_pass_kernel_sharded, pool_pass_plain, pool_stats_buffer,
    pool_stats_split, sketch_insert_kernel_sharded, sketch_insert_plain)
from repro_torch.kernels.sketch_insert.ops import _bin_plan
from repro_torch.configs import ARCHS
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
# 129) in both types, bf16 at dh 64, MHA (Hq == Hkv), and Gemma-3's dh=256
# (the warp-pair instances) and phi-3-vision's dh=96 in both types
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
    (1, 8, 4, 2048, 256, torch.float32),
    (1, 8, 4, 2048, 256, torch.bfloat16),
    (1, 32, 32, 1000, 96, torch.float32),
    (1, 32, 32, 1000, 96, torch.bfloat16),
    (2, 4, 2, 65, 256, torch.float32),
    (2, 4, 4, 129, 96, torch.bfloat16),
]
FLASH_IDS = ["qwen3-8k", "smollm-2k", "ragged-1000", "bf16", "dh16", "dh32",
             "L1", "L1-bf16", "L15", "L15-bf16", "L65", "L65-bf16", "L129",
             "L129-bf16", "bf16-dh64", "mha", "mha-bf16", "gemma-dh256",
             "gemma-dh256-bf16", "phi3-dh96", "phi3-dh96-bf16", "L65-dh256",
             "L129-dh96-bf16"]
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


# the query offset (the "sp" fallback's blocks of rows of a longer
# sequence): the local-head shape of a split layer (Hq 3 over Hkv 1) at dh
# 16, 64 and 128, a block of L/4 rows at offsets 0, L/2 and 3L/4 (and the
# last rows) against all L keys, both types
FLASH_OFFSET_SHAPES = [(2, 3, 1, 2048, 64), (1, 3, 1, 520, 16),
                       (1, 3, 1, 1000, 128)]
FLASH_OFFSET_CASES = [
    pytest.param(shape, dt, off, id=f"dh{shape[4]}-L{shape[3]}-off{off}-"
                 f"{str(dt)[6:]}")
    for shape in FLASH_OFFSET_SHAPES
    for off in (0, shape[3] // 2, 3 * shape[3] // 4,
                shape[3] - shape[3] // 4)
    for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,off", FLASH_OFFSET_CASES)
def test_cuda_flash_offset_matches_plain(no_tf32, shape, dtype, off):
    """Forward (out and lse) and the backward pair at ``q_offset`` against
    the plain versions at the same offset, the forward's and backward's
    tolerances above."""
    _need_card()
    B, Hq, Hkv, L, dh = shape
    n = L // 4
    g = torch.Generator(device="cuda").manual_seed(L + dh + off)
    q, k, v, do = [torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((B, Hq, n, dh), (B, Hkv, L, dh),
                             (B, Hkv, L, dh), (B, Hq, n, dh))]
    before = (flash_attention_kernel.launches,
              flash_attention_backward_kernel.launches)
    out, lse = flash_attention_kernel(q, k, v, True, lse=True, q_offset=off)
    want, lse_plain = flash_attention_plain(q, k, v, True, lse=True,
                                            q_offset=off)
    got = flash_attention_backward_kernel(q, k, v, out, lse, do, True, off)
    wgrads = flash_attention_backward_plain(q, k, v, out, lse, do, True, off)
    torch.cuda.synchronize()
    assert (flash_attention_kernel.launches,
            flash_attention_backward_kernel.launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert flash_close(out, want)
    assert float((lse - lse_plain).abs().max()) < 1e-5
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert max(flash_bwd_errors(got, wgrads)) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("float32", "bfloat16"))
@pytest.mark.parametrize("dh", (16, 64, 128))
def test_cuda_flash_offset_rows_equal_the_whole_sequence(no_tf32, dh, dtype):
    """Four blocks of rows at offsets that are multiples of the 64-row tile
    give the whole sequence's out, lse and dq bit for bit (a row's sums run
    over the same key tiles in the same order), and their dk and dv summed
    the whole call's within the backward's tolerance."""
    _need_card()
    B, Hq, Hkv, L = 2, 3, 1, 1024
    g = torch.Generator(device="cuda").manual_seed(dh)
    q, k, v, do = [torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((B, Hq, L, dh), (B, Hkv, L, dh),
                             (B, Hkv, L, dh), (B, Hq, L, dh))]
    out, lse = flash_attention_kernel(q, k, v, True, lse=True)
    dq, dk, dv = flash_attention_backward_kernel(q, k, v, out, lse, do, True)
    n = L // 4
    dk_sum, dv_sum = torch.zeros_like(dk, dtype=torch.float32), \
        torch.zeros_like(dv, dtype=torch.float32)
    for r in range(4):
        rows = slice(r * n, (r + 1) * n)
        qr, dor = q[:, :, rows].contiguous(), do[:, :, rows].contiguous()
        o, lr = flash_attention_kernel(qr, k, v, True, lse=True,
                                       q_offset=r * n)
        assert torch.equal(o, out[:, :, rows])
        assert torch.equal(lr, lse[:, :, rows])
        gq, gk, gv = flash_attention_backward_kernel(qr, k, v, o, lr, dor,
                                                     True, r * n)
        assert torch.equal(gq, dq[:, :, rows])
        dk_sum += gk.float()
        dv_sum += gv.float()
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert max(flash_bwd_errors((dk_sum, dv_sum), (dk, dv))) < tol


@pytest.mark.gpu
def test_cuda_flash_rejects_a_negative_offset():
    _need_card()
    q = torch.zeros(1, 3, 64, 64, device="cuda")
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_kernel(q, q[:, :1], q[:, :1], True, q_offset=-64)


# the backward: every head dim in both types, causal and not, GQA (g = 2)
# at a ragged length (129: past the 64-row tiles and the 32-row ones);
# then (B, Hq, Hkv, L, dh) edges: one key, lengths short of a tile and
# just past one, a single KV head for all query heads (Hkv = 1), MHA
# (Hkv = Hq), dh 256 and 96 at ragged lengths
FLASH_BWD_EDGES = [(1, 4, 2, 1, 256), (2, 4, 2, 15, 256), (1, 4, 1, 130, 256),
                   (2, 4, 4, 130, 96), (1, 6, 2, 65, 96), (2, 4, 2, 129, 16),
                   (1, 8, 2, 300, 128), (2, 6, 2, 77, 64), (1, 6, 2, 130, 32),
                   (1, 9, 3, 256, 64), (1, 4, 1, 1, 64), (2, 8, 1, 65, 128)]


def _bwd_id(shape, dt, causal):
    B, Hq, Hkv, L, dh = shape
    head = f"dh{dh}" if shape == (2, 4, 2, 129, dh) else \
        f"B{B}-Hq{Hq}-Hkv{Hkv}-L{L}-dh{dh}"
    return f"{head}-{str(dt)[6:]}-{'causal' if causal else 'full'}"


FLASH_BWD_CASES = [pytest.param(shape, dt, causal,
                                id=_bwd_id(shape, dt, causal))
                   for shape in [(2, 4, 2, 129, dh) for dh in HEAD_DIMS]
                   + FLASH_BWD_EDGES
                   for dt in (torch.float32, torch.bfloat16)
                   for causal in (True, False)]


def flash_bwd_errors(got, want):
    """max |d| of dq, dk and dv, each over the largest |plain| of the
    three."""
    scale = max(float(w.float().abs().max()) for w in want)
    return [float((a.float() - b.float()).abs().max()) / scale
            for a, b in zip(got, want)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,causal", FLASH_BWD_CASES)
def test_cuda_flash_backward_matches_plain(no_tf32, shape, dtype, causal):
    """The forward's lse against the plain version's (|d| < 1e-5), and the
    two backward launches against ``flash_attention_backward_plain`` on the
    same q, k, v, out, lse and dout: 1e-5 in f32 (the same f32 sums in
    another order), 1e-2 in bf16 (grads rounded to bf16). The quick check
    after a change to ``csrc/flash_attention_bwd.cu``:
    ``pytest --noconftest -m gpu -k flash_backward tests/test_torch_gpu.py``."""
    _need_card()
    B, Hq, Hkv, L, dh = shape
    g = torch.Generator(device="cuda").manual_seed(1000 * L + dh)
    q, k, v, do = [torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((B, Hq, L, dh), (B, Hkv, L, dh),
                             (B, Hkv, L, dh), (B, Hq, L, dh))]
    out, lse = flash_attention_kernel(q, k, v, causal, lse=True)
    _, lse_plain = flash_attention_plain(q, k, v, causal, lse=True)
    before = flash_attention_backward_kernel.launches
    got = flash_attention_backward_kernel(q, k, v, out, lse, do, causal)
    want = flash_attention_backward_plain(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert flash_attention_backward_kernel.launches == before + 1
    assert float((lse - lse_plain).abs().max()) < 1e-5
    for a, t in zip(got, (q, k, v)):
        assert a.dtype == dtype and a.shape == t.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert max(flash_bwd_errors(got, want)) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("float32", "bfloat16"))
@pytest.mark.parametrize("dh", (64, 128))
def test_cuda_flash_backward_is_repeatable(no_tf32, dh, dtype):
    """Two launches of the pair on the same inputs give the same bits of
    dq, dk and dv: no atomics, every gradient a fixed sum in a fixed order
    (GQA g = 3, causal, a ragged length)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(dh)
    q, k, v, do = [torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((2, 9, 1000, dh), (2, 3, 1000, dh),
                             (2, 3, 1000, dh), (2, 9, 1000, dh))]
    out, lse = flash_attention_kernel(q, k, v, True, lse=True)
    first = flash_attention_backward_kernel(q, k, v, out, lse, do, True)
    second = flash_attention_backward_kernel(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_attention_autograd_launches_each_kernel_once(no_tf32,
                                                           monkeypatch):
    """``attention()`` under autograd on the card: one forward launch (with
    lse), one launch of the backward pair, the grads those of the plain
    backward; a failing backward launch raises and does not fall back."""
    _need_card()
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import attention

    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = [torch.randn(s, generator=g, device="cuda").requires_grad_()
               for s in ((2, 6, 100, 64), (2, 2, 100, 64), (2, 2, 100, 64))]
    f0 = flash_attention_kernel.launches
    b0 = flash_attention_backward_kernel.launches
    out = attention(q, k, v)
    assert flash_attention_kernel.launches == f0 + 1
    do = torch.randn(out.shape, generator=g, device="cuda")
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == f0 + 1
    assert flash_attention_backward_kernel.launches == b0 + 1
    o, lse = flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                   True, lse=True)
    want = flash_attention_backward_plain(q.detach(), k.detach(), v.detach(),
                                          o, lse, do)
    assert max(flash_bwd_errors(got, want)) < 1e-5
    with torch.no_grad():  # serving: no lse, no graph
        attention(q, k, v)
    assert flash_attention_kernel.launches == f0 + 2

    real = build.call

    def failing(name, *args):
        if name == "lsk_flash_bwd_dq":
            raise RuntimeError(f"{name}: CUDA error 1")
        return real(name, *args)

    monkeypatch.setattr(build, "call", failing)
    out = attention(q, k, v)
    with pytest.raises(RuntimeError, match="lsk_flash_bwd_dq"):
        torch.autograd.grad(out, (q, k, v), do)
    assert flash_attention_backward_kernel.launches == b0 + 1


# the archs whose recurrent mixers carry f32 sums through every step of
# their scans. Their second step is ill-conditioned: noise of 2**-23 of
# each weight moves xLSTM's gradient norm there by up to ~2e-4 on the CPU
# alone, so no fixed tolerance near the others' can hold any two f32
# orders of summation to each other. The test measures that noise floor
# (a CPU twin stepped from the weights so perturbed) and holds the card
# to 4x it, and never to less than 5x the others' tolerances
TRAIN_RECURRENT = ("jamba_15_large_398b", "xlstm_13b")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_train_steps_match_the_cpu(no_tf32, arch):
    """Two train steps of every arch's reduced config from one state and
    batch (with a vision prefix or encoder frames where the arch takes
    them) on the card (the flash forward and backward on every global GQA
    layer of the decoder and the encoder) and on the CPU: loss and
    gradient norm within 1e-5 relative, every parameter within 1e-6
    (eps = 1e-3, as ``tests/test_torch_train.py`` holds the steps to the
    JAX package; for the recurrent archs, see TRAIN_RECURRENT), the
    telemetry exactly."""
    _need_card()
    from repro_torch import configs
    from repro_torch.launch import step_fns
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig

    cfg = configs.get(arch, reduced=True)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, decay_steps=10, eps=1e-3)

    def cpu_state():
        return step_fns.init_train_state(
            cfg, opt, torch.Generator().manual_seed(0), "cpu")

    cpu = cpu_state()
    card = step_fns.init_train_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(1), "cuda")
    step_fns.load_state_leaves(card, [t.detach().numpy() for t in
                                      step_fns.state_leaves(cpu).values()])
    recurrent = arch in TRAIN_RECURRENT
    if recurrent:
        noisy = cpu_state()
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in noisy.params.parameters():
                p.mul_(1 + 2.0 ** -23 * torch.randn(p.shape, generator=g))
    n_global = 0 if cfg.attention != "gqa" else sum(
        p.kind == "attn" and not p.window
        for plan in lm.plans(cfg) if plan is not None for p in plan.layers)
    step = step_fns.make_train_step(cfg, opt)
    rng = np.random.default_rng(4)
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                 "labels": torch.from_numpy(toks[:, 1:].copy())}
        if cfg.frontend == "vision":
            batch["prefix_emb"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.frontend_len, cfg.d_model)).astype(np.float32))
        if cfg.is_encdec:
            batch["frame_emb"] = torch.from_numpy(rng.standard_normal(
                (2, 24, cfg.d_model)).astype(np.float32))
        f0 = flash_attention_kernel.launches
        b0 = flash_attention_backward_kernel.launches
        card, mc = step(card, {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        assert flash_attention_kernel.launches == f0 + n_global
        assert flash_attention_backward_kernel.launches == b0 + n_global
        cpu, m = step(cpu, batch)
        if recurrent:
            noisy, mn = step(noisy, batch)
        for key in ("loss", "grad_norm"):
            want = float(m[key])
            tol = 1e-5 if not recurrent else max(
                5e-5, 4 * abs(float(mn[key]) - want) / abs(want))
            d = abs(float(mc[key]) - want) / abs(want)
            assert d <= tol, (key, d, tol)
    want = dict(cpu.params.named_parameters())
    tol = 1e-6 if not recurrent else max(5e-6, 4 * max(
        float((p.detach() - want[n].detach()).abs().max())
        for n, p in noisy.params.named_parameters()))
    for name, p in card.params.named_parameters():
        d = float((p.detach().cpu() - want[name].detach()).abs().max())
        assert d < tol, (name, d, tol)
    assert torch.equal(card.telemetry.cpu(), cpu.telemetry)


@pytest.mark.gpu
def test_cuda_compressed_psum_on_one_nccl_rank(tmp_path):
    """``compressed_psum`` over a one-rank NCCL group on the card: the
    mean of one rank is its own dequantised gradient, and the error
    feedback carries the residual, each step as on the CPU."""
    _need_card()
    import torch_train_ranks
    from repro_torch.distributed.ranks import spawn_ranks
    from repro_torch.optim import compress_int8, decompress_int8

    rng = np.random.default_rng(9)
    grads = [[{"w": rng.standard_normal(700).astype(np.float32),
               "b": rng.standard_normal((3, 90)).astype(np.float32)}
              for _ in range(3)]]
    got = spawn_ranks(torch_train_ranks.compressed_psum_steps, 1,
                      device="cuda", args=(grads, "cuda"),
                      init_file=tmp_path / "rdv")
    err = {k: np.zeros_like(v) for k, v in grads[0][0].items()}
    for step, (mean, e) in zip(grads[0], got):
        for k, g in step.items():
            fb = torch.from_numpy(g + err[k])
            q, sc, n = compress_int8(fb)
            local = decompress_int8(q, sc, n, fb.shape).numpy()
            np.testing.assert_allclose(mean[k], local, rtol=1e-6, atol=1e-7)
            err[k] = fb.numpy() - local
            np.testing.assert_allclose(e[k], err[k], rtol=1e-6, atol=1e-7)


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
    got, _ = lm.forward(cfg, params, {"tokens": toks.cuda()})
    assert flash_attention_kernel.launches == before + cfg.n_layers
    params_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    params_cpu.load_state_dict({n: t.cpu() for n, t in
                                params.state_dict().items()})
    want, _ = lm.forward(cfg, params_cpu, {"tokens": toks})
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) / scale < 1e-5
    caches = lm.init_cache(cfg, 2, 96)
    steps = [lm.serve_step(cfg, params, caches, toks[:, i:i + 1].cuda())[0]
             for i in range(96)]
    dec = torch.cat(steps, 1).cpu()
    assert float((dec - got.cpu()).abs().max()) / scale < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "jamba_15_large_398b"])
def test_cuda_moe_and_ssm_archs_match_the_cpu(no_tf32, arch):
    """A MoE arch and a Mamba hybrid at their reduced configs: the card's
    forward (the kernel on the global GQA layers; logits, aux and the
    telemetry counts) against the same weights on the CPU, and the card's
    decode through its caches against the CPU's, step by step."""
    _need_card()
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get(arch, reduced=True)
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            "cpu").to("cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    before = flash_attention_kernel.launches
    got, aux = lm.forward(cfg, params, {"tokens": toks.cuda()})
    n_global = sum(p.kind == "attn" and not p.window
                   for p in lm.plans(cfg)[0].layers)
    assert flash_attention_kernel.launches == before + n_global
    want, want_aux = lm.forward(cfg, cpu, {"tokens": toks})
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) / scale < 1e-5
    assert torch.equal(aux["telemetry"].cpu(), want_aux["telemetry"])
    for k in ("lb_loss", "z_loss", "dropped"):
        assert abs(float(aux[k]) - float(want_aux[k])) < 1e-5, k
    caches, caches_cpu = lm.init_cache(cfg, 2, 40), lm.init_cache(
        cfg, 2, 40, "cpu")
    for i in range(40):
        a, caches = lm.serve_step(cfg, params, caches,
                                  toks[:, i:i + 1].cuda())
        b, caches_cpu = lm.serve_step(cfg, cpu, caches_cpu, toks[:, i:i + 1])
        assert float((a.cpu() - b).abs().max()) / float(
            b.abs().max()) < 1e-5, i


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


# the streaming loop: flush deltas folded into planes on the card
def _planes_leaves(p):
    return [p.key, p.cw, p.pw, p.pool_key, p.pool_cw, p.pool_pw]


def _sub_batch(rng, n, tlo, thi, nv=200):
    return EdgeBatch.from_arrays(
        rng.integers(0, nv, n), rng.integers(0, nv, n), rng.integers(0, 3, n),
        rng.integers(0, 3, n), rng.integers(0, 6, n), rng.integers(1, 4, n),
        np.sort(rng.integers(tlo, thi, n)))


@pytest.mark.gpu
def test_cuda_planes_delta_folds_equal_cold_builds():
    """Single-subwindow flushes on the kernel route record their delta
    around the insert and pool kernels; the folded planes (every horizon,
    single and stacked) equal a cold build on the card and the CPU's
    planes of the same stream. A flush that resets a slot (a window
    advance) is built instead, still equal."""
    _need_card()
    rng = np.random.default_rng(23)
    base = _sub_batch(rng, 2000, 0, 150)
    flushes = [(_sub_batch(rng, 300, 125, 150), "delta"),  # live subwindow
               (_sub_batch(rng, 300, 100, 125), "delta"),  # late: older slot
               (_sub_batch(rng, 300, 150, 175), "build"),  # advance: reset
               (_sub_batch(rng, 300, 150, 175), "delta")]
    spec = skt.make_spec("lsketch", n_shards=4, config=CFG)
    hs = [None, 1, 2]
    sts = {dev: skt.ingest(spec, skt.create(spec, device=dev), base,
                           path="cuda") for dev in ("cpu", "cuda")}
    for b, want in flushes:
        for dev, st in sts.items():
            for h in hs:
                skt.query_planes(spec, st, h)
            skt.query_planes_multi(spec, st, hs)
            sts[dev] = skt.ingest(spec, st, b, path="cuda")
        st = sts["cuda"]
        before = dict(skt.PLANES_BUILD_COUNTS)
        got = [skt.query_planes(spec, st, h) for h in hs] + \
            [skt.query_planes_multi(spec, st, hs)[0]]
        moved = {k: skt.PLANES_BUILD_COUNTS[k] - v
                 for k, v in before.items()}
        other = "build" if want == "delta" else "delta"
        assert moved[want] == len(hs) + 1 and moved[other] == 0, moved
        cold = skt.ShardedState(st.live())
        cpu = sts["cpu"]
        for g, c, r in zip(got, [skt.query_planes(spec, cold, h)
                                 for h in hs] +
                           [skt.query_planes_multi(spec, cold, hs)[0]],
                           [skt.query_planes(spec, cpu, h) for h in hs] +
                           [skt.query_planes_multi(spec, cpu, hs)[0]]):
            for x, y, z in zip(_planes_leaves(g), _planes_leaves(c),
                               _planes_leaves(r)):
                assert torch.equal(x, y) and torch.equal(x.cpu(), z)
    for x, y in zip(skt.to_numpy(sts["cuda"]), skt.to_numpy(sts["cpu"])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
def test_cuda_async_ingestor_equals_ingest():
    """``AsyncIngestor`` on the card (the kernel route, queries between
    the submissions on delta-kept planes) ends leaf for leaf equal to
    synchronous ``ingest``, and its answers equal the synchronous
    handle's at every query."""
    _need_card()
    rng = np.random.default_rng(29)
    spec = skt.make_spec("lsketch", n_shards=4, config=CFG)
    b = _sub_batch(rng, 6000, 0, 100, nv=400)  # 4 subwindows, ~2 cuts each
    cuts = np.flatnonzero(np.diff(b.time // CFG.subwindow_size)) + 1
    cuts = sorted(set([0, len(b)] + cuts.tolist() +
                      list(range(0, len(b), 700))))
    q = skt.QueryBatch.edges(b.src[:64], b.src_label[:64], b.dst[:64],
                             b.dst_label[:64], last=[None, 1, 3])
    sync = skt.create(spec, device="cuda")
    ing = skt.AsyncIngestor(spec, path="cuda", device="cuda")
    for i, (a, z) in enumerate(zip(cuts[:-1], cuts[1:])):
        ing.submit(b.slice(a, z))
        sync = skt.ingest(spec, sync, b.slice(a, z), path="cuda")
        if i % 2:
            assert torch.equal(skt.query(spec, ing.state, q, path="cuda"),
                               skt.query(spec, sync, q, path="scan"))
    final = ing.flush()
    assert skt.PLANES_BUILD_COUNTS["delta"] > 0
    for x, y in zip(skt.to_numpy(final), skt.to_numpy(sync)):
        np.testing.assert_array_equal(x, y)


def _pooled_planes_cpu(groups, per=2, seed=41):
    """Planes of a pool of ``groups`` tenants at ``per`` rows each (CPU),
    tenant g in slot g on a clock offset by 3g subwindows, tenant 1 empty;
    with the raw queries of every group ([groups * 96]) and their
    addressing."""
    rng = np.random.default_rng(seed)
    spec = skt.make_spec("lsketch", n_shards=per, config=CFG)
    pool = skt.TenantPool(spec, n_slots=groups, device="cpu")
    for g in range(groups):
        pool.attach(g)
        if g == 1:
            continue
        n = 400
        t0 = 3 * g * CFG.subwindow_size
        pool.ingest(g, EdgeBatch.from_arrays(
            rng.integers(0, 90, n), rng.integers(0, 90, n),
            rng.integers(0, 3, n), rng.integers(0, 3, n),
            rng.integers(0, 6, n), rng.integers(1, 4, n),
            np.sort(rng.integers(t0, t0 + 150, n))))
    planes = skt.query_planes(spec, pool.state, 2, groups=groups)
    q = [_t(rng.integers(0, hi, groups * 96)) for hi in (90, 3, 90, 3, 6)]
    return planes, q


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 3])
def test_cuda_grouped_entries_match_plain(groups):
    """The grouped entries on the card against their plain versions on a
    pool's planes, with an empty group: the edge probe at H = 1 and on a
    three-horizon stack (one launch each), the vertex scan out and in
    (one launch each), the label aggregate and the grouped top-k (one
    decode). At G = 1 each equals the ungrouped entry."""
    _need_card()
    from repro_torch.kernels.heavy_hitters import ops as hh
    from repro_torch.kernels.vertex_scan import ops as vs
    planes, q = _pooled_planes_cpu(groups)
    gpu = lambda p: dataclasses.replace(p, **{  # noqa: E731
        f.name: getattr(p, f.name).cuda() for f in dataclasses.fields(p)})
    cp = gpu(planes)
    qc = [x.cuda() for x in q]
    for pl, plc in ((planes, cp), (_stack3(planes), _stack3(cp))):
        for le in (4, None):
            lab = None if le is None else q[le]
            before = sketch_query_kernel_sharded.launches
            got = edge_query_kernel(CFG, plc, *qc[:4], None if le is None
                                    else qc[le], groups=groups)
            torch.cuda.synchronize()
            assert sketch_query_kernel_sharded.launches == before + 1
            want = edge_query_plain(CFG, pl, *q[:4], lab, groups=groups)
            for a, b in zip(got, want):
                assert a.shape[-1] == 96 and torch.equal(a.cpu(), b)
            if groups == 1:
                one = edge_query_kernel(CFG, plc, *qc[:4], None if le is None
                                        else qc[le])
                assert all(torch.equal(a, b) for a, b in zip(got, one))
    pre, lines = vs.scan_lines(CFG, q[0], q[1])
    bucket = th.edge_label_bucket(q[4], CFG.c, CFG.seed)
    for direction in ("out", "in"):
        for lab in (bucket, None):
            kw = dict(r=CFG.r, F=CFG.F, direction=direction)
            want = vertex_scan_plain(lines, pre.f, lab, planes.key,
                                     planes.cw, planes.pw, groups=groups,
                                     **kw)
            before = vertex_scan_kernel_sharded.launches
            got = vertex_scan_kernel_sharded(
                lines.cuda(), pre.f.cuda(), None if lab is None
                else lab.cuda(), cp.key, cp.cw, cp.pw, groups=groups, **kw)
            torch.cuda.synchronize()
            assert vertex_scan_kernel_sharded.launches == before + 1
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
        for fn, args in ((vs.vertex_query_planes, (0, (1, 4))),
                         (vs.label_aggregate_planes, (1, 4))):
            pick = lambda xs, i: tuple(pick(xs, j) for j in i) \
                if isinstance(i, tuple) else xs[i]  # noqa: E731
            want = fn(CFG, planes, *(pick(q, i) for i in args),
                      direction=direction, with_le=True, groups=groups)
            got = fn(CFG, cp, *(pick(qc, i) for i in args),
                     direction=direction, with_le=True, groups=groups)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
    for rank in (hh.heavy_vertices_planes, hh.heavy_edges_planes,
                 hh.top_labels_planes):
        before = cell_decode_kernel_sharded.launches
        got = rank(CFG, cp, 8, groups=groups)
        assert cell_decode_kernel_sharded.launches == before + 1
        want = rank(CFG, planes, 8, groups=groups)
        for a, b in zip(got, want):
            assert a.shape[0] == groups and torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_cuda_tenant_pool_matches_cpu_twin():
    """A small ``TenantPool`` on the card (kernel route, routed tenant
    spec, tenants on offset clocks, an eviction and a readmission) and
    its CPU twin: leaf for leaf, every ``query_many`` answer and the
    grouped top-k equal; a pooled edge dispatch is one probe launch."""
    _need_card()
    import tempfile
    rng = np.random.default_rng(43)
    spec = skt.make_spec("lsketch", n_shards=2, config=CFG).with_splits(
        [(5, 2, 2)])
    dirs = [tempfile.mkdtemp() for _ in range(2)]
    pools = {dev: skt.TenantPool(spec, n_slots=3, directory=dirs[i],
                                 device=dev)
             for i, dev in enumerate(("cuda", "cpu"))}
    sub = CFG.subwindow_size
    for rnd in range(4):
        batch = {}
        for t in range(4 if rnd == 3 else 3):  # tenant 3 evicts the LRU
            n = 300
            t0 = (rnd + 2 * t) * sub
            src = rng.integers(0, 90, n)
            src[::3] = 5
            batch[t] = EdgeBatch.from_arrays(
                src, rng.integers(0, 90, n), src % 3, rng.integers(0, 3, n),
                rng.integers(0, 6, n), rng.integers(1, 4, n),
                np.sort(rng.integers(t0, t0 + sub, n)))
        for pool in pools.values():
            pool.submit(batch)
    for pool in pools.values():
        assert 0 not in pool.tenants  # the LRU tenant of the last round
        pool.attach(0)  # readmitted from its checkpoint
    states = {dev: p.state for dev, p in pools.items()}
    for x, y in zip(skt.to_numpy(states["cuda"]),
                    skt.to_numpy(states["cpu"])):
        np.testing.assert_array_equal(x, y)
    Q = skt.QueryBatch
    v = rng.integers(0, 90, 40)
    tenants = sorted(pools["cuda"].tenants)
    for qb in (Q.edges(v, v % 3, v[::-1], v[::-1] % 3, last=2),
               Q.edges(v, v % 3, v[::-1], v[::-1] % 3, edge_label=v % 6),
               Q.vertices(v, v % 3, direction="in", last=1),
               Q.labels(np.arange(3), edge_label=[0, 1, 2])):
        pairs = [(t, qb) for t in tenants]
        before = sketch_query_kernel_sharded.launches
        got = pools["cuda"].query_many(pairs, path="cuda")
        if qb.kind == "edge":
            assert sketch_query_kernel_sharded.launches == before + 1
        want = pools["cpu"].query_many(pairs, path="cuda")
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    for kind in ("vertex", "edge", "label"):
        got = pools["cuda"].top_k_many(tenants, kind=kind, k=8,
                                       horizons=[None, 1])
        want = pools["cpu"].top_k_many(tenants, kind=kind, k=8,
                                       horizons=[None, 1])
        for a, b in zip(got, want):
            assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_cuda_reshard_matches_plain_loop():
    """``reshard`` on the card (the decode kernel, the claim walk through
    the insert and pool kernels, the landing scatter) against the plain
    host loop on the CPU, leaf for leaf: grow, shrink, a routing table and
    the prune, on a crowded state with a lagging shard and pool overflow;
    then ``restore`` across shard counts on the card."""
    _need_card()
    import tempfile
    from repro_torch.sketch.routing import RoutingTable
    cfg = LSketchConfig(d=16, n_blocks=2, F=256, r=4, s=4, c=4, k=4,
                        window_size=100, pool_capacity=16, pool_probes=4)
    spec = skt.make_spec("lsketch", n_shards=3, config=cfg).with_splits(
        [(7, 1, 2)])
    rng = np.random.default_rng(47)
    st = skt.create(spec, device="cpu")
    for t0 in (0, 50, 150):  # the last batch reaches one shard only
        n = 400 if t0 < 150 else 60
        src = rng.integers(0, 120, n) if t0 < 150 else np.full(n, 7)
        st = skt.ingest(spec, st, EdgeBatch.from_arrays(
            src, rng.integers(0, 120, n), np.where(src == 7, 1, src % 3),
            rng.integers(0, 3, n), rng.integers(0, 6, n),
            rng.integers(1, 4, n), np.sort(rng.integers(t0, t0 + 25, n))))
    assert int(st.live().pool_lost.sum()) > 0
    card = skt.ShardedState(st.live().map(lambda x: x.cuda()))
    det = skt.HeavyKeyDetector(capacity=8)
    det.update([1, 2, 3] * 50)
    cases = [(1, {}), (2, {}), (5, {}),
             (4, dict(routing=RoutingTable(((3, 0, 3),)))),
             (4, dict(detector=det, heat_threshold=0.05))]
    before = [w.launches for w in (cell_decode_kernel_sharded,
                                   sketch_insert_kernel_sharded,
                                   pool_pass_kernel_sharded)]
    for m, kw in cases:
        got = skt.reshard(spec, card, m, **kw)
        assert got.device.type == "cuda"
        want = skt.reshard(spec, st, m, **kw)
        for x, y in zip(skt.to_numpy(got), skt.to_numpy(want)):
            np.testing.assert_array_equal(x, y)
    after = [w.launches for w in (cell_decode_kernel_sharded,
                                  sketch_insert_kernel_sharded,
                                  pool_pass_kernel_sharded)]
    assert [a - b for a, b in zip(after, before)] == [len(cases)] * 3
    with tempfile.TemporaryDirectory() as tmp:
        skt.save(spec, card, tmp)
        for m in (2, 4):
            got = skt.restore(spec.replace(n_shards=m), tmp, device="cuda")
            want = skt.restore(spec.replace(n_shards=m), tmp, device="cpu")
            for x, y in zip(skt.to_numpy(got), skt.to_numpy(want)):
                np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("pooled", [False, True])
def test_cuda_sketch_server_matches_cpu_twin(pooled):
    """``SketchServer`` on the card (single handle with the detector and a
    registered sweep, or pool mode) against its CPU twin on the same
    stream and interleaved requests: the state leaf for leaf, every
    answer and the top-k equal; one probe launch per edge group."""
    _need_card()
    from repro_torch.data.stream import PHONE, edge_batches, generate
    from repro_torch.launch.serve_sketch import SketchServer, build_spec
    stream = generate(dataclasses.replace(PHONE, n_edges=6000,
                                          n_vertices=300), seed=3)
    spec = build_spec("lsketch", PHONE.window_size, 2)
    servers = {}
    for dev in ("cuda", "cpu"):
        path = "cuda"  # the CPU twin: the kernels' plain versions
        if pooled:
            servers[dev] = SketchServer(
                pool=skt.TenantPool(spec, n_slots=3, device=dev),
                query_path=path, horizons=[1, 2])
        else:
            servers[dev] = SketchServer(spec, heat_threshold=0.05,
                                        query_path=path, horizons=[1, 2],
                                        device=dev)
    for i, b in enumerate(edge_batches(stream, 1000)):
        for s in servers.values():
            if pooled:
                s.ingest_many([(i % 3, b)])
            else:
                s.ingest(b)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, len(stream), 120)
    answers, launched = {}, 0
    for dev, s in servers.items():
        reqs = []
        for j, i in enumerate(idx):
            kw = dict(last=(None, 1, 2)[j % 3])
            if pooled:
                kw["tenant"] = j % 3
            if j % 2:
                kw["le"] = int(stream.edge_label[i])
            if j % 4 < 2:
                reqs.append(s.submit("edge", src=int(stream.src[i]),
                                     la=int(stream.src_label[i]),
                                     dst=int(stream.dst[i]),
                                     lb=int(stream.dst_label[i]), **kw))
            else:
                reqs.append(s.submit("vertex", v=int(stream.src[i]),
                                     lv=int(stream.src_label[i]),
                                     direction="in", **kw))
        before = sketch_query_kernel_sharded.launches
        s.flush()
        if dev == "cuda":
            launched = sketch_query_kernel_sharded.launches - before
        answers[dev] = [r.answer for r in reqs]
    assert answers["cuda"] == answers["cpu"]
    # 6 edge groups, (le?) x (last in None, 1, 2): one pooled dispatch a
    # group, or the single handle's one edge pass
    assert launched == (6 if pooled else 1)
    for x, y in zip(skt.to_numpy(servers["cuda"].state),
                    skt.to_numpy(servers["cpu"].state)):
        np.testing.assert_array_equal(x, y)
    kw = dict(tenant=1) if pooled else {}
    for kind in ("vertex", "edge", "label"):
        for a, b in zip(servers["cuda"].top_k(kind, 8, **kw),
                        servers["cpu"].top_k(kind, 8, **kw)):
            assert torch.equal(a.cpu(), b)
    if not pooled:
        assert servers["cuda"].budget_report().to_json() == \
            servers["cpu"].budget_report().to_json()


@pytest.mark.gpu
def test_cuda_fused_flush_matches_per_group_query():
    """A single handle's 512-request mixed flush on the card (every kind,
    with and without an edge label, lasts None, 1 and k, both directions)
    answers each request as ``skt.query`` answers its group on the card
    with the real kernels: one edge-probe launch for the flush, one
    vertex-scan launch a (direction, horizon) present."""
    _need_card()
    from repro_torch.data.stream import PHONE, edge_batches, generate
    from repro_torch.launch.serve_sketch import SketchServer, build_spec
    stream = generate(dataclasses.replace(PHONE, n_edges=6000,
                                          n_vertices=300), seed=4)
    spec = build_spec("lsketch", PHONE.window_size, 4)
    k = spec.config.effective_k
    server = SketchServer(spec, query_path="cuda", horizons=[1, k],
                          device="cuda")
    for b in edge_batches(stream, 1000):
        server.ingest(b)
    rng = np.random.default_rng(9)
    idx = rng.integers(0, len(stream), 512)
    handles = []
    for j, i in enumerate(idx):
        kw = dict(last=(None, 1, k)[j % 3])
        if (j // 3) % 2:
            kw["le"] = int(stream.edge_label[i])
        kind = ("edge", "edge", "vertex", "label")[(j // 6) % 4]
        d = ("out", "in")[(j // 24) % 2]
        if kind == "edge":
            kw.update(src=int(stream.src[i]), la=int(stream.src_label[i]),
                      dst=int(stream.dst[i]), lb=int(stream.dst_label[i]))
        elif kind == "vertex":
            kw.update(v=int(stream.src[i] if d == "out" else stream.dst[i]),
                      lv=int(stream.src_label[i] if d == "out"
                             else stream.dst_label[i]), direction=d)
        else:
            kw.update(lv=int(stream.src_label[i]), direction=d)
        handles.append(server.submit(kind, **kw))
    groups = {}
    for h in handles:
        groups.setdefault(server._group_key(h), []).append(h)
    assert len(groups) == 30
    before = (sketch_query_kernel_sharded.launches,
              vertex_scan_kernel_sharded.launches)
    assert server.flush() == 512
    launched = (sketch_query_kernel_sharded.launches - before[0],
                vertex_scan_kernel_sharded.launches - before[1])
    runs = {(d, min(last or k, k)) for kind, _, last, d in groups
            if kind == "vertex"}
    assert launched == (1, len(runs)) == (1, 4)
    state = server.state
    for (kind, with_le, last, d), hs in groups.items():
        q = server._group_batch(kind, hs, with_le, last, d)
        want = skt.query(spec, state, q, path="cuda")
        assert want.device.type == "cuda"
        assert [h.answer for h in hs] == want.cpu().tolist(), (kind, with_le,
                                                               last, d)
    assert any(h.answer for h in handles)


# --------------------------------------------------------------------------
# the mesh-resident collective path at world 1 on NCCL (one card a rank)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_world1(tmp_path_factory):
    """A one-rank NCCL group in this process (``distributed.ranks``),
    destroyed after the module's tests; None without a card."""
    if not torch.cuda.is_available():
        yield None
        return
    import torch.distributed as dist
    from repro_torch.distributed.ranks import init_group
    init_group(0, 1, tmp_path_factory.mktemp("nccl") / "rdv", "nccl")
    try:
        yield skt.MeshContext()
    finally:
        dist.destroy_process_group()


def _mesh_deployment(seed=11, n=6000):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 90, n), rng.integers(0, 90, n)
    return EdgeBatch.from_arrays(src, dst, src % 3, dst % 3,
                                 rng.integers(0, 6, n), rng.integers(1, 4, n),
                                 np.sort(rng.integers(0, 400, n)))


@pytest.mark.gpu
def test_cuda_collective_matches_cuda_path_on_nccl(nccl_world1):
    """A placed 4-shard handle on the card over a one-rank NCCL group:
    ingest keeps the context and equals unplaced ingest leaf for leaf,
    and every collective answer (each kind, with and without the edge
    label, two horizons and a sweep) and top-k equals the "cuda" path's
    and the CPU twin's scan path."""
    _need_card()
    spec = skt.make_spec("lsketch", n_shards=4, config=CFG)
    batch = _mesh_deployment()
    placed = skt.place(spec, skt.create(spec, "cuda"), nccl_world1)
    host = skt.create(spec, "cuda")
    twin = skt.create(spec, "cpu")
    for a in range(0, len(batch), 1500):
        b = EdgeBatch(*[x[a:a + 1500] for x in (
            batch.src, batch.dst, batch.src_label, batch.dst_label,
            batch.edge_label, batch.weight, batch.time)])
        placed = skt.ingest(spec, placed, b)
        host = skt.ingest(spec, host, b)
        twin = skt.ingest(spec, twin, b, path="cuda")
    assert skt.mesh_context(placed) is nccl_world1
    for x, y, z in zip(skt.to_numpy(placed, spec), skt.to_numpy(host),
                       skt.to_numpy(twin)):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    vs = np.arange(64, dtype=np.int32)
    le = batch.edge_label[:256]
    for last in (None, 1, [None, 1, 2]):
        for q in (skt.QueryBatch.edges(batch.src[:256], batch.src_label[:256],
                                       batch.dst[:256], batch.dst_label[:256],
                                       last=last),
                  skt.QueryBatch.edges(batch.src[:256], batch.src_label[:256],
                                       batch.dst[:256], batch.dst_label[:256],
                                       edge_label=le, last=last),
                  skt.QueryBatch.vertices(vs, vs % 3, last=last),
                  skt.QueryBatch.vertices(vs, vs % 3, le[:64],
                                          direction="in", last=last),
                  skt.QueryBatch.labels([0, 1, 2], last=last)):
            got = skt.query(spec, placed, q, path="collective").cpu()
            assert torch.equal(got, skt.query(spec, host, q,
                                              path="cuda").cpu())
            assert torch.equal(got, skt.query(spec, twin, q, path="scan"))
    for fn in (skt.heavy_vertices, skt.heavy_edges, skt.top_labels):
        for a, b in zip(fn(spec, placed, 8, path="collective"),
                        fn(spec, host, 8, path="cuda")):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
def test_cuda_psum_sketch_on_nccl(nccl_world1):
    """``psum_sketch`` over a one-rank NCCL group: each leaf's MAX or SUM
    over one rank is the leaf itself, on the card, and the input is kept."""
    _need_card()
    from repro_torch.core.merge import psum_sketch
    spec = skt.make_spec("lsketch", n_shards=1, config=CFG)
    st = skt.ingest(spec, skt.create(spec, "cuda"), _mesh_deployment(n=500))
    plain = skt.unstack_state(st, 0)
    out = psum_sketch(CFG, plain, nccl_world1.group)
    for x, y in zip(out.leaves(), plain.leaves()):
        assert x.is_cuda and torch.equal(x, y) and x is not y


@pytest.mark.gpu
def test_cuda_place_refuses_a_gloo_group(nccl_world1):
    """CUDA tensors over a gloo group would need host staging: refused."""
    _need_card()
    import torch.distributed as dist
    gloo = dist.new_group(backend="gloo")
    spec = skt.make_spec("lsketch", n_shards=2, config=CFG)
    with pytest.raises(ValueError, match="CUDA tensors need NCCL"):
        skt.place(spec, skt.create(spec, "cuda"), gloo)
    with pytest.raises(ValueError, match="CUDA tensors need NCCL"):
        skt.place(spec, skt.create(spec, "cpu"), nccl_world1)


@pytest.mark.gpu
def test_cuda_router_telemetry_mesh_matches_cpu_twin(nccl_world1):
    """``RouterTelemetry(mesh=...)`` on the card (collective reads by
    default) against a host-resident CPU twin on the same counts."""
    _need_card()
    from repro_torch.telemetry import CapacityController, RouterTelemetry
    card = RouterTelemetry(n_experts=16, window_steps=16, subwindows=4,
                           n_shards=4, mesh=nccl_world1, device="cuda")
    twin = RouterTelemetry(n_experts=16, window_steps=16, subwindows=4,
                           n_shards=4, device="cpu")
    assert card.query_path == "collective"
    ctrls = [CapacityController(t) for t in (card, twin)]
    cf = [1.25, 1.25]
    rng = np.random.default_rng(4)
    for step in range(0, 40, 2):
        counts = rng.integers(0, 4, (256, 16))
        counts[:, step % 16] += 12
        for t in (card, twin):
            t.ingest(counts, step)
        cf = [c.update(f) for c, f in zip(ctrls, cf)]
        assert cf[0] == cf[1]
        for last in (None, 2):
            np.testing.assert_array_equal(card.load_vector(last),
                                          twin.load_vector(last))
    assert card.routing_affinity(5, 3) == twin.routing_affinity(5, 3)
    assert card.expert_load(2, last=1) == twin.expert_load(2, last=1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("smollm_135m", "kimi_k2_1t_a32b"))
def test_cuda_sharded_train_steps_match_unsharded(no_tf32, nccl_world1,
                                                  monkeypatch, arch):
    """Two train steps of the reduced config over a 1 x 1 mesh on the
    one-rank NCCL group (``shard_state``/``make_sharded_train_step``;
    Kimi-K2 through the MoE's expert-parallel branch, its all-gathers
    counted) against the unsharded steps from one state and batch: loss
    and gradient norm within 1e-5 relative, every parameter within 1e-6
    (eps = 1e-3), the telemetry and the flash launches equal."""
    _need_card()
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import step_fns
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import AdamWConfig

    cfg = configs.get(arch, reduced=True)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, decay_steps=10, eps=1e-3)
    mesh = make_smoke_mesh(1, 1, "cuda")
    plain = step_fns.init_train_state(
        cfg, opt, torch.Generator().manual_seed(0), "cuda")
    sharded = step_fns.shard_state(cfg, opt, plain, mesh)
    gathers = []
    real = dist.all_gather
    monkeypatch.setattr(dist, "all_gather",
                        lambda *a, **k: gathers.append(1) or real(*a, **k))
    rng = np.random.default_rng(4)
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()).cuda(),
                 "labels": torch.from_numpy(toks[:, 1:].copy()).cuda()}
        f0 = flash_attention_kernel.launches
        b0 = flash_attention_backward_kernel.launches
        sharded, ms = step_fns.make_sharded_train_step(cfg, opt, mesh)(
            sharded, batch)
        torch.cuda.synchronize()
        launched = (flash_attention_kernel.launches - f0,
                    flash_attention_backward_kernel.launches - b0)
        f0 = flash_attention_kernel.launches
        b0 = flash_attention_backward_kernel.launches
        plain, mp = step_fns.make_train_step(cfg, opt)(plain, batch)
        assert launched == (flash_attention_kernel.launches - f0,
                            flash_attention_backward_kernel.launches - b0)
        assert launched[0] > 0
        for key in ("loss", "grad_norm"):
            d = abs(float(ms[key]) - float(mp[key])) / abs(float(mp[key]))
            assert d <= 1e-5, (key, d)
    full = step_fns.full_state_leaves(sharded)
    for name, p in plain.params.named_parameters():
        d = float((full[f"params.{name}"] - p.detach()).abs().max())
        assert d <= 1e-6, (name, d)
    assert torch.equal(sharded.telemetry, plain.telemetry)
    if cfg.n_experts:  # each MoE layer's expert gather, forward and back
        n_moe = sum(p.mlp == "moe" for p in
                    step_fns.lm.plans(cfg)[0].layers)
        assert len(gathers) >= 2 * 2 * n_moe


@pytest.mark.gpu
def test_cuda_trainer_restarts_from_its_checkpoint(no_tf32, monkeypatch,
                                                   tmp_path):
    """``chip_smoke``'s L11 at SmolLM-135M's reduced config on the card:
    ``train(resume=True)`` under ``RestartLoop``, a checkpoint every 3
    steps and a fault after step 4: one restart from step 4, the last
    step 6, the losses an unbroken run's bit for bit, and one flash
    forward and backward launch a layer and microbatch for each of the 7
    steps the crashed run took."""
    _need_card()
    from pathlib import Path

    from repro_torch import configs
    from repro_torch.launch.train import train

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    kw = dict(arch="smollm_135m", steps=6, smoke=True, batch_size=2,
              seq_len=64, microbatches=2, log_every=100, seed=0,
              lr_peak=1e-3, device="cuda")
    unbroken = train(**kw, ckpt_dir=str(tmp_path / "unbroken"),
                     ckpt_every=0)
    f0 = flash_attention_kernel.launches
    b0 = flash_attention_backward_kernel.launches
    run = chip_smoke.restart_run(kw, str(tmp_path / "crash"), fault_after=4,
                                 ckpt_every=3)
    assert run["final_step"] == 6 and run["restarts"] == 1
    assert run["starts"] == [0, 4]
    assert run["losses"] == unbroken
    assert run["segment_losses"][0][4] == run["segment_losses"][1][0]
    n = chip_smoke.n_flash_layers(configs.get("smollm_135m", reduced=True))
    want = n * 2 * 7
    assert (flash_attention_kernel.launches - f0,
            flash_attention_backward_kernel.launches - b0) == (want, want)
