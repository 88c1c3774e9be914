"""Edge probe walk on window-reduced planes: CUDA kernel wrappers and plain
versions.

Both wrappers launch ``csrc/sketch_query.cu`` (one half-warp per
(shard, query); what bounds it is noted there), which replaces the TPU
kernel ``repro/kernels/sketch_query/kernel.py::sketch_query_kernel_sharded``,
and both count in ``sketch_query_kernel_sharded.launches``:

* ``sketch_query_kernel_sharded`` keeps the TPU kernel's contract:
  rows/cols/keys [nq, s]; le [nq] label bucket or None (no label plane);
  key_plane/cw [S, 2, d, d]; pw [S, 2, d, d, c]. Returns (w, w_label,
  go_pool), each int32 [S, nq] (w_label is 0 without a label; go_pool is
  1 where every probe cell holds another key). ``sketch_query_plain`` is
  its vectorized twin (counterpart of ``sketch_query_xla``).
* ``edge_query_kernel`` is the whole edge query in one launch: the
  addressing of raw queries (src, la, dst, lb, le [B]; le None without
  the edge label), the walk and the pool lookup, against the planes of H
  horizons (``QueryPlanes``, H = 1, or ``MultiPlanes``, whose horizon-
  independent key and pool_key are read from row 0). Returns (w,
  w_label), each int32 [H, S, B]. ``edge_query_plain`` is its twin: the
  host addressing, the walk's plain version and the vectorized pool
  lookup (the reference's ``edge_query_planes`` body). With ``groups=G``
  (a pooled stack of tenants) the queries are ``[G * B]``, group g's B in
  a row, and shard row s answers only group ``s // (S // G)``'s: the
  outputs stay [H, S, B], and no row probes another group's queries.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing as hsh
from repro_torch.core.lsketch import edge_probes, precompute
from repro_torch.core.types import EMPTY
from repro_torch.kernels import build


def _walk_plain(rows, cols, keys, key_plane):
    """The stop of every (shard, query) walk: (first candidate index,
    hit, any stop), each [S, nq]."""
    S = key_plane.shape[0]
    nq, s = rows.shape
    cur = key_plane[:, :, rows.long(), cols.long()].movedim(1, -1)
    is_m = (cur == keys[None, :, :, None]).reshape(S, nq, 2 * s)
    stop = is_m | (cur == EMPTY).reshape(S, nq, 2 * s)
    any_stop = stop.any(-1)
    first = torch.argmax(stop.to(torch.uint8), dim=-1)  # [S, nq]
    hit = torch.gather(is_m, -1, first[..., None])[..., 0] & any_stop
    return first, hit, any_stop


def _at_stop(rows, cols, first, hit, le, cw, pw):
    """cw and pw[le] at each walk's stop (0 where it did not match) for
    counters with any leading axes over [S, 2, d, d(, c)]."""
    S, nq = first.shape
    pi, tz = first // 2, first % 2
    rr = torch.gather(rows.long().expand(S, -1, -1), -1, pi[..., None])[..., 0]
    cc = torch.gather(cols.long().expand(S, -1, -1), -1, pi[..., None])[..., 0]
    s_idx = torch.arange(S, device=rows.device)[:, None]
    w = torch.where(hit, cw[..., s_idx, tz, rr, cc], 0)
    if le is None:
        return w, torch.zeros_like(w)
    wl = pw[..., s_idx, tz, rr, cc, le.long()[None, :]]
    return w, torch.where(hit, wl, 0)


def sketch_query_plain(rows, cols, keys, le, key_plane, cw, pw):
    first, hit, any_stop = _walk_plain(rows, cols, keys, key_plane)
    w, wl = _at_stop(rows, cols, first, hit, le, cw, pw)
    return w, wl, (~any_stop).to(torch.int32)


def _check(tensors, shapes, what):
    """What a kernel takes: contiguous int32 tensors on one card, of the
    given shapes (``None`` entries are skipped)."""
    build.check_cuda(*tensors)
    for t, shape in zip(tensors, shapes):
        if t is not None and t.shape != shape:
            raise ValueError(f"{what}: shape {tuple(t.shape)} != {shape}")


def sketch_query_kernel_sharded(rows, cols, keys, le, key_plane, cw, pw):
    if key_plane.device.type == "cpu":
        return sketch_query_plain(rows, cols, keys, le, key_plane, cw, pw)
    S, _, d, _ = key_plane.shape
    nq, s = rows.shape
    c = pw.shape[-1]
    _check((rows, cols, keys, le, key_plane, cw, pw),
           ((nq, s), (nq, s), (nq, s), (nq,), (S, 2, d, d), (S, 2, d, d),
            (S, 2, d, d, c)), "sketch query")
    out = torch.empty((3, S, nq), dtype=torch.int32, device=key_plane.device)
    build.call("lsk_sketch_query", rows, cols, keys, le, key_plane, cw, pw,
               out[0], out[1], out[2], S, nq, s, d, c)
    sketch_query_kernel_sharded.launches += 1
    return out[0], out[1], out[2]


sketch_query_kernel_sharded.launches = 0


def _horizon_leaves(planes):
    """(key [S, 2, d, d], pool_key [S, Q, 2], cw, pw, pool_cw, pool_pw with
    a leading [H]) of ``QueryPlanes`` (H = 1) or ``MultiPlanes`` (key and
    pool_key from row 0: they do not depend on the horizon)."""
    if planes.cw.dim() == 5:
        return (planes.key[0], planes.pool_key[0], planes.cw, planes.pw,
                planes.pool_cw, planes.pool_pw)
    return (planes.key, planes.pool_key, planes.cw[None], planes.pw[None],
            planes.pool_cw[None], planes.pool_pw[None])


def _edge_plain_rows(cfg, key, pool_key, cw, pw, pool_cw, pool_pw, src, la,
                     dst, lb, le):
    """The plain edge query of one block of shard rows: w, wl [H, S, B]."""
    pa, pb = precompute(cfg, src, la), precompute(cfg, dst, lb)
    pr = edge_probes(cfg, pa, pb)
    le_idx = None if le is None else \
        hsh.edge_label_bucket(le, cfg.c, cfg.seed)
    first, hit, any_stop = _walk_plain(pr.rows, pr.cols, pr.keys, key)
    w, wl = _at_stop(pr.rows, pr.cols, first, hit, le_idx, cw, pw)

    S = key.shape[0]
    ps = hsh.pool_slot_seq(pr.pid_src, pr.pid_dst, cfg.pool_capacity,
                           cfg.pool_probes, cfg.seed).long()  # [B, probes]
    pk = pool_key[:, ps]  # [S, B, probes, 2]
    pmatch = (pk[..., 0] == pr.pid_src[None, :, None]) & \
        (pk[..., 1] == pr.pid_dst[None, :, None])
    pfirst = torch.argmax(pmatch.to(torch.uint8), dim=-1)
    pslot = torch.gather(ps.expand((S,) + ps.shape), -1,
                         pfirst[..., None])[..., 0]  # [S, B]
    s_idx = torch.arange(S, device=ps.device)[:, None]
    sel = ~any_stop & pmatch.any(-1)
    w = w + torch.where(sel, pool_cw[:, s_idx, pslot], 0)
    if le_idx is not None:
        wl_p = pool_pw[:, s_idx, pslot, le_idx.long()[None, :]]
        wl = wl + torch.where(sel, wl_p, 0)
    return w.to(torch.int32), wl.to(torch.int32)


def edge_query_plain(cfg, planes, src, la, dst, lb, le, groups: int = 1):
    leaves = _horizon_leaves(planes)
    S, G = leaves[0].shape[0], groups
    B, per = src.shape[0] // G, S // G
    outs = []
    for g in range(G):  # each block of rows against its own queries
        rows = slice(g * per, (g + 1) * per)
        qs = slice(g * B, (g + 1) * B)
        key, pool_key, *counters = leaves
        outs.append(_edge_plain_rows(
            cfg, key[rows], pool_key[rows], *(x[:, rows] for x in counters),
            src[qs], la[qs], dst[qs], lb[qs], None if le is None else le[qs]))
    return tuple(torch.cat(xs, dim=1) for xs in zip(*outs))


_BLOCKS: dict = {}


def _block_table(cfg, device) -> torch.Tensor:
    """The config's block starts then widths, int32 on ``device``, made
    once per (block layout, device): the lookup runs on every launch. The
    key is what the table holds (``d``, ``n_blocks``, ``block_bounds``),
    so equal configs share one entry and no config object is kept."""
    key = (cfg.d, cfg.n_blocks, cfg.block_bounds, torch.device(device))
    table = _BLOCKS.get(key)
    if table is None:
        table = torch.cat(cfg.block_start_width(device)).contiguous()
        _BLOCKS[key] = table
    return table


def _i32(x: int) -> int:
    """The int32 with ``x``'s low 32 bits (a seed passed as its bits)."""
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def edge_query_kernel(cfg, planes, src, la, dst, lb, le, groups: int = 1):
    if planes.key.device.type == "cpu":
        return edge_query_plain(cfg, planes, src, la, dst, lb, le,
                                groups=groups)
    # no views of the counters: a QueryPlanes' leaves go as they are (H = 1)
    multi = planes.cw.dim() == 5
    key = planes.key[0] if multi else planes.key
    pool_key = planes.pool_key[0] if multi else planes.pool_key
    H = planes.cw.shape[0] if multi else 1
    lead = (H,) if multi else ()
    S, Q = key.shape[0], pool_key.shape[1]
    d, c, B = cfg.d, cfg.c, src.shape[0] // groups
    if groups < 1 or S % groups or B * groups != src.shape[0]:
        raise ValueError(f"edge query: {src.shape[0]} queries and {S} "
                         f"rows do not split into {groups} groups")
    _check((src, la, dst, lb, le, key, planes.cw, planes.pw, pool_key,
            planes.pool_cw, planes.pool_pw),
           ((groups * B,),) * 5 + ((S, 2, d, d), lead + (S, 2, d, d),
                          lead + (S, 2, d, d, c), (S, Q, 2), lead + (S, Q),
                          lead + (S, Q, c)), "edge query")
    if Q != cfg.pool_capacity:
        raise ValueError(f"edge query: pool of {Q} slots, config "
                         f"{cfg.pool_capacity}")
    out = torch.empty((2, H, S, B), dtype=torch.int32, device=key.device)
    build.call("lsk_edge_query", src, la, dst, lb, le,
               _block_table(cfg, key.device), key, planes.cw, planes.pw,
               pool_key, planes.pool_cw, planes.pool_pw, out[0], out[1], H, S,
               B, cfg.s, d, c, Q, cfg.pool_probes, cfg.n_blocks, cfg.F, cfg.r,
               _i32(cfg.seed), groups)
    sketch_query_kernel_sharded.launches += 1
    return out[0], out[1]
