"""Window-reduced query planes and the dense reference queries
(port of ``repro.core.queries``: ``QueryPlanes``, ``build_query_planes``,
``MultiPlanes``, ``build_query_planes_multi``, ``edge_query``,
``vertex_query``, ``vertex_label_aggregate``, the by-identity edge check
and successor scan behind reachability, ``successor_scan``,
``path_reachability``, ``subgraph_query``, and the scalar query methods
of ``LSketch``).

The dense queries are the port's ``"scan"`` path and the oracle of the
plane kernels. They take one (unstacked) state. Two rules keep them at
full width on the card: nothing materialises ``P * mask`` (each reduction
accumulates the in-window ring slots one at a time), and the vertex scan
runs over query chunks, because its ``[B, r, d, 2, k]`` gather is about a
megabyte per query at d=2048.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import hashing as hsh
from .lsketch import (LSketch, VertexAddressing, edge_probes, precompute,
                      valid_slot_mask)
from .types import EMPTY, LSketchConfig, LSketchState

_I32 = torch.int32


def _sum32(x, dim) -> torch.Tensor:
    """int32 sum with int32 wrap (torch sums integers in int64)."""
    return x.sum(dim=dim, dtype=torch.int64).to(_I32)


@dataclass
class QueryPlanes:
    """Window-reduced planes of a shard-stacked state.

    key     : [S, 2, d, d]     packed keys, twin-leading (kernel layout)
    cw      : [S, 2, d, d]     sum of C over in-window ring slots
    pw      : [S, 2, d, d, c]  sum of P over in-window ring slots
    pool_key: [S, Q, 2]
    pool_cw : [S, Q]
    pool_pw : [S, Q, c]
    """

    key: torch.Tensor
    cw: torch.Tensor
    pw: torch.Tensor
    pool_key: torch.Tensor
    pool_cw: torch.Tensor
    pool_pw: torch.Tensor


def _masked_slot_sum(x: torch.Tensor, axis: int, mask: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of ``x`` over the slots of ``axis`` that ``mask`` ([k] bool, on
    the host) admits, accumulated one slot at a time into ``out`` (which
    may be a strided view of the caller's output)."""
    if out is None:
        shape = list(x.shape)
        del shape[axis]
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for j in torch.nonzero(mask).flatten().tolist():
        out.add_(x.select(axis, j))
    return out


def build_query_planes(cfg: LSketchConfig, state: LSketchState,
                       last: int | None = None) -> QueryPlanes:
    """Reduce a shard-stacked state to its window-reduced planes.
    ``cur_widx`` must already carry the fleet-global window."""
    S, d = state.key.shape[0], cfg.d
    mask = valid_slot_mask(cfg, state, last).cpu()  # [S, k]
    dev, ct = state.C.device, state.C.dtype
    cw = torch.zeros((S, 2, d, d), dtype=ct, device=dev)
    pw = torch.zeros((S, 2, d, d, cfg.c), dtype=ct, device=dev)
    pool_cw = torch.zeros(state.pool_C.shape[:2], dtype=ct, device=dev)
    pool_pw = torch.zeros(state.pool_C.shape[:2] + (cfg.c,), dtype=ct,
                          device=dev)
    for s in range(S):
        # accumulate straight into the twin-leading outputs through
        # [d, d, 2(, c)] views: no permuted copy of the 2 GiB pw plane
        _masked_slot_sum(state.C[s], 3, mask[s], cw[s].permute(1, 2, 0))
        _masked_slot_sum(state.P[s], 3, mask[s], pw[s].permute(1, 2, 0, 3))
        _masked_slot_sum(state.pool_C[s], 1, mask[s], pool_cw[s])
        _masked_slot_sum(state.pool_P[s], 1, mask[s], pool_pw[s])
    return QueryPlanes(key=state.key.permute(0, 3, 1, 2).contiguous(),
                       cw=cw, pw=pw, pool_key=state.pool_key,
                       pool_cw=pool_cw, pool_pw=pool_pw)


@dataclass
class MultiPlanes(QueryPlanes):
    """Horizon-stacked ``QueryPlanes``: the same six leaves with a leading
    ``[H]`` horizon axis, row ``i`` equal to
    ``build_query_planes(cfg, state, horizons[i])``. ``key`` and
    ``pool_key`` do not depend on the horizon: they are views broadcast
    over ``H`` (no copies)."""


def slice_horizon(planes: MultiPlanes, i: int) -> QueryPlanes:
    """Row ``i`` of a ``MultiPlanes`` as plain ``QueryPlanes`` (views; each
    leaf is contiguous, as the kernels require)."""
    return QueryPlanes(key=planes.key[i], cw=planes.cw[i], pw=planes.pw[i],
                       pool_key=planes.pool_key[i],
                       pool_cw=planes.pool_cw[i], pool_pw=planes.pool_pw[i])


def build_query_planes_multi(cfg: LSketchConfig, state: LSketchState,
                             horizons) -> MultiPlanes:
    """Window-reduce a shard-stacked state for every horizon in one pass
    over the ``k`` ring slots.

    ``horizons`` is a strictly increasing sequence of already-clamped ints.
    A slot is valid for horizon ``h`` iff its age ``cur_widx - slot_widx``
    is ``< h``, so the masks nest: each slot's counters are read once and
    added into the band of the smallest horizon that admits it
    (``searchsorted(horizons, age, right)``; out-of-window slots fall off
    the end), then a running sum over the horizon axis turns band totals
    into per-horizon planes. int32 addition wraps, so the regrouping is
    exact. The outputs are preallocated and filled slot by slot through
    strided views: nothing of size ``P * mask`` or ``[k, ...]`` is made.
    """
    hs = tuple(int(h) for h in horizons)
    if list(hs) != sorted(set(hs)):
        raise ValueError(f"horizons must be strictly increasing, got {hs}")
    H, S, d = len(hs), state.key.shape[0], cfg.d
    age = (state.cur_widx[:, None] - state.slot_widx).cpu()  # [S, k] int32
    band = torch.searchsorted(torch.tensor(hs, dtype=age.dtype),
                              age.contiguous(), right=True)
    dev, ct = state.C.device, state.C.dtype
    Q = state.pool_C.shape[1]
    cw = torch.zeros((H, S, 2, d, d), dtype=ct, device=dev)
    pw = torch.zeros((H, S, 2, d, d, cfg.c), dtype=ct, device=dev)
    pool_cw = torch.zeros((H, S, Q), dtype=ct, device=dev)
    pool_pw = torch.zeros((H, S, Q, cfg.c), dtype=ct, device=dev)
    for s in range(S):
        for b in range(H):
            in_band = band[s] == b
            _masked_slot_sum(state.C[s], 3, in_band, cw[b, s].permute(1, 2, 0))
            _masked_slot_sum(state.P[s], 3, in_band,
                             pw[b, s].permute(1, 2, 0, 3))
            _masked_slot_sum(state.pool_C[s], 1, in_band, pool_cw[b, s])
            _masked_slot_sum(state.pool_P[s], 1, in_band, pool_pw[b, s])
    for b in range(1, H):
        for x in (cw, pw, pool_cw, pool_pw):
            x[b].add_(x[b - 1])
    key = state.key.permute(0, 3, 1, 2).contiguous()
    return MultiPlanes(key=key.expand((H,) + key.shape), cw=cw, pw=pw,
                       pool_key=state.pool_key.expand(
                           (H,) + state.pool_key.shape),
                       pool_cw=pool_cw, pool_pw=pool_pw)


def _first(stop: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none), as
    ``jnp.argmax`` of a boolean array."""
    return torch.argmax(stop.to(torch.uint8), dim=-1)


def _win_weights(C_slots, P_slots, le_idx, mask):
    """GETWEIGHTSINM: C_slots [..., k]; P_slots [..., k, c]; mask [k]."""
    w = _sum32(torch.where(mask, C_slots, 0), -1)
    if le_idx is None:
        return w, torch.zeros_like(w)
    le = le_idx.long()[..., None, None].expand(P_slots.shape[:-1] + (1,))
    pl = torch.gather(P_slots, -1, le)[..., 0]
    return w, _sum32(torch.where(mask, pl, 0), -1)


def edge_query(cfg: LSketchConfig, state: LSketchState, edge_src, edge_dst,
               labels, with_edge_label: bool = False,
               last: int | None = None):
    """Weight of edge (A,B) [optionally restricted to edge label l_e] on
    one state. Returns (w, w_l) int32 [B] (w_l = w without a label)."""
    la, lb, le = labels
    pa = precompute(cfg, edge_src, la)
    pb = precompute(cfg, edge_dst, lb)
    pr = edge_probes(cfg, pa, pb)
    le_idx = hsh.edge_label_bucket(le, cfg.c, cfg.seed) \
        if with_edge_label else None
    mask = valid_slot_mask(cfg, state, last)
    B = pr.rows.shape[0]
    tz2 = torch.arange(2, device=pr.rows.device)
    cur = state.key[pr.rows.long()[..., None], pr.cols.long()[..., None],
                    tz2[None, None, :]]  # [B, s, 2]
    is_match = (cur == pr.keys[..., None]).reshape(B, -1)
    is_empty = (cur == EMPTY).reshape(B, -1)
    stop = is_match | is_empty
    any_stop = stop.any(-1)
    first = _first(stop)
    hit = torch.gather(is_match, 1, first[:, None])[:, 0] & any_stop
    pi, tz = first // 2, first % 2
    rr = torch.gather(pr.rows, 1, pi[:, None])[:, 0].long()
    cc = torch.gather(pr.cols, 1, pi[:, None])[:, 0].long()
    w_m, wl_m = _win_weights(state.C[rr, cc, tz], state.P[rr, cc, tz],
                             le_idx, mask)
    w_m = torch.where(hit, w_m, 0)
    wl_m = torch.where(hit, wl_m, 0)

    go_pool = ~any_stop
    ps = hsh.pool_slot_seq(pr.pid_src, pr.pid_dst, cfg.pool_capacity,
                           cfg.pool_probes, cfg.seed).long()
    pk = state.pool_key[ps]  # [B, probes, 2]
    pmatch = (pk[..., 0] == pr.pid_src[:, None]) & \
        (pk[..., 1] == pr.pid_dst[:, None])
    pany = pmatch.any(-1)
    pslot = torch.gather(ps, 1, _first(pmatch)[:, None])[:, 0]
    w_p, wl_p = _win_weights(state.pool_C[pslot], state.pool_P[pslot],
                             le_idx, mask)
    sel = go_pool & pany
    w = (w_m + torch.where(sel, w_p, 0)).to(_I32)
    wl = (wl_m + torch.where(sel, wl_p, 0)).to(_I32)
    return (w, wl) if with_edge_label else (w, w)


class _RowScan(NamedTuple):
    w: torch.Tensor
    wl: torch.Tensor


def _scan_candidate_lines(cfg, state, pre: VertexAddressing, le_idx, mask,
                          axis: str, chunk: int | None = None):
    """Sum weights over all cells in v's r candidate rows (axis='out') or
    columns (axis='in') whose stored index+fingerprint match v. Runs over
    chunks of queries; the label plane is gathered at the query's own
    label only (never the whole ``c`` axis)."""
    pos = torch.remainder(pre.s[:, None] + pre.offs, pre.width[:, None])
    lines = (pre.start[:, None] + pos).long()  # [B, r]
    B, r, d = lines.shape[0], cfg.r, cfg.d
    k = state.C.shape[-1]
    if chunk is None:
        chunk = max(1, (1 << 28) // (r * d * 2 * k * 4))
    dev = lines.device
    jj = torch.arange(d, device=dev)[None, None, :, None]
    tz = torch.arange(2, device=dev)[None, None, None, :]
    want_i = torch.arange(r, dtype=_I32, device=dev)[None, :, None, None]
    ws, wls = [], []
    for a in range(0, B, chunk):
        ll = lines[a:a + chunk][:, :, None, None]
        ij = (ll, jj) if axis == "out" else (jj, ll)
        keys = state.key[ij[0], ij[1], tz]  # [b, r, d, 2]
        ia, ib, fa, fb = hsh.unpack_key(keys, cfg.F)
        idx, fp = (ia, fa) if axis == "out" else (ib, fb)
        match = (keys != EMPTY) & (idx == want_i) & \
            (fp == pre.f[a:a + chunk, None, None, None])
        Cs = state.C[ij[0], ij[1], tz]  # [b, r, d, 2, k]
        tot = _sum32(torch.where(mask, Cs, 0), -1)
        ws.append(_sum32(torch.where(match, tot, 0), (1, 2, 3)))
        if le_idx is not None:
            le = le_idx[a:a + chunk].long()[:, None, None, None, None]
            kk = torch.arange(k, device=dev)
            Pl = state.P[ij[0][..., None], ij[1][..., None], tz[..., None],
                         kk, le]  # [b, r, d, 2, k]
            ptot = _sum32(torch.where(mask, Pl, 0), -1)
            wls.append(_sum32(torch.where(match, ptot, 0), (1, 2, 3)))
    w = torch.cat(ws)
    return _RowScan(w, torch.cat(wls) if le_idx is not None
                    else torch.zeros_like(w))


def _pool_vertex_scan(cfg, state, pre: VertexAddressing, le_idx, mask,
                      axis: str):
    """Pool contribution to a vertex query: match the stored endpoint id."""
    col = 0 if axis == "out" else 1
    pm = state.pool_key[:, col][None, :] == pre.vid[:, None]  # [B, Q]
    tot = _sum32(torch.where(mask, state.pool_C, 0), -1)  # [Q]
    w = _sum32(torch.where(pm, tot[None, :], 0), -1)
    if le_idx is None:
        return _RowScan(w, torch.zeros_like(w))
    plw = _masked_slot_sum(state.pool_P, 1, mask.cpu())  # [Q, c]
    lw = plw[:, le_idx.long()].T  # [B, Q]
    return _RowScan(w, _sum32(torch.where(pm, lw, 0), -1))


def vertex_query(cfg: LSketchConfig, state: LSketchState, vertex, labels,
                 direction: str = "out", with_edge_label: bool = False,
                 last: int | None = None, chunk: int | None = None):
    """Outgoing/incoming edge-weight of a vertex on one state (paper Alg.
    4, lines 2-9). Returns (w, w_l) int32 [B]."""
    lv, le = labels
    pre = precompute(cfg, vertex, lv)
    le_idx = hsh.edge_label_bucket(le, cfg.c, cfg.seed) \
        if with_edge_label else None
    mask = valid_slot_mask(cfg, state, last)
    m = _scan_candidate_lines(cfg, state, pre, le_idx, mask, direction,
                              chunk)
    p = _pool_vertex_scan(cfg, state, pre, le_idx, mask, direction)
    w, wl = (m.w + p.w).to(_I32), (m.wl + p.wl).to(_I32)
    return (w, wl) if with_edge_label else (w, w)


def vertex_label_aggregate(cfg: LSketchConfig, state: LSketchState, vlabel,
                           direction: str = "out",
                           with_edge_label: bool = False,
                           last: int | None = None, edge_label=None):
    """Aggregate weight of all vertices with label lA on one state (Alg. 4
    lines 10-14): every occupied cell in the label's block rows (out) /
    columns (in), plus pool entries whose endpoint block matches."""
    vlabel = torch.as_tensor(vlabel).to(_I32)
    dev = vlabel.device
    starts, widths = cfg.block_start_width(dev)
    m = hsh.vertex_label_block(vlabel, cfg.n_blocks, cfg.seed).long()
    mask = valid_slot_mask(cfg, state, last)
    mask_h = mask.cpu()
    rows = torch.arange(cfg.d, dtype=_I32, device=dev)
    in_block = (rows[None, :] >= starts[m][:, None]) & (
        rows[None, :] < (starts[m] + widths[m])[:, None])  # [B, d]
    occ = state.key != EMPTY  # [d, d, 2]
    sum_dims = (1, 2) if direction == "out" else (0, 2)
    cell_tot = _masked_slot_sum(state.C, 3, mask_h).masked_fill_(~occ, 0)
    axis_tot = _sum32(cell_tot, sum_dims)  # [d]
    w = _sum32(torch.where(in_block, axis_tot[None, :], 0), -1)
    wl = w
    if with_edge_label:
        le_idx = hsh.edge_label_bucket(edge_label, cfg.c, cfg.seed).long()
        Pc = _masked_slot_sum(state.P, 3, mask_h).masked_fill_(
            ~occ[..., None], 0)  # [d, d, 2, c]
        per_lbl = _sum32(Pc, sum_dims)  # [d, c]
        del Pc
        lw = per_lbl[:, le_idx].T  # [B, d]
        wl = _sum32(torch.where(in_block, lw, 0), -1)
    col = 0 if direction == "out" else 1
    pm_blocks, _, _ = hsh.unpack_vertex_id(state.pool_key[:, col], cfg.F)
    pocc = state.pool_key[:, col] != EMPTY
    pmatch = pocc[None, :] & (pm_blocks[None, :] == m[:, None])
    ptot = _sum32(torch.where(mask, state.pool_C, 0), -1)
    w = (w + _sum32(torch.where(pmatch, ptot[None, :], 0), -1)).to(_I32)
    if with_edge_label:
        plw = _masked_slot_sum(state.pool_P, 1, mask_h)  # [Q, c]
        lw = plw[:, le_idx].T  # [B, Q]
        wl = (wl + _sum32(torch.where(pmatch, lw, 0), -1)).to(_I32)
    return w, wl


def _vid_addressing(cfg: LSketchConfig, vids) -> VertexAddressing:
    """Algorithm 1's addressing of packed (m, s, f) identities."""
    m, s, f = hsh.unpack_vertex_id(vids, cfg.F)
    starts, widths = cfg.block_start_width(vids.device)
    m = m.long()
    return VertexAddressing(m, starts[m], widths[m], s, f,
                            hsh.candidate_offsets(f, cfg.r), vids)


def _edge_exists_by_vid(cfg: LSketchConfig, state: LSketchState, vid_pairs,
                        last: int | None = None) -> torch.Tensor:
    """bool [B]: the edge between packed identities ``vid_pairs`` [B, 2]
    holds weight > 0 in the window on one state (matrix cell or pool)."""
    mask = valid_slot_mask(cfg, state, last)
    va, vb = vid_pairs[:, 0], vid_pairs[:, 1]
    pr = edge_probes(cfg, _vid_addressing(cfg, va), _vid_addressing(cfg, vb))
    B = va.shape[0]
    tz2 = torch.arange(2, device=va.device)
    cur = state.key[pr.rows.long()[..., None], pr.cols.long()[..., None],
                    tz2[None, None, :]]
    is_match = (cur == pr.keys[..., None]).reshape(B, -1)
    stop = is_match | (cur == EMPTY).reshape(B, -1)
    first = _first(stop)
    hit = torch.gather(is_match, 1, first[:, None])[:, 0] & stop.any(-1)
    pi, tz = first // 2, first % 2
    rr = torch.gather(pr.rows, 1, pi[:, None])[:, 0].long()
    cc = torch.gather(pr.cols, 1, pi[:, None])[:, 0].long()
    wm = _sum32(torch.where(mask, state.C[rr, cc, tz], 0), -1)
    ok_m = hit & (wm > 0)
    ps = hsh.pool_slot_seq(va, vb, cfg.pool_capacity, cfg.pool_probes,
                           cfg.seed).long()
    pk = state.pool_key[ps]
    pmatch = (pk[..., 0] == va[:, None]) & (pk[..., 1] == vb[:, None])
    pw = _sum32(torch.where(mask, state.pool_C[ps], 0), -1)
    ok_p = ~stop.any(-1) & (pmatch & (pw > 0)).any(-1)
    return ok_m | ok_p


def _successors_by_vid(cfg: LSketchConfig, state: LSketchState, vids,
                       last: int | None = None):
    """Successor identities of packed identities ``vids`` [U] on one
    state: (vids [U, r*d*2 + Q], valid mask) — matrix successors decoded
    from their column by key reversibility, then pool successors. The
    gather is ``[U, r, d, 2, k]`` (about a megabyte per vertex at d=2048):
    callers run large frontiers in chunks."""
    pre = _vid_addressing(cfg, vids)
    mask = valid_slot_mask(cfg, state, last)
    pos = torch.remainder(pre.s[:, None] + pre.offs, pre.width[:, None])
    lines = (pre.start[:, None] + pos).long()  # [U, r]
    keys = state.key[lines]  # [U, r, d, 2]
    ia, ib, fa, fb = hsh.unpack_key(keys, cfg.F)
    want_i = torch.arange(cfg.r, dtype=_I32, device=vids.device)
    live = _sum32(torch.where(mask, state.C[lines], 0), -1) > 0
    match = (keys != EMPTY) & (ia == want_i[None, :, None, None]) & \
        (fa == pre.f[:, None, None, None]) & live
    starts, widths = cfg.block_start_width(vids.device)
    cols = torch.arange(cfg.d, dtype=_I32, device=vids.device)
    vid = hsh.decode_line_vid(cols[None, None, :, None], ib, fb, starts,
                              widths, cfg.r, cfg.F)
    U = vids.shape[0]
    pm = state.pool_key[:, 0][None, :] == vids[:, None]
    plive = _sum32(torch.where(mask, state.pool_C, 0), -1) > 0
    vids_p = state.pool_key[:, 1][None, :].expand(pm.shape)
    return (torch.cat([vid.reshape(U, -1), vids_p], -1),
            torch.cat([match.reshape(U, -1), pm & plive[None, :]], -1))


# --------------------------------------------------------------------------
# successor scan, path reachability, subgraph queries (paper Alg. 6, 7)
# --------------------------------------------------------------------------

# frontier vertices per successor scan: its [U, r, d, 2, k] gather stays
# near 256 MiB at any width
_SCAN_BYTES = 1 << 28


def successor_scan(cfg: LSketchConfig, state: LSketchState, vertex, vlabel):
    """All successor identities of ``vertex`` recoverable from one state by
    key reversibility: (vids [B, r*d*2 + Q], valid mask), over the whole
    window."""
    pre = precompute(cfg, vertex, vlabel)
    return _successors_by_vid(cfg, state, pre.vid)


def _successors(cfg, state, frontier) -> np.ndarray:
    """Unique successor identities of packed identities ``frontier`` (a
    host list), the scan run in chunks of ``_SCAN_BYTES``."""
    dev = state.key.device
    k = state.C.shape[-1]
    chunk = max(1, _SCAN_BYTES // (cfg.r * cfg.d * 2 * k * 4))
    out = []
    for a in range(0, len(frontier), chunk):
        vids, valid = _successors_by_vid(cfg, state, torch.tensor(
            frontier[a:a + chunk], dtype=_I32, device=dev))
        out.append(vids[valid].cpu().numpy())
    return np.unique(np.concatenate(out))


def path_reachability(cfg: LSketchConfig, state: LSketchState, src,
                      src_label, dst, dst_label, max_hops: int = 64) -> bool:
    """BFS reachability src -> dst over one state (paper Alg. 6): a host
    frontier loop, each hop one batched direct-edge check and one
    successor scan of the frontier. Identities are packed (m, s, f), so
    the visited set is exact at sketch resolution."""
    dev = state.key.device
    one = lambda x: torch.tensor([int(x)], dtype=_I32, device=dev)  # noqa
    start = int(precompute(cfg, one(src), one(src_label)).vid[0])
    target = int(precompute(cfg, one(dst), one(dst_label)).vid[0])
    frontier, visited = [start], {start}
    for _ in range(max_hops):
        if not frontier:
            return False
        pairs = torch.tensor([[v, target] for v in frontier], dtype=_I32,
                             device=dev)
        if bool(_edge_exists_by_vid(cfg, state, pairs).any()):
            return True
        frontier = [int(v) for v in _successors(cfg, state, frontier)
                    if int(v) not in visited]
        visited.update(frontier)
    return False


def subgraph_query(cfg: LSketchConfig, state: LSketchState, edges,
                   with_edge_label: bool = False,
                   last: int | None = None) -> int:
    """The minimum of the per-edge weights of ``edges`` (paper Alg. 7; a 0
    short-circuits): a list of (src, lA, dst, lB[, le]) tuples."""
    dev = state.key.device
    col = lambda i: torch.tensor(  # noqa: E731
        [e[i] if len(e) > i else 0 for e in edges], dtype=_I32, device=dev)
    w, wl = edge_query(cfg, state, col(0), col(2), (col(1), col(3), col(4)),
                       with_edge_label=with_edge_label, last=last)
    return int((wl if with_edge_label else w).min())


# --------------------------------------------------------------------------
# the scalar methods of LSketch: length-1 (or pass-through array) wrappers
# over the batched frontend ``engine.query_batch``
# --------------------------------------------------------------------------

def _edge_weight(self: LSketch, a, la, b, lb, le=None, last=None):
    from repro_torch.engine import query_batch as qb
    out = qb.edge_weight_batch(self, a, la, b, lb, edge_label=le, last=last,
                               path=getattr(self, "query_path", "auto"))
    return qb.scalarize(out, np.ndim(a) == 0)


def _vertex_weight(self: LSketch, v, lv, le=None, direction="out",
                   last=None):
    from repro_torch.engine import query_batch as qb
    out = qb.vertex_weight_batch(self, v, lv, edge_label=le,
                                 direction=direction, last=last,
                                 path=getattr(self, "query_path", "auto"))
    return qb.scalarize(out, np.ndim(v) == 0)


def _label_aggregate(self: LSketch, lv, le=None, direction="out",
                     last=None):
    from repro_torch.engine import query_batch as qb
    out = qb.label_aggregate_batch(self, lv, edge_label=le,
                                   direction=direction, last=last,
                                   path=getattr(self, "query_path", "auto"))
    return qb.scalarize(out, np.ndim(lv) == 0)


def _reachable(self: LSketch, a, la, b, lb, max_hops=64):
    return path_reachability(self.cfg, self.state, a, la, b, lb, max_hops)


def _subgraph(self: LSketch, edges, with_edge_label=False, last=None):
    return subgraph_query(self.cfg, self.state, edges, with_edge_label, last)


LSketch.edge_weight = _edge_weight
LSketch.vertex_weight = _vertex_weight
LSketch.label_aggregate = _label_aggregate
LSketch.reachable = _reachable
LSketch.subgraph_count = _subgraph
