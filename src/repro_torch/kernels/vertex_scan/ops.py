"""Vertex and label aggregates on window-reduced planes (port of
``repro/kernels/vertex_scan/ops.py``: ``vertex_query_planes``,
``label_aggregate_planes`` and the single-sketch drop-in
``vertex_query_pallas``).

Vertex aggregates run the line scan on the kernel, plus the pool lookup.
Label aggregates are a dense masked reduction in plain PyTorch — the
reference has no kernel for them either.

Every entry takes ``groups=G`` for a pooled stack of tenants
(``sketch.tenant``): the queries are ``[G * Lq]``, group g's ``Lq`` in a
row, and each block of ``S // G`` shard rows answers only its own group's
(the scan through the kernel's grouped entry, the pool and label
reductions as ``[G, S // G, Lq, ...]``), so no row computes another
tenant's queries. The partials come back ``[S, Lq]``.

``vertex_query_planes`` and ``label_aggregate_planes`` take ``group=`` (a
``torch.distributed`` process group, the counterpart of the reference's
``axis_name``): the planes are this rank's block of shard rows and the
answers come back ``[B]``, reduced over the rank's rows and every rank
(``core.merge.maybe_psum_partials``).
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing as hsh
from repro_torch.core.lsketch import precompute
from repro_torch.core.merge import maybe_psum_partials
from repro_torch.core.queries import QueryPlanes, build_query_planes
from repro_torch.core.types import EMPTY, LSketchConfig, LSketchState

from .kernel import vertex_scan_kernel_sharded


def _sum32(x, dim):
    return x.sum(dim=dim, dtype=torch.int64).to(torch.int32)


def scan_lines(cfg: LSketchConfig, vertex, lv):
    """The queries' addressing and their r absolute candidate lines
    ``[B, r]`` int32 (rows for ``out``, columns for ``in``)."""
    pre = precompute(cfg, vertex, lv)
    pos = torch.remainder(pre.s[:, None] + pre.offs, pre.width[:, None])
    return pre, (pre.start[:, None] + pos).to(torch.int32).contiguous()


def pool_lookup(planes: QueryPlanes, vid, le_idx, direction: str = "out",
                groups: int = 1):
    """The pool's share of a vertex aggregate: every shard's pool entries
    whose endpoint id on the query's side is ``vid``, a dense
    ``[G, S / G, Lq, Q]`` match of each block of rows against its group's
    queries. Returns (w, w_label or None), each [S, Lq]."""
    col = 0 if direction == "out" else 1
    S, Q = planes.pool_cw.shape
    G = groups
    per, Lq = S // G, vid.shape[0] // G
    pk = planes.pool_key[:, :, col].view(G, per, 1, Q)
    pm = pk == vid.view(G, 1, Lq, 1)  # [G, per, Lq, Q]
    pcw = planes.pool_cw.view(G, per, 1, Q)
    w = _sum32(torch.where(pm, pcw, 0), -1).view(S, Lq)
    if le_idx is None:
        return w, None
    ppw = planes.pool_pw.view(G, per, Q, -1).transpose(2, 3)  # [G,per,c,Q]
    lw = torch.gather(ppw, 2, le_idx.long().view(G, 1, Lq, 1).expand(
        G, per, Lq, Q))  # [G, per, Lq, Q]
    return w, _sum32(torch.where(pm, lw, 0), -1).view(S, Lq)


def vertex_query_planes(cfg: LSketchConfig, planes: QueryPlanes, vertex,
                        labels, direction: str = "out", with_le: bool = True,
                        groups: int = 1, group=None):
    """vertex: int32 [B] (``[G * Lq]`` with ``groups=G``); labels: (lv,
    le). Returns (w, w_label), each [S, B] (``[S, Lq]``) per-shard
    partials, or [B] reduced over ``group``."""
    lv, le = labels
    pre, lines = scan_lines(cfg, vertex, lv)
    le_idx = hsh.edge_label_bucket(le, cfg.c, cfg.seed) if with_le else None
    return vertex_scan_planes(cfg, planes, lines, pre.f, pre.vid, le_idx,
                              direction, groups, group)


def vertex_scan_planes(cfg: LSketchConfig, planes: QueryPlanes, lines, f,
                       vid, le_idx=None, direction: str = "out",
                       groups: int = 1, group=None):
    """``vertex_query_planes`` past the addressing: the line scan and the
    pool lookup of queries whose lines ``[B, r]``, fingerprints ``f``,
    pool ids ``vid`` and label buckets ``le_idx`` (None: no label) are
    already made, so one addressing can serve several scans. Returns
    what ``vertex_query_planes`` returns."""
    w, wl = vertex_scan_kernel_sharded(
        lines, f.contiguous(), le_idx, planes.key, planes.cw, planes.pw,
        r=cfg.r, F=cfg.F, direction=direction, groups=groups)
    pw, pwl = pool_lookup(planes, vid, le_idx, direction, groups)
    w = w + pw
    if pwl is not None:
        wl = wl + pwl
    return maybe_psum_partials(w.to(torch.int32), wl.to(torch.int32), group)


def label_aggregate_planes(cfg: LSketchConfig, planes: QueryPlanes, vlabel,
                           edge_label=None, direction: str = "out",
                           with_le: bool = False, groups: int = 1,
                           group=None):
    """Vertex-label aggregates (Alg. 4 lines 10-14): every occupied cell in
    the label's block rows (out) / columns (in) plus matching pool entries.
    Returns (w, w_label) [S, B] (``[S, Lq]`` with ``groups``; [B] reduced
    over ``group``). The label
    plane is reduced one (shard, twin) at a time, so no ``pw``-sized
    temporary is made."""
    vlabel = torch.as_tensor(vlabel).to(torch.int32)
    dev = vlabel.device
    S, G = planes.cw.shape[0], groups
    per, Lq = S // G, vlabel.shape[0] // G
    le_idx = hsh.edge_label_bucket(edge_label, cfg.c, cfg.seed).long() \
        if with_le else None
    starts, widths = cfg.block_start_width(dev)
    m = hsh.vertex_label_block(vlabel, cfg.n_blocks, cfg.seed).long()
    rows = torch.arange(cfg.d, dtype=torch.int32, device=dev)
    in_block = ((rows[None, :] >= starts[m][:, None]) & (
        rows[None, :] < (starts[m] + widths[m])[:, None])).view(
            G, 1, Lq, cfg.d)
    occ = planes.key != EMPTY  # [S, 2, d, d]
    line_dim = 3 if direction == "out" else 2  # the axis summed away
    axis_tot = _sum32(torch.where(occ, planes.cw, 0), (1, line_dim))  # [S, d]
    w = _sum32(torch.where(in_block, axis_tot.view(G, per, 1, cfg.d), 0),
               -1).view(S, Lq)
    wl = torch.zeros_like(w)
    if with_le:
        per_lbl = torch.zeros((S, cfg.d, cfg.c), dtype=torch.int64,
                              device=dev)
        for s in range(S):
            for tz in range(2):
                per_lbl[s] += torch.where(occ[s, tz, ..., None],
                                          planes.pw[s, tz], 0).sum(
                    line_dim - 2, dtype=torch.int64)
        lw = torch.gather(  # [G, per, Lq, d]: each row's group's labels
            per_lbl.to(torch.int32).view(G, per, cfg.d, cfg.c).transpose(
                2, 3), 2, le_idx.view(G, 1, Lq, 1).expand(G, per, Lq, cfg.d))
        wl = _sum32(torch.where(in_block, lw, 0), -1).view(S, Lq)
    col = 0 if direction == "out" else 1
    pcol = planes.pool_key[:, :, col]  # [S, Q]
    Q = pcol.shape[1]
    pm_blocks, _, _ = hsh.unpack_vertex_id(pcol, cfg.F)
    pmatch = (pcol != EMPTY).view(G, per, 1, Q) & \
        (pm_blocks.view(G, per, 1, Q) == m.view(G, 1, Lq, 1))
    pcw = planes.pool_cw.view(G, per, 1, Q)
    w = w + _sum32(torch.where(pmatch, pcw, 0), -1).view(S, Lq)
    if with_le:
        plw = torch.gather(planes.pool_pw.view(G, per, Q, -1).transpose(
            2, 3), 2, le_idx.view(G, 1, Lq, 1).expand(G, per, Lq, Q))
        wl = wl + _sum32(torch.where(pmatch, plw, 0), -1).view(S, Lq)
    return maybe_psum_partials(w.to(torch.int32), wl.to(torch.int32), group)


def label_weight_planes(cfg: LSketchConfig, planes: QueryPlanes, vlabel,
                        edge_label, direction: str = "out"):
    """``label_aggregate_planes``' ``w_label`` [S, B] (one sketch, no
    ``groups``) for rows whose vertex and edge labels ``vlabel`` and
    ``edge_label`` are on the host: one masked sum a distinct (block,
    bucket) pair of the rows, over that block's rows (out) / columns (in)
    of that bucket's label plane and the block's pool entries, in place
    of reducing every bucket's plane (int32 sums wrap alike in any
    order)."""
    pairs, pick = torch.unique(torch.stack([
        hsh.vertex_label_block(torch.as_tensor(vlabel), cfg.n_blocks,
                               cfg.seed),
        hsh.edge_label_bucket(torch.as_tensor(edge_label), cfg.c, cfg.seed)],
        1), dim=0, return_inverse=True)
    starts, widths = cfg.block_start_width()
    occ = planes.key != EMPTY  # [S, 2, d, d]
    pcol = planes.pool_key[:, :, 0 if direction == "out" else 1]  # [S, Q]
    pm_blocks, _, _ = hsh.unpack_vertex_id(pcol, cfg.F)
    pocc = pcol != EMPTY
    tot = []
    for m, b in pairs.tolist():
        block = slice(int(starts[m]), int(starts[m] + widths[m]))
        at = (..., block, slice(None)) if direction == "out" else \
            (..., block)
        tot.append(torch.where(occ[at], planes.pw[..., b][at], 0).sum(
            (1, 2, 3), dtype=torch.int64) + torch.where(
                pocc & (pm_blocks == m), planes.pool_pw[..., b], 0).sum(
                    1, dtype=torch.int64))
    return torch.stack(tot, 1).to(torch.int32).index_select(
        1, pick.to(planes.key.device))


def vertex_query_pallas(cfg: LSketchConfig, state: LSketchState, vertex,
                        labels, direction: str = "out",
                        last: int | None = None):
    """Kernel-backed equivalent of ``core.queries.vertex_query`` with the
    edge label (both outputs, int32 [B]) on one plain state: the window
    planes of a ``[1, ...]`` view, then the vertex-scan kernel at S = 1.
    The name is the reference's."""
    dev = state.key.device
    t = lambda x: torch.as_tensor(  # noqa: E731
        x, dtype=torch.int32).to(dev).contiguous()
    planes = build_query_planes(cfg, state.map(lambda x: x.unsqueeze(0)),
                                last)
    w, wl = vertex_query_planes(cfg, planes, t(vertex),
                                tuple(t(x) for x in labels),
                                direction=direction, with_le=True)
    return w[0], wl[0]
