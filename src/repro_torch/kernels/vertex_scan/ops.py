"""Vertex and label aggregates on window-reduced planes (port of
``repro/kernels/vertex_scan/ops.py``: ``vertex_query_planes``,
``label_aggregate_planes`` and the single-sketch drop-in
``vertex_query_pallas``).

Vertex aggregates run the line scan on the kernel, plus the pool lookup.
Label aggregates are a dense masked reduction in plain PyTorch — the
reference has no kernel for them either.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing as hsh
from repro_torch.core.lsketch import precompute
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


def pool_lookup(planes: QueryPlanes, vid, le_idx, direction: str = "out"):
    """The pool's share of a vertex aggregate: every shard's pool entries
    whose endpoint id on the query's side is ``vid``, a dense ``[S, B, Q]``
    match. Returns (w, w_label or None), each [S, B]."""
    col = 0 if direction == "out" else 1
    pm = planes.pool_key[:, :, col][:, None, :] == vid[None, :, None]
    w = _sum32(torch.where(pm, planes.pool_cw[:, None, :], 0), -1)
    if le_idx is None:
        return w, None
    lw = planes.pool_pw[:, :, le_idx.long()].permute(0, 2, 1)  # [S, B, Q]
    return w, _sum32(torch.where(pm, lw, 0), -1)


def vertex_query_planes(cfg: LSketchConfig, planes: QueryPlanes, vertex,
                        labels, direction: str = "out", with_le: bool = True):
    """vertex: int32 [B]; labels: (lv, le). Returns (w, w_label), each
    [S, B] per-shard partials."""
    lv, le = labels
    pre, lines = scan_lines(cfg, vertex, lv)
    le_idx = hsh.edge_label_bucket(le, cfg.c, cfg.seed) if with_le else None
    w, wl = vertex_scan_kernel_sharded(
        lines, pre.f.contiguous(), le_idx, planes.key, planes.cw, planes.pw,
        r=cfg.r, F=cfg.F, direction=direction)
    pw, pwl = pool_lookup(planes, pre.vid, le_idx, direction)
    w = w + pw
    if pwl is not None:
        wl = wl + pwl
    return w.to(torch.int32), wl.to(torch.int32)


def label_aggregate_planes(cfg: LSketchConfig, planes: QueryPlanes, vlabel,
                           edge_label=None, direction: str = "out",
                           with_le: bool = False):
    """Vertex-label aggregates (Alg. 4 lines 10-14): every occupied cell in
    the label's block rows (out) / columns (in) plus matching pool entries.
    Returns (w, w_label) [S, B]. The label plane is reduced one (shard,
    twin) at a time, so no ``pw``-sized temporary is made."""
    vlabel = torch.as_tensor(vlabel).to(torch.int32)
    dev = vlabel.device
    S = planes.cw.shape[0]
    le_idx = hsh.edge_label_bucket(edge_label, cfg.c, cfg.seed).long() \
        if with_le else None
    starts, widths = cfg.block_start_width(dev)
    m = hsh.vertex_label_block(vlabel, cfg.n_blocks, cfg.seed).long()
    rows = torch.arange(cfg.d, dtype=torch.int32, device=dev)
    in_block = (rows[None, :] >= starts[m][:, None]) & (
        rows[None, :] < (starts[m] + widths[m])[:, None])  # [B, d]
    occ = planes.key != EMPTY  # [S, 2, d, d]
    line_dim = 3 if direction == "out" else 2  # the axis summed away
    axis_tot = _sum32(torch.where(occ, planes.cw, 0), (1, line_dim))  # [S, d]
    w = _sum32(torch.where(in_block[None], axis_tot[:, None, :], 0), -1)
    wl = torch.zeros_like(w)
    if with_le:
        per_lbl = torch.zeros((S, cfg.d, cfg.c), dtype=torch.int64,
                              device=dev)
        for s in range(S):
            for tz in range(2):
                per_lbl[s] += torch.where(occ[s, tz, ..., None],
                                          planes.pw[s, tz], 0).sum(
                    line_dim - 2, dtype=torch.int64)
        lw = per_lbl.to(torch.int32)[:, :, le_idx].permute(0, 2, 1)  # [S,B,d]
        wl = _sum32(torch.where(in_block[None], lw, 0), -1)
    col = 0 if direction == "out" else 1
    pcol = planes.pool_key[:, :, col]  # [S, Q]
    pm_blocks, _, _ = hsh.unpack_vertex_id(pcol, cfg.F)
    pmatch = (pcol != EMPTY)[:, None, :] & \
        (pm_blocks[:, None, :] == m[None, :, None])  # [S, B, Q]
    w = w + _sum32(torch.where(pmatch, planes.pool_cw[:, None, :], 0), -1)
    if with_le:
        plw = planes.pool_pw[:, :, le_idx].permute(0, 2, 1)  # [S, B, Q]
        wl = wl + _sum32(torch.where(pmatch, plw, 0), -1)
    return w.to(torch.int32), wl.to(torch.int32)


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
