"""Batched edge queries on window-reduced planes (port of
``repro/kernels/sketch_query/ops.py::edge_query_planes``): the probe walk
on the kernel, then the vectorized pool lookup for the queries whose every
probe cell was occupied by another key."""

from __future__ import annotations

import torch

from repro_torch.core import hashing as hsh
from repro_torch.core.lsketch import edge_probes, precompute
from repro_torch.core.queries import QueryPlanes
from repro_torch.core.types import LSketchConfig

from .kernel import sketch_query_kernel_sharded


def edge_query_planes(cfg: LSketchConfig, planes: QueryPlanes, src, dst,
                      labels, with_le: bool = True):
    """src/dst: int32 [B]; labels: (lA, lB, le) int32 [B] each (``le`` is
    ignored without ``with_le``). Returns (w, w_label), each [S, B]
    per-shard partials; the caller sums over the shard axis."""
    la, lb, le = labels
    pa = precompute(cfg, src, la)
    pb = precompute(cfg, dst, lb)
    pr = edge_probes(cfg, pa, pb)
    le_idx = hsh.edge_label_bucket(le, cfg.c, cfg.seed) if with_le else None
    S = planes.cw.shape[0]
    w, wl, go_pool = sketch_query_kernel_sharded(
        pr.rows.contiguous(), pr.cols.contiguous(), pr.keys.contiguous(),
        le_idx, planes.key, planes.cw, planes.pw)

    ps = hsh.pool_slot_seq(pr.pid_src, pr.pid_dst, cfg.pool_capacity,
                           cfg.pool_probes, cfg.seed).long()  # [B, probes]
    pk = planes.pool_key[:, ps]  # [S, B, probes, 2]
    pmatch = (pk[..., 0] == pr.pid_src[None, :, None]) & \
        (pk[..., 1] == pr.pid_dst[None, :, None])
    pany = pmatch.any(-1)  # [S, B]
    pfirst = torch.argmax(pmatch.to(torch.uint8), dim=-1)
    pslot = torch.gather(ps.expand((S,) + ps.shape), -1,
                         pfirst[..., None])[..., 0]  # [S, B]
    s_idx = torch.arange(S, device=ps.device)[:, None]
    sel = go_pool & pany
    w = w + torch.where(sel, planes.pool_cw[s_idx, pslot], 0)
    if le_idx is not None:
        wl_p = planes.pool_pw[s_idx, pslot, le_idx.long()[None, :]]
        wl = wl + torch.where(sel, wl_p, 0)
    return w.to(torch.int32), wl.to(torch.int32)
