"""Binned matrix insert around the insert kernel (port of
``repro/kernels/sketch_insert/ops.py``: ``_bin_plan``, ``_pool_pass``,
``matrix_insert_binned_sharded``).

Pipeline for a shard-stacked, single-subwindow flush, all on the state's
device and in place: stable binning of every shard's edges by their
(row-block, col-block) tile; one launch of the insert kernel over every
(shard, bin); a stream-order pool pass over the edges the matrix rejected.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.core import hashing as hsh
from repro_torch.core.lsketch import EdgeProbes
from repro_torch.core.types import EMPTY, LSketchConfig, LSketchState

from .kernel import sketch_insert_kernel_sharded


def _first(ok: torch.Tensor) -> torch.Tensor:
    return torch.argmax(ok.to(torch.uint8), dim=-1)


def _pool_step(state: LSketchState, sidx, ps, pid_s, pid_d, w_count, w_key,
               sl, le, eligible) -> None:
    """One stream-order item of the additional pool, every shard at once
    and in place (``ps`` [S, probes], the rest [S]): an ``eligible`` item
    with ``w_key`` > 0 claims the first of its pool slots that holds its
    key or is EMPTY and adds ``w_count`` there at ring slot ``sl`` and
    label ``le``; with no such slot its ``w_key`` goes to ``pool_lost``.
    Both insert routes walk their pool items through this one step."""
    pk = state.pool_key[sidx[:, None], ps]  # [S, probes, 2]
    pmatch = (pk[..., 0] == pid_s[:, None]) & (pk[..., 1] == pid_d[:, None])
    pok = pmatch | (pk[..., 0] == EMPTY)
    pany = pok.any(1)
    pfound = pany & eligible & (w_key > 0)
    pslot = torch.gather(ps, 1, _first(pok)[:, None])[:, 0]
    pold = state.pool_key[sidx, pslot]  # [S, 2]
    state.pool_key[sidx, pslot, 0] = torch.where(pfound, pid_s, pold[:, 0])
    state.pool_key[sidx, pslot, 1] = torch.where(pfound, pid_d, pold[:, 1])
    pw = torch.where(pfound, w_count, 0)
    state.pool_C[sidx, pslot, sl] += pw
    state.pool_P[sidx, pslot, sl, le] += pw
    state.pool_lost += torch.where(eligible & ~pany, w_key, 0)


def _pool_pass(cfg: LSketchConfig, state: LSketchState, slot,
               probes: EdgeProbes, le_idx, weight, failed) -> LSketchState:
    """Additional-pool insertion for the edges the matrix rejected, in
    stream order, every shard at once (``state`` stacked; ``slot`` [S];
    the rest [S, B]). A stable sort puts each shard's failed edges first;
    step ``t`` handles the ``t``-th failed edge of every shard, and a step
    past a shard's last one is a no-op (it is not eligible)."""
    S = failed.shape[0]
    n_failed = int(failed.sum(1).max()) if failed.numel() else 0
    if n_failed == 0:
        return state
    dev = failed.device
    order = torch.argsort((~failed).to(torch.uint8), dim=1, stable=True)
    pool_slots = hsh.pool_slot_seq(probes.pid_src, probes.pid_dst,
                                   cfg.pool_capacity, cfg.pool_probes,
                                   cfg.seed).long()  # [S, B, probes]
    sidx = torch.arange(S, device=dev)
    sl = slot.long()
    for t in range(n_failed):
        i = order[:, t]
        w = weight[sidx, i]
        _pool_step(state, sidx, pool_slots[sidx, i], probes.pid_src[sidx, i],
                   probes.pid_dst[sidx, i], w, w, sl, le_idx[sidx, i].long(),
                   failed[sidx, i])
    return state


def _bin_plan(cfg: LSketchConfig, probes: EdgeProbes, weight):
    """The one stable binning rule, over a leading shard axis: per-edge
    block id (probe 0 decides — all ``s`` probes share a tile), zero-weight
    rows routed to a virtual one-past-last bin, stable sort order, per-bin
    fills and start offsets. Returns ``(bid0, bid, order, counts, offs)``,
    each ``[S, ...]`` int32."""
    n, b = cfg.n_blocks, cfg.b
    rows0, cols0 = probes.rows[..., 0], probes.cols[..., 0]
    bid0 = torch.div(rows0, b, rounding_mode="floor") * n + \
        torch.div(cols0, b, rounding_mode="floor")
    bid = torch.where(weight > 0, bid0, n * n).to(torch.int32)
    order = torch.argsort(bid, dim=-1, stable=True).to(torch.int32)
    S = bid.shape[0]
    counts = torch.zeros((S, n * n + 1), dtype=torch.int32, device=bid.device)
    counts.scatter_add_(1, bid.long(), torch.ones_like(bid))
    counts = counts[:, :n * n].contiguous()  # dead rows drop out
    offs = (torch.cumsum(counts, 1) - counts).to(torch.int32)
    return bid0.to(torch.int32), bid, order, counts, offs


def matrix_insert_binned_sharded(cfg: LSketchConfig, state: LSketchState,
                                 probes: EdgeProbes, le_idx, weight, slot,
                                 max_bin: int | None = None) -> LSketchState:
    """Block-binned insertion of a pre-addressed ``[S, B]`` flush into each
    shard's ring ``slot`` [S], in place. ``weight`` must already carry the
    window-liveness and padding masks (zero-weight rows insert nothing and
    claim nothing). ``max_bin`` caps each bin's walk; the overflow edges go
    to the pool, as the TPU kernel's truncated bins do."""
    if cfg.block_bounds is not None:
        raise ValueError("the binned insert supports uniform blocking only")
    S, B = probes.rows.shape[:2]
    max_bin = B if max_bin is None else max_bin
    weight = weight.to(torch.int32).contiguous()
    with record_function("lsketch.bin_plan"):
        _, _, order, counts, offs = _bin_plan(cfg, probes, weight)
    with record_function("lsketch.insert_kernel"):
        inserted = sketch_insert_kernel_sharded(
            probes.rows.contiguous(), probes.cols.contiguous(),
            probes.keys.contiguous(), weight,
            le_idx.to(torch.int32).contiguous(),
            slot.to(torch.int32).contiguous(), order, offs, counts,
            state.key, state.C, state.P, max_bin)
    failed = (~inserted) & (weight > 0)
    with record_function("lsketch.pool_pass"):
        return _pool_pass(cfg, state, slot, probes, le_idx, weight, failed)
