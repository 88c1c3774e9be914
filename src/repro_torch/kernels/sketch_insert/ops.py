"""Binned matrix insert around the insert kernel (port of
``repro/kernels/sketch_insert/ops.py``: ``_bin_plan``, ``_pool_pass``,
``matrix_insert_binned_sharded``).

Pipeline for a shard-stacked, single-subwindow flush, all on the state's
device and in place: stable binning of every shard's edges by their
(row-block, col-block) tile; one call of the insert kernel over every
(shard, bin); one call of the pool-pass kernel over the edges the matrix
rejected, in stream order.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.core.lsketch import EdgeProbes
from repro_torch.core.types import LSketchConfig, LSketchState

from .kernel import pool_pass_kernel_sharded, sketch_insert_kernel_sharded


def _pool_pass(cfg: LSketchConfig, state: LSketchState, slot,
               probes: EdgeProbes, le_idx, weight, failed) -> LSketchState:
    """Additional-pool insertion for the edges the matrix rejected, in
    stream order, every shard at once (``state`` stacked; ``slot`` [S];
    the rest [S, B]), through the pool-pass kernel: no host loop and no
    host read."""
    S, B = failed.shape
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    pool_pass_kernel_sharded(
        i32(probes.pid_src), i32(probes.pid_dst), i32(weight), i32(weight),
        i32(slot[:, None].expand(S, B)), i32(le_idx), i32(failed),
        state.pool_key, state.pool_C, state.pool_P, state.pool_lost,
        probes=cfg.pool_probes, seed=cfg.seed)
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
