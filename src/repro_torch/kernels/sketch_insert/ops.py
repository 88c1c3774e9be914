"""Binned matrix insert around the insert kernel (port of
``repro/kernels/sketch_insert/ops.py``: ``_bin_plan``, ``_pool_pass``,
``matrix_insert_binned_sharded``, and the single-sketch entries
``matrix_insert_binned`` and ``insert_window_batch_pallas``).

Pipeline for a shard-stacked, single-subwindow flush, all on the state's
device and in place: stable binning of every shard's edges by their
(row-block, col-block) tile; one call of the insert kernel over every
(shard, bin); one call of the pool-pass kernel over the edges the matrix
rejected, in stream order. The single-sketch entries take a plain
(unstacked) state and run the same pipeline at S = 1 on ``[1, ...]``
views of its tensors: no plane is copied.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing as hsh
from repro_torch.core.lsketch import (EdgeProbes, advance_window, edge_probes,
                                      precompute)
from repro_torch.core.types import EdgeBatch, LSketchConfig, LSketchState
from repro_torch.telemetry.spans import span

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
    with span("lsketch.bin_plan"):
        _, _, order, counts, offs = _bin_plan(cfg, probes, weight)
    with span("lsketch.insert_kernel"):
        inserted = sketch_insert_kernel_sharded(
            probes.rows.contiguous(), probes.cols.contiguous(),
            probes.keys.contiguous(), weight,
            le_idx.to(torch.int32).contiguous(),
            slot.to(torch.int32).contiguous(), order, offs, counts,
            state.key, state.C, state.P, max_bin)
    failed = (~inserted) & (weight > 0)
    with span("lsketch.pool_pass"):
        return _pool_pass(cfg, state, slot, probes, le_idx, weight, failed)


def _lift(x: torch.Tensor) -> torch.Tensor:
    """A ``[1, ...]`` view (a contiguous tensor stays contiguous, so the
    kernels' raw pointers address the plain state's own storage)."""
    return x.unsqueeze(0)


def matrix_insert_binned(cfg: LSketchConfig, state: LSketchState,
                         probes: EdgeProbes, le_idx, weight, slot,
                         max_bin: int | None = None) -> LSketchState:
    """Block-binned insertion of a pre-addressed ``[B]`` batch into one
    plain state's ring ``slot``, in place: the sharded pipeline at S = 1
    on views. ``weight`` must already carry the window-liveness and
    padding masks (zero-weight rows insert nothing and claim nothing)."""
    lifted = state.map(_lift)
    matrix_insert_binned_sharded(
        cfg, lifted, EdgeProbes(*[_lift(p) for p in probes]),
        _lift(le_idx), _lift(weight),
        torch.as_tensor(slot, device=le_idx.device).reshape(1),
        max_bin=max_bin)
    return state


def insert_window_batch_pallas(cfg: LSketchConfig, state: LSketchState,
                               batch: EdgeBatch, widx,
                               max_bin: int | None = None) -> LSketchState:
    """Drop-in for ``core.lsketch.insert_window_batch`` (a batch that all
    belongs to subwindow ``widx``) through the insert and pool kernels at
    one shard, in place; the name is the reference's."""
    dev = state.key.device
    col = lambda f: torch.from_numpy(  # noqa: E731
        np.asarray(getattr(batch, f), np.int32)).to(dev)
    pa = precompute(cfg, col("src"), col("src_label"))
    pb = precompute(cfg, col("dst"), col("dst_label"))
    probes = edge_probes(cfg, pa, pb)
    le_idx = hsh.edge_label_bucket(col("edge_label"), cfg.c, cfg.seed)
    state, slot, live = advance_window(cfg, state, int(widx))
    weight = col("weight").to(state.C.dtype) * live.to(state.C.dtype)
    return matrix_insert_binned(cfg, state, probes, le_idx, weight, slot,
                                max_bin=max_bin)
