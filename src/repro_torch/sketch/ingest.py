"""Hash-partitioned sharded ingest (port of ``repro.sketch.ingest``:
``_shard_bucket``, ``_partition_stack``, ``ingest``, ``_degenerate_batch``,
``_ingest_stacked_lgs``, ``ingest_single``).

``ingest(spec, state, batch)``:
  1. the host partitions the time-ordered batch by the shard hash of its
     source endpoint (numpy, stable, so every shard's rows stay in stream
     order) and pads every shard's row to one bucketed length
     (replicate-last, masked by a per-shard ``n_valid``);
  2. one stacked insert (``engine.insert.insert_stacked_fused_impl``)
     updates the handle's tensors in place — the CUDA kernel route for a
     single-subwindow flush on ``path="cuda"``, the stream-order scan
     otherwise.

The call returns a new handle over the updated tensors and marks the input
handle spent (see ``sketch/state.py``): its plane cache dies with it.
A ``gss`` batch loses its labels and times first (``_degenerate_batch``);
an ``lgs`` flush is a count-min scatter-add per shard.

``ingest_single`` is the unstacked one-shard path the objects (``LSketch``,
``GSS``, ``LGS``) ride: no partition, the engine's path choice on the
plain state, in place.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lgs import lgs_insert_impl
from repro_torch.core.types import EdgeBatch
from repro_torch.engine import insert as eng_insert
from repro_torch.engine.window import pad_to_bucket

from .spec import SketchSpec, shard_assignment
from .state import ShardedState

_FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
           "time")


class StackedBatch:
    """int32 ``[n_shards, L]`` tensors, one per ``EdgeBatch`` field."""

    def __init__(self, **cols):
        for f in _FIELDS:
            setattr(self, f, cols[f])


def _degenerate_batch(batch: EdgeBatch) -> EdgeBatch:
    """GSS ignores labels and timestamps: normalize them away."""
    z = np.zeros(len(batch), np.int32)
    return EdgeBatch(src=batch.src, dst=batch.dst, src_label=z, dst_label=z,
                     edge_label=z, weight=batch.weight, time=z)


def ingest_single(spec: SketchSpec, state, batch: EdgeBatch,
                  path: str = "auto"):
    """Insert a batch into one plain (unstacked) state, in place; returns
    it. The path the objects ride: the engine's path choice for lsketch
    and gss, the count-min insert (bucket-padded, inert pad weights) for
    lgs."""
    n = len(batch)
    if n == 0:
        return state
    if spec.kind == "gss":
        batch = _degenerate_batch(batch)
    if spec.kind == "lgs":
        dev = state.C.device
        cols = [pad_to_bucket(np.asarray(getattr(batch, f), np.int32))
                for f in _FIELDS]
        cols[5] = cols[5].copy()
        cols[5][n:] = 0  # padded weights are inert
        t = [torch.from_numpy(np.ascontiguousarray(c)).to(dev)
             for c in cols]
        return lgs_insert_impl(spec.config, state, *t)
    return eng_insert.insert_batch(spec.config, state, batch, path=path)


def _shard_bucket(n: int, floor: int = 64) -> int:
    """Per-shard row-length bucket: powers of two plus the 1.5x midpoints
    (64, 96, 128, 192, 256, ...)."""
    b = floor
    while b < n:
        if n <= b + b // 2:
            return b + b // 2
        b *= 2
    return b


def _partition_stack(spec: SketchSpec, batch: EdgeBatch):
    """Host-side stable hash partition -> (dict of int32 ``[n_shards, L]``
    numpy arrays, n_valid int32 ``[n_shards]``)."""
    fields = {f: np.asarray(getattr(batch, f), np.int32) for f in _FIELDS}
    sid = shard_assignment(spec, fields["src"], fields["src_label"])
    n_sh = spec.n_shards
    index = [np.flatnonzero(sid == s) for s in range(n_sh)]
    counts = np.array([len(ix) for ix in index], np.int32)
    L = _shard_bucket(max(int(counts.max()), 1), floor=64)
    out = {f: np.zeros((n_sh, L), np.int32) for f in _FIELDS}
    for s, ix in enumerate(index):
        m = len(ix)
        if m == 0:
            continue  # all-zero row, fully masked by n_valid == 0
        for f in _FIELDS:
            row = out[f][s]
            row[:m] = fields[f][ix]
            row[m:] = row[m - 1]  # replicate-last keeps time non-decreasing
    return out, counts


def _ingest_stacked_lgs(cfg, shards, batch: StackedBatch, n_valid) -> None:
    """Each shard's row of an ``[S, L]`` flush into its LGS, in place; rows
    at or past ``n_valid`` are padding (no weight, no ring claim)."""
    L = batch.src.shape[1]
    for s in range(batch.src.shape[0]):
        valid = torch.arange(L, device=batch.src.device) < int(n_valid[s])
        lgs_insert_impl(cfg, shards.map(lambda x: x[s]), batch.src[s],
                        batch.dst[s], batch.src_label[s], batch.dst_label[s],
                        batch.edge_label[s],
                        batch.weight[s] * valid.to(torch.int32),
                        batch.time[s], valid=valid)


def ingest(spec: SketchSpec, state: ShardedState, batch: EdgeBatch,
           path: str = "auto") -> ShardedState:
    """Insert a time-ordered batch into a sharded handle, in place; returns
    the new handle and marks ``state`` spent. ``path``: "auto" (the kernel
    route on a CUDA state, the scan on a CPU state), "scan" or "cuda"
    (lgs has one route and ignores it)."""
    shards = state.live()
    if len(batch) == 0:
        return state
    dev = state.device
    if spec.kind == "gss":
        batch = _degenerate_batch(batch)
    cols, counts = _partition_stack(spec, batch)
    stacked = StackedBatch(**{f: torch.from_numpy(cols[f]).to(dev)
                              for f in _FIELDS})
    if spec.kind == "lgs":
        _ingest_stacked_lgs(spec.config, shards, stacked, counts)
    else:
        path = eng_insert.resolve_path(spec.config, path, dev)
        if path == "chunked":
            raise ValueError("the stacked ingest has no chunked path")
        n_valid = torch.from_numpy(counts).to(dev)
        eng_insert.insert_stacked_fused_impl(spec.config, shards, stacked,
                                             n_valid,
                                             use_kernel=path == "cuda")
    state.spent = True
    return ShardedState(shards)
