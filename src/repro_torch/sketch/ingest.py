"""Hash-partitioned sharded ingest (port of ``repro.sketch.ingest``:
``_shard_bucket``, ``_partition_stack``, ``ingest``).

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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import EdgeBatch
from repro_torch.engine import insert as eng_insert

from .spec import SketchSpec, shard_assignment
from .state import ShardedState

_FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
           "time")


class StackedBatch:
    """int32 ``[n_shards, L]`` tensors, one per ``EdgeBatch`` field."""

    def __init__(self, **cols):
        for f in _FIELDS:
            setattr(self, f, cols[f])


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


def ingest(spec: SketchSpec, state: ShardedState, batch: EdgeBatch,
           path: str = "auto") -> ShardedState:
    """Insert a time-ordered batch into a sharded handle, in place; returns
    the new handle and marks ``state`` spent. ``path``: "auto" (the kernel
    route on a CUDA state, the scan on a CPU state), "scan" or "cuda"."""
    shards = state.live()
    if len(batch) == 0:
        return state
    dev = state.device
    path = eng_insert.resolve_path(spec.config, path, dev)
    cols, counts = _partition_stack(spec, batch)
    stacked = StackedBatch(**{f: torch.from_numpy(cols[f]).to(dev)
                              for f in _FIELDS})
    n_valid = torch.from_numpy(counts).to(dev)
    eng_insert.insert_stacked_fused_impl(spec.config, shards, stacked,
                                         n_valid, use_kernel=path == "cuda")
    state.spent = True
    return ShardedState(shards)
