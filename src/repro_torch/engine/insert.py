"""Windowed insertion of a shard-stacked flush (port of
``repro.engine.insert``: ``_segment_count``, ``_scan_insert``,
``insert_stacked_fused_impl``, ``resolve_path``), and the single-shard
entry the object API rides (``insert_batch_fused_impl``, ``insert_batch``,
``insert_batch_chunked``, ``default_path``): a plain state runs the
stacked insert on ``[1, ...]`` views of its own tensors.

A flush is planned against the ring once (``WindowRing.plan``), the
re-claimed slot planes are zeroed in place, and then one of two routes
writes the matrix, chosen exactly as the reference chooses under its
``lax.cond``:

  * the kernel route, when every shard's valid prefix sits in one
    subwindow: the block-binned CUDA insert plus the pool pass
    (``kernels/sketch_insert``);
  * the scan route otherwise: ``_scan_insert``, a stream-order walk in
    plain PyTorch (one step per item, all shards at once).

Each route keeps its own claim rule, as in the reference: the kernel
claims a key only for weight > 0, the scan claims at weight 0 too.
Everything updates the state's tensors in place. The stages carry
``torch.profiler.record_function`` ranges named ``lsketch.*`` (window
plan, addressing, bin plan, insert kernel, pool pass, scan insert), so a
profiler trace splits a flush's time by stage.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import hashing as hsh
from repro_torch.core.lsketch import EdgeProbes, edge_probes, precompute
from repro_torch.core.types import EMPTY, EdgeBatch, LSketchConfig, \
    LSketchState
from repro_torch.kernels.sketch_insert.kernel import _pool_step
from repro_torch.kernels.sketch_insert.ops import \
    matrix_insert_binned_sharded

from .window import WindowRing, pad_to_bucket

# valid edges ingested by each route, summed over every flush in the
# process: read (and reset) by callers that report the route shares
ROUTE_EDGES = {"kernel": 0, "scan": 0}


def _segment_count(widx: torch.Tensor) -> torch.Tensor:
    """Number of contiguous subwindow segments of each sorted row
    ``widx`` [..., B]."""
    if widx.shape[-1] <= 1:
        return torch.full(widx.shape[:-1], widx.shape[-1], dtype=torch.int32,
                          device=widx.device)
    return 1 + (widx[..., 1:] != widx[..., :-1]).sum(-1, dtype=torch.int32)


def _first(ok: torch.Tensor) -> torch.Tensor:
    return torch.argmax(ok.to(torch.uint8), dim=-1)


def _scan_insert(cfg: LSketchConfig, state: LSketchState, probes: EdgeProbes,
                 le_idx, slot, w_count, w_key, valid) -> LSketchState:
    """Stream-order first-fit insertion with per-item ring slot and
    liveness, on a shard-stacked state in place (all ``[S, B(, s)]``).

    The paper's Algorithm 2 walk: s probe cells x 2 twins, first
    key-match-or-empty wins, additional pool on a miss. ``w_count`` is the
    weight that survives the flush's window advances; ``w_key`` gates the
    pool claim. Step ``t`` handles item ``t`` of every shard (shards are
    independent)."""
    S, B = probes.rows.shape[:2]
    dev = probes.rows.device
    sidx = torch.arange(S, device=dev)
    tz2 = torch.arange(2, device=dev)
    pool_slots = hsh.pool_slot_seq(probes.pid_src, probes.pid_dst,
                                   cfg.pool_capacity, cfg.pool_probes,
                                   cfg.seed).long()
    rows_a, cols_a = probes.rows.long(), probes.cols.long()
    slot_a, le_a = slot.long(), le_idx.long()
    for t in range(B):
        rows, cols, key = rows_a[:, t], cols_a[:, t], probes.keys[:, t]
        cur = state.key[sidx[:, None, None], rows[:, :, None],
                        cols[:, :, None], tz2[None, None, :]]  # [S, s, 2]
        ok = ((cur == key[:, :, None]) | (cur == EMPTY)).reshape(S, -1)
        ok_item = valid[:, t]
        found = ok.any(1) & ok_item
        first = _first(ok)
        pi, tz = first // 2, first % 2
        rr = torch.gather(rows, 1, pi[:, None])[:, 0]
        cc = torch.gather(cols, 1, pi[:, None])[:, 0]
        kk = torch.gather(key, 1, pi[:, None])[:, 0]
        old = state.key[sidx, rr, cc, tz]
        state.key[sidx, rr, cc, tz] = torch.where(found, kk, old)
        wc, wk, sl, le = w_count[:, t], w_key[:, t], slot_a[:, t], le_a[:, t]
        wm = torch.where(found, wc, 0)
        state.C[sidx, rr, cc, tz, sl] += wm
        state.P[sidx, rr, cc, tz, sl, le] += wm
        # pool fallback (w_key > 0 only for valid items: the plan masks it)
        _pool_step(state.pool_key, state.pool_C, state.pool_P,
                   state.pool_lost, sidx, pool_slots[:, t],
                   probes.pid_src[:, t], probes.pid_dst[:, t], wc, wk, sl,
                   le, ok_item & ~found)
    return state


def insert_stacked_fused_impl(cfg: LSketchConfig, states: LSketchState,
                              batch, n_valid, use_kernel: bool = False
                              ) -> LSketchState:
    """Insert one ``[S, B]`` hash-partitioned flush into a shard-stacked
    state, in place. ``batch`` holds int32 ``[S, B]`` tensors (src, dst,
    src_label, dst_label, edge_label, weight, time) on the state's device;
    ``n_valid`` [S]: rows at or past it are padding, fully masked
    (including the ring bookkeeping, so an empty shard is a no-op)."""
    S, B = batch.src.shape
    dev = batch.src.device
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=dev)
    valid = torch.arange(B, dtype=torch.int32, device=dev)[None, :] \
        < n_valid[:, None]

    with record_function("lsketch.window_plan"):
        ring = WindowRing.for_config(cfg)
        widx = torch.div(batch.time.to(torch.int32), cfg.subwindow_size,
                         rounding_mode="floor").to(torch.int32)
        plan = ring.plan(states.slot_widx, states.cur_widx, widx, valid)

        # apply the plan: zero re-claimed slot planes (in place), commit ring
        WindowRing.zero_reset_slots(states.C, 3, plan.reset)
        WindowRing.zero_reset_slots(states.P, 3, plan.reset)
        WindowRing.zero_reset_slots(states.pool_C, 1, plan.reset)
        WindowRing.zero_reset_slots(states.pool_P, 1, plan.reset)
        states.slot_widx.copy_(plan.slot_widx)
        states.cur_widx.copy_(plan.cur_widx)

    with record_function("lsketch.addressing"):
        pa = precompute(cfg, batch.src, batch.src_label)
        pb = precompute(cfg, batch.dst, batch.dst_label)
        probes = edge_probes(cfg, pa, pb)
        le_idx = hsh.edge_label_bucket(batch.edge_label, cfg.c, cfg.seed)
        w = batch.weight.to(states.C.dtype)
        w_count = w * plan.count_live.to(w.dtype)
        w_key = w * plan.key_live.to(w.dtype)
    n_edges = int(n_valid.sum())

    one_segment_all = False
    if use_kernel:
        rows_w = torch.where(valid, widx, widx[:, :1])
        one_segment_all = bool((_segment_count(rows_w) == 1).all())
    if one_segment_all:
        ROUTE_EDGES["kernel"] += n_edges
        return matrix_insert_binned_sharded(cfg, states, probes, le_idx,
                                            w_count, plan.slot[:, 0],
                                            max_bin=B)
    ROUTE_EDGES["scan"] += n_edges
    with record_function("lsketch.scan_insert"):
        return _scan_insert(cfg, states, probes, le_idx, plan.slot, w_count,
                            w_key, valid)


def default_path(device=None) -> str:
    """The kernel route for a state on the card, the scan on the CPU."""
    return "cuda" if torch.device(device or "cpu").type == "cuda" \
        else "scan"


def resolve_path(cfg: LSketchConfig, path: str = "auto",
                 device=None) -> str:
    """Normalize an insert path name to "scan" | "cuda" | "chunked".

    "auto" is ``default_path(device)``; "cuda" falls back to "scan" under
    skewed blocking (the binned kernel needs uniform tiles). On a CPU
    state "cuda" runs the kernel route with each kernel's plain version.
    "chunked" (the per-subwindow reference) exists on the single-shard
    entry only."""
    if path == "auto":
        path = default_path(device)
    if path == "cuda" and cfg.block_bounds is not None:
        path = "scan"
    if path not in ("scan", "cuda", "chunked"):
        raise ValueError(f"unknown insert path {path!r}")
    return path


_FIELDS = ("src", "dst", "src_label", "dst_label", "edge_label", "weight",
           "time")


class _Rows:
    """int32 ``[1, B]`` tensors, one per ``EdgeBatch`` field."""

    def __init__(self, batch: EdgeBatch, device):
        for f in _FIELDS:
            col = np.asarray(getattr(batch, f), np.int32)
            setattr(self, f, torch.from_numpy(col).to(device)[None])


def insert_batch_fused_impl(cfg: LSketchConfig, state: LSketchState,
                            batch: EdgeBatch, n_valid,
                            use_kernel: bool = False) -> LSketchState:
    """One time-ordered batch (any number of subwindows) into one plain
    state, in place: ``insert_stacked_fused_impl`` at one shard on views
    of the state's tensors. Rows at or past ``n_valid`` are padding and
    fully masked; the route rule is the stacked one."""
    if len(batch) == 0:
        return state
    dev = state.key.device
    insert_stacked_fused_impl(cfg, state.map(lambda x: x.unsqueeze(0)),
                              _Rows(batch, dev), [int(n_valid)],
                              use_kernel=use_kernel)
    return state


def insert_batch(cfg: LSketchConfig, state: LSketchState, batch: EdgeBatch,
                 path: str = "auto") -> LSketchState:
    """Insert a time-ordered batch into one plain state, in place.

    path: "auto" (the kernel route on the card, the scan on the CPU),
    "scan", "cuda" (the kernel route for a batch whose valid rows sit in
    one subwindow, the scan otherwise) or "chunked" (the per-subwindow
    reference). The batch is padded to its size bucket (replicate-last,
    masked), as the reference pads it."""
    n = len(batch)
    if n == 0:
        return state
    path = resolve_path(cfg, path, state.key.device)
    if path == "chunked":
        return insert_batch_chunked(cfg, state, batch)
    batch = EdgeBatch(*[pad_to_bucket(np.asarray(getattr(batch, f)))
                        for f in _FIELDS])
    return insert_batch_fused_impl(cfg, state, batch, n,
                                   use_kernel=path == "cuda")


def insert_batch_chunked(cfg: LSketchConfig, state: LSketchState,
                         batch: EdgeBatch) -> LSketchState:
    """The per-subwindow reference: one ``insert_window_batch`` call (the
    stream-order walk) per run of items in one subwindow, in place."""
    from repro_torch.core.lsketch import insert_window_batch

    t = np.asarray(batch.time)
    if t.shape[0] == 0:
        return state
    widx = t // cfg.subwindow_size
    cuts = np.flatnonzero(np.diff(widx)) + 1
    for a, z in zip(np.concatenate([[0], cuts]),
                    np.concatenate([cuts, [len(t)]])):
        state = insert_window_batch(cfg, state, batch.slice(a, z),
                                    int(widx[a]))
    return state
