"""Windowed insertion of a shard-stacked flush (port of
``repro.engine.insert``: ``_scan_insert``, ``insert_stacked_fused_impl``
with its ``emit_delta`` record, ``resolve_path``), and the single-shard
entry the object API rides (``insert_batch_fused_impl``, ``insert_batch``,
``insert_batch_chunked``, ``default_path``): a plain state runs the
stacked insert on ``[1, ...]`` views of its own tensors.

A flush is planned against the ring once (``WindowRing.plan``), the
re-claimed slot planes are zeroed in place, and then one of two routes
writes the matrix, chosen exactly as the reference chooses under its
``lax.cond`` (from the host's copy of the time column: the choice waits
on no device read):

  * the kernel route, when every shard's valid prefix sits in one
    subwindow: the block-binned CUDA insert plus the pool pass
    (``kernels/sketch_insert``);
  * the scan route otherwise: ``_scan_insert``, a stream-order walk in
    plain PyTorch (one step per item, all shards at once).

Each route keeps its own claim rule, as in the reference: the kernel
claims a key only for weight > 0, the scan claims at weight 0 too.
Everything updates the state's tensors in place. The stages carry
``telemetry.spans`` ranges named ``lsketch.*`` (window plan, addressing,
bin plan, insert kernel, pool pass, scan insert, planes delta), so a
profiler trace splits a flush's time by stage.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing as hsh
from repro_torch.core.lsketch import EdgeProbes, edge_probes, precompute
from repro_torch.core.queries import PlanesDelta
from repro_torch.core.types import EMPTY, EdgeBatch, LSketchConfig, \
    LSketchState
from repro_torch.kernels.sketch_insert.kernel import _pool_step
from repro_torch.kernels.sketch_insert.ops import \
    matrix_insert_binned_sharded
from repro_torch.telemetry.spans import span

from .window import WindowRing, pad_to_bucket

# valid edges ingested by each route, summed over every flush in the
# process: read (and reset) by callers that report the route shares
ROUTE_EDGES = {"kernel": 0, "scan": 0}


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


def _touched_slot_slices(states: LSketchState, slot: torch.Tensor):
    """Copies of each shard's counters at ring slot ``slot[s]`` (``[S]``, on
    the device; no host read): C ``[S, d, d, 2]``, P ``[S, d, d, 2, c]``,
    pool_C ``[S, Q]``, pool_P ``[S, Q, c]`` — the only slot a
    single-segment flush writes."""
    sidx = torch.arange(slot.shape[0], device=slot.device)
    sl = slot.long()
    return [states.C[sidx, :, :, :, sl], states.P[sidx, :, :, :, sl],
            states.pool_C[sidx, :, sl], states.pool_P[sidx, :, sl]]


def _host_rows(batch, n_valid):
    """(valid edges, per-row counts, time column) of a flush, on the host:
    the time column is the partition's own copy (``batch.time_host``; a
    batch without one has its time column read back), so the route
    choice waits on no device read."""
    counts = np.asarray(n_valid, np.int64)
    t = getattr(batch, "time_host", None)
    if t is None:
        t = batch.time.cpu().numpy()
    return int(counts.sum()), counts, t


def one_segment(cfg: LSketchConfig, time_host, counts) -> np.ndarray:
    """bool ``[S]``: every valid item of the row (the first ``counts[s]``
    of ``time_host``'s ``[S, B]`` columns) lies in one subwindow. The
    kernel route takes a flush whose rows all do."""
    t = np.asarray(time_host, np.int64)
    valid = np.arange(t.shape[1])[None, :] < np.asarray(counts)[:, None]
    hw = t // cfg.subwindow_size
    hw = np.where(valid, hw, hw[:, :1])  # padding: the row's first
    return (hw == hw[:, :1]).all(axis=1)


def insert_stacked_fused_impl(cfg: LSketchConfig, states: LSketchState,
                              batch, n_valid, use_kernel: bool = False,
                              emit_delta: bool = False):
    """Insert one ``[S, B]`` hash-partitioned flush into a shard-stacked
    state, in place. ``batch`` holds int32 ``[S, B]`` tensors (src, dst,
    src_label, dst_label, edge_label, weight, time) on the state's device;
    ``n_valid`` [S] (host counts): rows at or past it are padding, fully
    masked (including the ring bookkeeping, so an empty shard is a
    no-op).

    With ``emit_delta`` the return value is ``(states, delta)``, ``delta``
    the flush's ``core.queries.PlanesDelta``. The insert writes in place,
    so the touched slot's counters are copied after the ring plan's
    resets and before the kernel or the scan writes, and the increment is
    what they hold after it minus that copy. ``delta.ok`` is per shard
    row, as in the reference: one segment and no reset."""
    S, B = batch.src.shape
    dev = batch.src.device
    n_edges, counts, time_host = _host_rows(batch, n_valid)
    valid_host = np.arange(B)[None, :] < counts[:, None]
    valid = torch.from_numpy(valid_host).to(dev)

    with span("lsketch.window_plan"):
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

    with span("lsketch.addressing"):
        pa = precompute(cfg, batch.src, batch.src_label)
        pb = precompute(cfg, batch.dst, batch.dst_label)
        probes = edge_probes(cfg, pa, pb)
        le_idx = hsh.edge_label_bucket(batch.edge_label, cfg.c, cfg.seed)
        w = batch.weight.to(states.C.dtype)
        w_count = w * plan.count_live.to(w.dtype)
        w_key = w * plan.key_live.to(w.dtype)

    one_segment_rows = one_segment(cfg, time_host, counts)
    touched = plan.slot[:, 0]
    pre = _touched_slot_slices(states, touched) if emit_delta else None

    if use_kernel and bool(one_segment_rows.all()):
        ROUTE_EDGES["kernel"] += n_edges
        matrix_insert_binned_sharded(cfg, states, probes, le_idx, w_count,
                                     touched, max_bin=B)
    else:
        ROUTE_EDGES["scan"] += n_edges
        with span("lsketch.scan_insert"):
            _scan_insert(cfg, states, probes, le_idx, plan.slot, w_count,
                         w_key, valid)
    if not emit_delta:
        return states
    with span("lsketch.planes_delta"):
        post = _touched_slot_slices(states, touched)
        for a, b in zip(post, pre):
            a.sub_(b)
        del pre
        ok = torch.from_numpy(one_segment_rows).to(dev) & \
            ~plan.reset.any(dim=1)
    return states, PlanesDelta(ok, touched, *post)


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
    """int32 ``[1, B]`` tensors, one per ``EdgeBatch`` field, and the host
    copy of the time column (``time_host``)."""

    def __init__(self, batch: EdgeBatch, device):
        for f in _FIELDS:
            col = np.asarray(getattr(batch, f), np.int32)
            setattr(self, f, torch.from_numpy(col).to(device)[None])
        self.time_host = np.asarray(batch.time, np.int32)[None]


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
