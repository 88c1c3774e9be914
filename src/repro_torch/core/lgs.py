"""LGS baseline (port of ``repro.core.lgs``): the labeled competitor.

``copies`` independent d x d count matrices. Each copy hashes the
(vertex, vertex label) pair to a row or column — no fingerprints, no probe
lists, no keys, no pool — so edges that share a cell are indistinguishable
and a query over-estimates by the cell's whole load. Edge labels ride in
per-cell label-bucket counters; timestamps use the LSketch subwindow ring
(``engine.window.WindowRing``). Queries take the minimum over the copies.

The insert is a plain count-min scatter-add: ``index_put_`` with
``accumulate=True`` on int32, exact in any order (integer addition
commutes and wraps as the reference's). The reference has no Pallas
kernel here either, and the queries are its scan-only path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.engine.window import WindowRing

from . import hashing as hsh
from .lsketch import OneShardObject
from .types import NEVER, resolve_device

LGS_LEAVES = ("C", "P", "slot_widx", "cur_widx")


@dataclass
class LGSState:
    """int32 tensors, updated in place by ingest."""

    C: torch.Tensor  # [copies, d, d, k]
    P: torch.Tensor  # [copies, d, d, k, c]
    slot_widx: torch.Tensor  # [k]
    cur_widx: torch.Tensor  # []

    def leaves(self):
        return [getattr(self, f) for f in LGS_LEAVES]

    def map(self, fn) -> "LGSState":
        return LGSState(*[fn(x) for x in self.leaves()])


@dataclass(frozen=True)
class LGSConfig:
    """Static configuration of an LGS (same fields, defaults and order as
    ``repro.core.lgs.LGSConfig``; equal configs compare and hash equal)."""

    d: int = 256
    copies: int = 6
    c: int = 8
    k: int = 4
    window_size: int = 0
    seed: int = 99

    @property
    def subwindow_size(self) -> int:
        return 2**30 if self.window_size == 0 else \
            max(1, self.window_size // self.k)

    @property
    def effective_k(self) -> int:
        return 1 if self.window_size == 0 else self.k

    def key(self) -> Tuple[int, ...]:
        return dataclasses.astuple(self)


def lgs_init_leaves(cfg: LGSConfig, lead: Tuple[int, ...], device
                    ) -> LGSState:
    """Fresh empty state with leading dims ``lead`` on every leaf."""
    k, dev = cfg.effective_k, torch.device(device)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.int32, device=dev)

    return LGSState(C=full((cfg.copies, cfg.d, cfg.d, k), 0),
                    P=full((cfg.copies, cfg.d, cfg.d, k, cfg.c), 0),
                    slot_widx=full((k,), NEVER), cur_widx=full((), NEVER))


def lgs_init_state(cfg: LGSConfig, device=None) -> LGSState:
    return lgs_init_leaves(cfg, (), resolve_device(device))


def lgs_state_bytes(cfg: LGSConfig) -> int:
    """Configured storage of one LGS in bytes, allocated nowhere."""
    return sum(x.numel() * x.element_size()
               for x in lgs_init_leaves(cfg, (), "meta").leaves())


def _addr(cfg: LGSConfig, v, label) -> torch.Tensor:
    """Per-copy address of (v, l_v): int64 [..., copies]."""
    u = hsh._mul32(hsh._u32(v), 2654435761) ^ \
        ((hsh._u32(label) << 8) & 0xFFFFFFFF)
    return torch.stack([torch.remainder(hsh.hash31(u, cfg.seed + 7919 * i),
                                        cfg.d).long()
                        for i in range(cfg.copies)], dim=-1)


def lgs_insert_impl(cfg: LGSConfig, state: LGSState, src, dst, la, lb, le,
                    w, times, valid=None) -> LGSState:
    """One time-ordered batch (any number of subwindows) into one state, in
    place: re-claimed ring slots are zeroed up front, then each item adds
    into its own slot where it still owns it at the batch's end
    (``count_live``). ``valid`` marks real rows: pad rows take no part in
    the ring's claims (their weights must be 0 as well)."""
    ring = WindowRing.for_config(cfg)
    widx = torch.div(times.to(torch.int32), cfg.subwindow_size,
                     rounding_mode="floor").to(torch.int32)
    plan = ring.plan(state.slot_widx, state.cur_widx, widx, valid)
    WindowRing.zero_reset_slots(state.C, 3, plan.reset)
    WindowRing.zero_reset_slots(state.P, 3, plan.reset)
    state.slot_widx.copy_(plan.slot_widx)
    state.cur_widx.copy_(plan.cur_widx)

    rows, cols = _addr(cfg, src, la), _addr(cfg, dst, lb)  # [B, copies]
    lei = hsh.edge_label_bucket(le, cfg.c, cfg.seed).long()
    copy_idx = torch.arange(cfg.copies, device=rows.device).expand_as(rows)
    wB = (w.to(torch.int32) * plan.count_live.to(torch.int32))[:, None] \
        .expand_as(rows)
    slotB = plan.slot.long()[:, None].expand_as(rows)
    state.C.index_put_((copy_idx, rows, cols, slotB), wB, accumulate=True)
    state.P.index_put_((copy_idx, rows, cols, slotB,
                        lei[:, None].expand_as(rows)), wB, accumulate=True)
    return state


def _mask(cfg, state, last):
    """The in-window ring slots, as a host bool [k]."""
    return WindowRing.for_config(cfg).valid_mask(
        state.slot_widx, state.cur_widx, last).cpu()


def _slot_sum(x: torch.Tensor, mask) -> torch.Tensor:
    """int32 sum (with wrap) over the slots ``mask`` admits of ``x``, whose
    last axis is the ring slot."""
    out = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for j in torch.nonzero(mask).flatten().tolist():
        out += x[..., j]
    return hsh._wrap32(out)


def _lgs_edge_query(cfg: LGSConfig, state: LGSState, src, dst, la, lb, le,
                    with_label: bool, last=None) -> torch.Tensor:
    """min over the copies of the edge cell's windowed weight: int32 [B]."""
    m = _mask(cfg, state, last)
    rows, cols = _addr(cfg, src, la), _addr(cfg, dst, lb)
    copy_idx = torch.arange(cfg.copies, device=rows.device).expand_as(rows)
    if with_label:
        lei = hsh.edge_label_bucket(le, cfg.c, cfg.seed).long()
        cells = state.P.permute(0, 1, 2, 4, 3)[
            copy_idx, rows, cols, lei[:, None].expand_as(rows)]  # [B, t, k]
    else:
        cells = state.C[copy_idx, rows, cols]  # [B, t, k]
    return _slot_sum(cells, m).amin(-1)


def _lgs_vertex_query(cfg: LGSConfig, state: LGSState, v, lv, le,
                      with_label: bool, direction: str = "out",
                      last=None) -> torch.Tensor:
    """min over the copies of the vertex line's windowed weight: int32
    [B]. Gathers the queried lines only (at the query's own label)."""
    m = _mask(cfg, state, last)
    rows = _addr(cfg, v, lv)  # [B, copies]
    copy_idx = torch.arange(cfg.copies, device=rows.device).expand_as(rows)
    if with_label:
        lei = hsh.edge_label_bucket(le, cfg.c, cfg.seed).long()
        lab = lei[:, None].expand_as(rows)
        P = state.P.permute(0, 1, 2, 4, 3)  # [t, d, d, c, k]
        line = P[copy_idx, rows, :, lab] if direction == "out" else \
            P[copy_idx, :, rows, lab]  # [B, t, d, k]
    else:
        line = state.C[copy_idx, rows] if direction == "out" else \
            state.C[copy_idx, :, rows]  # [B, t, d, k]
    per_cell = _slot_sum(line, m)  # [B, t, d]
    return hsh._wrap32(per_cell.sum(-1, dtype=torch.int64)).amin(-1)


class LGS(OneShardObject):
    """The LGS object over a 1-shard ``lgs`` handle; ``.state`` reads as
    the plain ``LGSState`` and can be assigned."""

    kind = "lgs"

    def __init__(self, cfg: LGSConfig | None = None, state=None,
                 device=None, **kw):
        self.cfg = cfg if cfg is not None else LGSConfig(**kw)
        self.state = state if state is not None else \
            lgs_init_state(self.cfg, device)

    # ---- queries (scalar in -> int out; array in -> array out) ----

    def edge_weight(self, a, la, b, lb, le=None, last=None):
        from repro_torch.engine import query_batch as qb
        out = qb.edge_weight_batch(self, a, la, b, lb, edge_label=le,
                                   last=last)
        return qb.scalarize(out, np.ndim(a) == 0)

    def vertex_weight(self, v, lv, le=None, direction="out", last=None):
        from repro_torch.engine import query_batch as qb
        out = qb.vertex_weight_batch(self, v, lv, edge_label=le,
                                     direction=direction, last=last)
        return qb.scalarize(out, np.ndim(v) == 0)

    def label_aggregate(self, lv, le=None, direction="out", last=None):
        """LGS cells mix every vertex label: a per-label aggregate is not
        recoverable from its state (DESIGN.md §5.3)."""
        from repro_torch.engine import query_batch as qb
        return qb.label_aggregate_batch(self, lv, edge_label=le,
                                        direction=direction, last=last)

    def reachable(self, a, la, b, lb, max_hops=64) -> bool:
        """BFS over cells with positive counts of copy 0 (no reversibility
        in LGS: cell columns are walked as pseudo-nodes, the LGS paper's
        own approximation), over the full sliding window."""
        cfg, st = self.cfg, self.state
        m = _mask(cfg, st, None)
        C0 = _slot_sum(st.C[0], m).cpu().numpy()
        t = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
        src_addr = int(_addr(cfg, t(a), t(la))[0])
        dst_addr = int(_addr(cfg, t(b), t(lb))[0])
        seen, frontier = {src_addr}, [src_addr]
        for _ in range(max_hops):
            if not frontier:
                return False
            nxt = set()
            for u in frontier:
                cols = np.flatnonzero(C0[u] > 0)
                if dst_addr in cols:
                    return True
                nxt.update(int(cc) for cc in cols)
            frontier = [v for v in nxt if v not in seen]
            seen.update(frontier)
        return False
