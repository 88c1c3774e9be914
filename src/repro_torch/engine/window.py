"""WindowRing — the lazy subwindow ring (port of ``repro.engine.window``).

``k`` ring slots hold the ``k`` most recent subwindows; a slot is zeroed
when a newer subwindow claims it; queries mask slots by recency. The ring
works on the two bookkeeping tensors every state carries (``slot_widx``
[..., k] and ``cur_widx`` [...]); every method here accepts extra leading
(shard) dims, which take the place of the reference's ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.types import NEVER


class RingClaim(NamedTuple):
    slot: torch.Tensor  # [] ring slot owned by widx
    live: torch.Tensor  # [] bool: False iff the slot holds a newer widx
    reset: torch.Tensor  # [] bool: slot planes must be zeroed first
    slot_widx: torch.Tensor  # [k] updated
    cur_widx: torch.Tensor  # [] updated


class SegmentPlan(NamedTuple):
    """Ring plan for a time-ordered batch spanning >= 1 subwindows (see
    ``repro.engine.window.SegmentPlan``)."""

    slot: torch.Tensor  # [..., B] ring slot per item
    key_live: torch.Tensor  # [..., B] bool
    count_live: torch.Tensor  # [..., B] bool
    reset: torch.Tensor  # [..., k] bool: slots to zero up front
    slot_widx: torch.Tensor  # [..., k] final
    cur_widx: torch.Tensor  # [...] final


class WindowRing:
    """Slot claiming / zeroing / masking for a ``k``-slot subwindow ring."""

    def __init__(self, k: int):
        self.k = int(k)

    @classmethod
    def for_config(cls, cfg) -> "WindowRing":
        return cls(cfg.effective_k)

    def valid_mask(self, slot_widx, cur_widx, last: int | None = None):
        """Boolean [..., k]: slots inside the window (optionally only the
        most recent ``last`` subwindows)."""
        horizon = self.k if last is None else min(int(last), self.k)
        return slot_widx > (cur_widx[..., None] - horizon)

    def claim(self, slot_widx, cur_widx, widx) -> RingClaim:
        """Claim the slot for scalar subwindow ``widx`` (one ring)."""
        widx = torch.as_tensor(widx, dtype=torch.int32,
                               device=slot_widx.device)
        slot = torch.remainder(widx, self.k)
        stored = slot_widx[slot]
        live = widx >= stored
        reset = (stored != widx) & live
        new_slot_widx = slot_widx.clone()
        new_slot_widx[slot] = torch.where(reset, widx, stored)
        return RingClaim(slot, live, reset, new_slot_widx,
                         torch.maximum(cur_widx, widx))

    def plan(self, slot_widx, cur_widx, widx, valid=None) -> SegmentPlan:
        """Plan the ring updates for per-item subwindow indices ``widx``
        [..., B] (non-decreasing along the last axis); ``valid`` marks real
        items. Same three facts as the reference: resets where a live claim
        changes a slot, counters survive only for each slot's final
        claimant, ``slot_widx`` = max over live claims."""
        widx = widx.to(torch.int32)
        slot = torch.remainder(widx, self.k)
        stored = torch.gather(slot_widx, -1, slot.to(torch.int64))
        key_live = widx >= stored
        if valid is not None:
            key_live = key_live & valid
        never = torch.full_like(widx, NEVER)
        claimed = torch.where(key_live, widx, never)
        new_slot_widx = slot_widx.scatter_reduce(
            -1, slot.to(torch.int64), claimed, reduce="amax",
            include_self=True)
        count_live = key_live & (
            widx == torch.gather(new_slot_widx, -1, slot.to(torch.int64)))
        reset = new_slot_widx > slot_widx
        batch_max = claimed.amax(-1) if claimed.shape[-1] else \
            torch.full_like(cur_widx, NEVER)
        new_cur = torch.maximum(cur_widx, batch_max)
        return SegmentPlan(slot, key_live, count_live, reset, new_slot_widx,
                           new_cur)

    @staticmethod
    def zero_reset_slots(arr, axis: int, reset):
        """Zero, in place, the slots flagged in ``reset`` along ``axis``.

        ``reset`` is [k] for one state or [S, k] for a stack whose leaves
        carry a leading ``[S]`` (then ``axis`` counts from the unstacked
        leaf). Only the flagged slot planes are written — a whole-array
        select would touch every byte of the 4 GiB-per-shard ``P``."""
        if reset.dim() == 1:
            for j in torch.nonzero(reset.cpu()).flatten().tolist():
                arr.select(axis % arr.dim(), j).zero_()
            return arr
        ax = axis % (arr.dim() - 1)
        for s, j in torch.nonzero(reset.cpu()).tolist():
            arr[s].select(ax, j).zero_()
        return arr


def bucket_size(n: int, floor: int = 64) -> int:
    """Next power of two >= n (>= floor)."""
    b = floor
    while b < n:
        b *= 2
    return b


def pad_to_bucket(x, floor: int = 64):
    """Pad a 1-D numpy array or tensor to its size bucket by replicating
    the last element (replicate-last keeps a ``time`` column
    non-decreasing, so segment plans are untouched); callers mask the pad
    rows (LSketch: ``n_valid``; LGS: zeroed pad weights)."""
    n = x.shape[0]
    to = bucket_size(n, floor)
    if to == n:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(to - n)])
    return np.concatenate([x, np.broadcast_to(x[-1], (to - n,))])
