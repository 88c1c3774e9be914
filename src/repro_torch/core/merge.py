"""Sketch mergeability (port of ``repro.core.merge``: ``keys_compatible``,
``merge_counters``, ``shard_keys_compatible``, ``merge_all``,
``lgs_merge_all``, and the collective reductions ``psum_partials``,
``maybe_psum_partials`` and ``psum_sketch``).

Two LSketches built with the same config and seed over disjoint
sub-streams merge by addition wherever their occupancy histories agree:
the same logical edge lands in the same (cell, twin) of every shard whose
first-fit claims match. ``shard_keys_compatible`` detects exactly the
divergence (two different keys at one address). ``merge_all`` reduces a
whole ``[n_shards, ...]`` stack with per-slot window reconciliation: a
shard that saw no items for subwindow ``w`` never re-claimed ring slot
``w % k`` and may still hold stale counters there, which the combined
ingest would have zeroed, so per ring slot only the shards whose
``slot_widx`` equals the merged (max) owner count.

Every function is a dense masked torch reduction on the state's device;
the sums wrap in int32 as the reference's do. The counter planes reduce
one shard at a time, so the transient is one shard's plane, not the
stack's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .types import EMPTY, LEAVES, LSketchConfig, LSketchState


def keys_compatible(a: LSketchState, b: LSketchState) -> torch.Tensor:
    """True iff every cell occupied in both sketches holds the same key
    (a 0-dim bool tensor)."""
    both = (a.key != EMPTY) & (b.key != EMPTY)
    return torch.all(torch.where(both, a.key == b.key, True))


def merge_counters(cfg: LSketchConfig, a: LSketchState,
                   b: LSketchState) -> LSketchState:
    """Exact merge by addition (requires ``keys_compatible`` and windows
    in lockstep). Cells occupied in only one input adopt its key."""
    return LSketchState(
        key=torch.where(a.key == EMPTY, b.key, a.key),
        C=a.C + b.C,
        P=a.P + b.P,
        pool_key=torch.where(a.pool_key == EMPTY, b.pool_key, a.pool_key),
        pool_C=a.pool_C + b.pool_C,
        pool_P=a.pool_P + b.pool_P,
        pool_lost=a.pool_lost + b.pool_lost,
        slot_widx=torch.maximum(a.slot_widx, b.slot_widx),
        cur_widx=torch.maximum(a.cur_widx, b.cur_widx),
    )


def shard_keys_compatible(stacked: LSketchState) -> torch.Tensor:
    """True iff an ``[n_shards, ...]`` stack is exactly mergeable: every
    matrix cell and pool slot occupied in more than one shard holds the
    same key in all of them (the condition under which hash-partitioned
    ingest equals single-sketch ingest bit for bit)."""
    mk = torch.amax(stacked.key, dim=0)  # keys are non-negative; EMPTY = -1
    ok_m = torch.all((stacked.key == EMPTY) | (stacked.key == mk[None]))
    pk = torch.amax(stacked.pool_key, dim=0)
    ok_p = torch.all((stacked.pool_key == EMPTY) |
                     (stacked.pool_key == pk[None]))
    return ok_m & ok_p


def _masked_sum(x: torch.Tensor, keep: torch.Tensor,
                slot_dim: int) -> torch.Tensor:
    """``sum_s x[s] * keep[s]`` with ``keep`` [S, k] broadcast along the
    ring-slot dimension ``slot_dim`` of ``x[s]``; int32, wrapping."""
    shape = [1] * (x.dim() - 1)
    shape[slot_dim] = keep.shape[1]
    out = torch.zeros_like(x[0])
    for s in range(x.shape[0]):
        out.add_(x[s] * keep[s].view(shape))
    return out


def _reconcile(stacked):
    """(merged slot_widx [k], merged cur_widx, keep [S, k] as the counters'
    dtype)."""
    slot_widx = torch.amax(stacked.slot_widx, dim=0)
    cur_widx = torch.amax(stacked.cur_widx, dim=0)
    keep = (stacked.slot_widx == slot_widx[None]).to(stacked.C.dtype)
    return slot_widx, cur_widx, keep


def merge_all(cfg: LSketchConfig, stacked: LSketchState) -> LSketchState:
    """Reduce an ``[n_shards, ...]`` stack of same-config shard states to
    one ``LSketchState``: counters add under the per-slot window
    reconciliation, keys union by maximum. Bit-identical to replaying the
    full stream into one sketch whenever the shards are key-compatible."""
    slot_widx, cur_widx, keep = _reconcile(stacked)
    return LSketchState(
        key=torch.amax(stacked.key, dim=0),
        C=_masked_sum(stacked.C, keep, 3),
        P=_masked_sum(stacked.P, keep, 3),
        pool_key=torch.amax(stacked.pool_key, dim=0),
        pool_C=_masked_sum(stacked.pool_C, keep, 1),
        pool_P=_masked_sum(stacked.pool_P, keep, 1),
        pool_lost=torch.sum(stacked.pool_lost, dim=0).to(
            stacked.pool_lost.dtype),
        slot_widx=slot_widx,
        cur_widx=cur_widx,
    )


def lgs_merge_all(cfg, stacked):
    """``merge_all`` for an ``[n_shards, ...]`` stack of LGS states: pure
    counter addition (no keys, no pool) under the same per-slot window
    reconciliation."""
    from .lgs import LGSState

    slot_widx, cur_widx, keep = _reconcile(stacked)
    return LGSState(
        C=_masked_sum(stacked.C, keep, 3),
        P=_masked_sum(stacked.P, keep, 3),
        slot_widx=slot_widx,
        cur_widx=cur_widx,
    )


# --------------------------------------------------------------------------
# the collective reductions of a mesh-resident handle (torch.distributed)
# --------------------------------------------------------------------------

def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over every rank of ``group`` (``lax.psum``), in place
    on ``x``, which it returns. int32 wraps in two's complement, as the
    reference's does."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s elementwise maximum over every rank of ``group``
    (``lax.pmax``), in place on ``x``, which it returns."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def psum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """Reduce per-shard query partials to the fleet answer: sum the rank's
    own shard axis (``x``: ``[S_local, B]``), then one all-reduce across
    ``group``. Addition is the exact combinator of every sketch query
    (hash partitioning makes the shard estimates disjoint) and int32
    addition wraps associatively, so the two-level sum equals the host
    sum over the whole stack bit for bit."""
    return psum(x.sum(0, dtype=torch.int64).to(torch.int32), group)


def maybe_psum_partials(w: torch.Tensor, wl: torch.Tensor, group):
    """The plane ops' shared reduction tail: the per-shard partials as
    they are when ``group`` is None (a host-resident stack), else both
    reduced through one ``psum_partials`` — the collective reduction in
    one place."""
    if group is None:
        return w, wl
    both = psum_partials(torch.stack([w, wl], dim=1), group)  # one call
    return both[0], both[1]


def psum_sketch(cfg: LSketchConfig, state: LSketchState,
                group) -> LSketchState:
    """All-reduce one sketch state across ``group``: the maximum for the
    keys and window indices (equal across ranks by construction: same
    seed, lockstep windows), the sum for the counters. This moves the
    whole ``[d, d, 2, k(, c)]`` planes per call, where the collective
    query's ``psum_partials`` moves one int32 a query. A new state; the
    input is not changed."""
    red = {"key": pmax, "pool_key": pmax, "slot_widx": pmax,
           "cur_widx": pmax}
    return LSketchState(**{n: red.get(n, psum)(getattr(state, n).clone(),
                                                group) for n in LEAVES})
