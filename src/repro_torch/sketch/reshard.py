"""Key-space resharding: shard-count changes that balance stored history
(port of ``repro.sketch.reshard``).

``reshard(spec, state, n_shards)`` re-partitions a handle's contents over
a new shard count by decode and re-insert over the sketch's key space:

  1. **decode** every occupied matrix cell and pool entry of every shard
     into a record ``(vid_src, vid_dst, C [k], P [k, c])``, under
     ``merge_all``'s per-slot window reconciliation (a lagging shard's
     stale ring slots count zero) and dropping records with no live
     weight. Key reversibility recovers both endpoints' packed vertex
     identities from a cell's address and stored key, and a packed vid
     determines the whole probe walk. Records come in the reference's
     order: the occupied cells in ``[S, d, d, 2]`` order, then the pool
     entries in ``(shard, slot)`` order.
  2. route each record by ``routed_assignment_vids`` and **replay
     first-fit insertion** per target shard in record order: the matrix
     probe walk (probe-major, twin-minor), the pool's open-addressing
     sequence, ``pool_lost`` on saturation. Records of one endpoint pair
     land in one cell or slot and their counters add.

Vertex and label answers are conserved exactly, edge answers stay
one-sided (``est >= truth``, or ``est >= truth - pool_lost`` under
saturation), and occupancy balances over the new shards. LGS is refused:
its cells store no keys.

Two routes compute the same replay:

  * on the card, the decode is ``cell_decode_kernel_sharded`` on the key
    plane, and the claims come from the write path's kernels: each target
    shard's records are one ``[S', B]`` flush of weight 1 through
    ``sketch_insert_kernel_sharded`` on a fresh key plane with scratch
    counters (bins own disjoint cells and walk in stream order, which is
    record order), then ``pool_pass_kernel_sharded`` over the records the
    matrix rejected, each carrying its total weight as ``w_key`` so that
    ``pool_lost`` is the reference's. A record's landing place is the
    first probe position whose final key equals its own key at that
    position (keys never change once claimed, so every earlier position
    held another key when it walked), else the first slot of its pool
    sequence holding its pair; its counters are added there with one
    ``index_put_(accumulate=True)`` a leaf.
  * the plain version, ``_replay``, is the reference's host loop over
    records; a CPU state takes it. Through the kernels' plain versions the
    card route runs on the CPU too (``_reshard(..., card=True)``).

``RESHARD_SPLIT`` holds the last call's record count and the seconds of
its decode, claim and scatter stages (synchronised on the card).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import hashing as hsh
from repro_torch.core.lsketch import (EdgeProbes, VertexAddressing,
                                      edge_probes)
from repro_torch.core.types import EMPTY, LSketchState
from repro_torch.kernels.heavy_hitters.kernel import \
    cell_decode_kernel_sharded
from repro_torch.kernels.heavy_hitters.ops import _static_blocks
from repro_torch.kernels.sketch_insert.kernel import (
    pool_pass_kernel_sharded, sketch_insert_kernel_sharded)
from repro_torch.kernels.sketch_insert.ops import _bin_plan

from .routing import prune_routing, routed_assignment_vids
from .spec import SketchSpec
from .state import ShardedState, fleet_shards, mesh_context

RESHARD_SPLIT: dict = {}


def _addressing_from_vids(cfg, vids) -> VertexAddressing:
    """Full probe addressing from packed (m, s, f) identities (the decode
    direction of ``precompute``)."""
    vids = torch.as_tensor(vids).to(torch.int32)
    m, s, f = hsh.unpack_vertex_id(vids, cfg.F)
    starts, widths = cfg.block_start_width(vids.device)
    return VertexAddressing(m, starts[m.long()], widths[m.long()], s, f,
                            hsh.candidate_offsets(f, cfg.r), vids)


def _cell_vids(cfg, rows, cols, keys):
    """Invert (cell address, packed key) -> (vid_src, vid_dst): the stored
    (ia, fa) fields name the row as the ia-th candidate of the source,
    (ib, fb) the column as the ib-th of the destination."""
    k = torch.as_tensor(keys).to(torch.int32)
    ia, ib, fa, fb = hsh.unpack_key(k, cfg.F)
    starts, widths = cfg.block_start_width(k.device)
    return (hsh.decode_line_vid(rows, ia, fa, starts, widths, cfg.r, cfg.F),
            hsh.decode_line_vid(cols, ib, fb, starts, widths, cfg.r, cfg.F))


def _decode_records(cfg, shards, card: bool):
    """Decode a stacked ``[S, ...]`` state into relocatable records, on
    the state's device: (vid_src, vid_dst, C [R, k], P [R, k, c]). With
    ``card`` the owners come from the cell-decode kernel's wrapper over
    the twin-leading key plane, else from ``_cell_vids`` per record."""
    slot_widx = torch.amax(shards.slot_widx, dim=0)
    keep = (shards.slot_widx == slot_widx[None]).to(shards.C.dtype)  # [S, k]

    key = shards.key  # [S, d, d, 2]
    si, rows, cols, tz = torch.nonzero(key != EMPTY, as_tuple=True)
    if card:
        starts, widths = _static_blocks(cfg)
        vs, vd = cell_decode_kernel_sharded(
            key.permute(0, 3, 1, 2).contiguous(), starts=starts,
            widths=widths, r=cfg.r, F=cfg.F)
        vid_src, vid_dst = vs[si, tz, rows, cols], vd[si, tz, rows, cols]
        del vs, vd
    else:
        vid_src, vid_dst = _cell_vids(cfg, rows, cols, key[si, rows, cols, tz])
    C = shards.C[si, rows, cols, tz] * keep[si]
    P = shards.P[si, rows, cols, tz] * keep[si][:, :, None]

    sp, slots = torch.nonzero(shards.pool_key[:, :, 0] != EMPTY,
                              as_tuple=True)
    pk = shards.pool_key[sp, slots]
    vid_src = torch.cat([vid_src.to(torch.int32), pk[:, 0]])
    vid_dst = torch.cat([vid_dst.to(torch.int32), pk[:, 1]])
    C = torch.cat([C, shards.pool_C[sp, slots] * keep[sp]])
    P = torch.cat([P, shards.pool_P[sp, slots] * keep[sp][:, :, None]])
    # a record the window reconciliation zeroed entirely carries no
    # queryable weight, yet replayed it would claim cells and pool slots;
    # P zeroes with C (the same mask), so C alone decides liveness
    live = C.sum(dim=1) > 0
    return vid_src[live], vid_dst[live], C[live], P[live]


def _replay(cfg, n_shards, assign, vid_src, vid_dst, rec_C, rec_P, d):
    """First-fit re-insertion of decoded records (numpy) into ``n_shards``
    fresh shard states, one record at a time: the reference's host loop.
    Returns the numpy leaves (key, C, P, pool_key, pool_C, pool_P,
    pool_lost)."""
    pa = _addressing_from_vids(cfg, vid_src)
    pb = _addressing_from_vids(cfg, vid_dst)
    pr = edge_probes(cfg, pa, pb)
    rows, cols, keys = (x.numpy() for x in (pr.rows, pr.cols, pr.keys))
    pool_seq = hsh.pool_slot_seq(pa.vid, pb.vid, cfg.pool_capacity,
                                 cfg.pool_probes, cfg.seed).numpy()

    kk, cc = rec_C.shape[1], rec_P.shape[2]
    Q = cfg.pool_capacity
    key = np.full((n_shards, d, d, 2), EMPTY, np.int32)
    C = np.zeros((n_shards, d, d, 2, kk), rec_C.dtype)
    Pn = np.zeros((n_shards, d, d, 2, kk, cc), rec_P.dtype)
    pool_key = np.full((n_shards, Q, 2), EMPTY, np.int32)
    pool_C = np.zeros((n_shards, Q, kk), rec_C.dtype)
    pool_P = np.zeros((n_shards, Q, kk, cc), rec_P.dtype)
    pool_lost = np.zeros((n_shards,), np.int64)

    s_probes = rows.shape[1]
    for i in range(len(assign)):
        sh = int(assign[i])
        placed = False
        for p in range(s_probes):
            r, c = rows[i, p], cols[i, p]
            for t in (0, 1):
                cur = key[sh, r, c, t]
                if cur == keys[i, p] or cur == EMPTY:
                    key[sh, r, c, t] = keys[i, p]
                    C[sh, r, c, t] += rec_C[i]
                    Pn[sh, r, c, t] += rec_P[i]
                    placed = True
                    break
            if placed:
                break
        if not placed:
            for q in pool_seq[i]:
                pk = pool_key[sh, q]
                if (pk[0] == vid_src[i] and pk[1] == vid_dst[i]) \
                        or pk[0] == EMPTY:
                    pool_key[sh, q] = (vid_src[i], vid_dst[i])
                    pool_C[sh, q] += rec_C[i]
                    pool_P[sh, q] += rec_P[i]
                    placed = True
                    break
        if not placed:
            pool_lost[sh] += int(rec_C[i].sum())

    return key, C, Pn, pool_key, pool_C, pool_P, pool_lost


def _replay_claims(cfg, n_shards, assign, vid_src, vid_dst, rec_C, rec_P,
                   d, split):
    """The card route of ``_replay`` (tensors on the records' device):
    the claims by the insert and pool kernels, then each record's counters
    added at its landing place. Returns the same seven leaves as tensors
    and records the claim and scatter seconds in ``split``."""
    if cfg.block_bounds is not None:
        raise ValueError("the claim walk bins by uniform blocks only")
    dev = rec_C.device
    i32 = torch.int32
    R, S, Q = vid_src.shape[0], n_shards, cfg.pool_capacity
    t0 = time.perf_counter()
    a = torch.as_tensor(assign).to(device=dev, dtype=torch.long)
    counts = torch.bincount(a, minlength=S)
    B = max(int(counts.max()), 1) if R else 1
    order = torch.argsort(a, stable=True)
    pos = torch.empty_like(a)
    pos[order] = torch.arange(R, device=dev) - \
        (torch.cumsum(counts, 0) - counts)[a[order]]

    def lay(x):  # [R, ...] in record order -> [S, B, ...] flush rows
        out = torch.zeros((S, B) + tuple(x.shape[1:]), dtype=i32, device=dev)
        out[a, pos] = x.to(i32)
        return out

    pr = edge_probes(cfg, _addressing_from_vids(cfg, vid_src),
                     _addressing_from_vids(cfg, vid_dst))
    rows, cols, keys = lay(pr.rows), lay(pr.cols), lay(pr.keys)
    weight = lay(torch.ones(R, dtype=i32, device=dev))
    zero = torch.zeros((S, B), dtype=i32, device=dev)
    key = torch.full((S, d, d, 2), EMPTY, dtype=i32, device=dev)
    _, _, border, bcounts, boffs = _bin_plan(
        cfg, EdgeProbes(rows, cols, keys, None, None), weight)
    inserted = sketch_insert_kernel_sharded(
        rows, cols, keys, weight, zero, torch.zeros(S, dtype=i32, device=dev),
        border, boffs, bcounts, key,
        torch.zeros((S, d, d, 2, 1), dtype=i32, device=dev),
        torch.zeros((S, d, d, 2, 1, 1), dtype=i32, device=dev), B)
    del rows, cols, keys, border, bcounts, boffs
    pool_key = torch.full((S, Q, 2), EMPTY, dtype=i32, device=dev)
    pool_lost = torch.zeros(S, dtype=i32, device=dev)
    pool_pass_kernel_sharded(
        lay(vid_src), lay(vid_dst), weight, lay(rec_C.sum(dim=1)), zero,
        zero, ((~inserted) & (weight > 0)).to(i32), pool_key,
        torch.zeros((S, Q, 1), dtype=i32, device=dev),
        torch.zeros((S, Q, 1, 1), dtype=i32, device=dev), pool_lost,
        probes=cfg.pool_probes, seed=cfg.seed)
    del weight, zero, inserted
    _sync(dev)
    t1 = time.perf_counter()

    s_probes = pr.rows.shape[1]
    prow, pcol = pr.rows.long(), pr.cols.long()
    at = key[a[:, None], prow, pcol]  # [R, s, 2]: final keys, probe-major
    ok = (at == pr.keys[:, :, None]).reshape(R, 2 * s_probes)
    in_m = ok.any(dim=1)
    first = torch.argmax(ok.to(torch.uint8), dim=1)
    p, tz = first // 2, first % 2
    r_ = prow.gather(1, p[:, None])[:, 0]
    c_ = pcol.gather(1, p[:, None])[:, 0]
    del at, ok, prow, pcol
    seq = hsh.pool_slot_seq(vid_src, vid_dst, Q, cfg.pool_probes,
                            cfg.seed).long()
    pk = pool_key[a[:, None], seq]  # [R, probes, 2]
    pm = (pk[..., 0] == vid_src[:, None]) & (pk[..., 1] == vid_dst[:, None])
    in_p = ~in_m & pm.any(dim=1)
    q_ = seq.gather(1, torch.argmax(pm.to(torch.uint8), dim=1)[:, None])[:, 0]
    del pk, pm, seq

    kk, cc = rec_C.shape[1], rec_P.shape[2]
    C = torch.zeros((S, d, d, 2, kk), dtype=rec_C.dtype, device=dev)
    P = torch.zeros((S, d, d, 2, kk, cc), dtype=rec_P.dtype, device=dev)
    at_m = (a[in_m], r_[in_m], c_[in_m], tz[in_m])
    C.index_put_(at_m, rec_C[in_m], accumulate=True)
    P.index_put_(at_m, rec_P[in_m], accumulate=True)
    pool_C = torch.zeros((S, Q, kk), dtype=rec_C.dtype, device=dev)
    pool_P = torch.zeros((S, Q, kk, cc), dtype=rec_P.dtype, device=dev)
    at_p = (a[in_p], q_[in_p])
    pool_C.index_put_(at_p, rec_C[in_p], accumulate=True)
    pool_P.index_put_(at_p, rec_P[in_p], accumulate=True)
    _sync(dev)
    split.update(claim_s=t1 - t0, scatter_s=time.perf_counter() - t1)
    return key, C, P, pool_key, pool_C, pool_P, pool_lost


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _target(spec: SketchSpec, n_shards: int, routing, detector,
            heat_threshold) -> SketchSpec:
    """The spec the records are re-placed under: ``n_shards`` shards, the
    given routing table (else the spec's), pruned by the detector."""
    target = spec.replace(n_shards=n_shards)
    if routing is not None:
        target = target.replace(routing=routing)
    if detector is not None:
        effective = getattr(target, "routing", None)
        if effective:
            target = target.replace(
                routing=prune_routing(effective, detector, heat_threshold))
    return target


def _reshard(spec: SketchSpec, state: ShardedState, target: SketchSpec,
             card: bool) -> ShardedState:
    """Decode, route and replay under ``target``: by the kernels' wrappers
    (``card``) or by the plain host loop."""
    cfg = spec.config
    shards = state.live()
    dev = state.device
    split = {}
    t0 = time.perf_counter()
    vid_src, vid_dst, rec_C, rec_P = _decode_records(cfg, shards, card)
    vs_h, vd_h = vid_src.cpu().numpy(), vid_dst.cpu().numpy()
    split.update(records=int(vs_h.shape[0]),
                 decode_s=time.perf_counter() - t0)
    assign = routed_assignment_vids(target, vs_h, vd_h)
    n_shards = target.n_shards
    d = shards.key.shape[1]
    if card:
        leaves = _replay_claims(cfg, n_shards, assign, vid_src, vid_dst,
                                rec_C, rec_P, d, split)
    else:
        t1 = time.perf_counter()
        out = _replay(cfg, n_shards, assign, vs_h, vd_h,
                      rec_C.cpu().numpy(), rec_P.cpu().numpy(), d)
        leaves = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in out]
        split.update(claim_s=time.perf_counter() - t1, scatter_s=0.0)
    key, C, P, pool_key, pool_C, pool_P, pool_lost = leaves
    del vid_src, vid_dst, rec_C, rec_P

    # pre-reshard saturation losses are global history: shard 0 keeps them
    pool_lost = pool_lost.to(shards.pool_lost.dtype)
    pool_lost[0] += shards.pool_lost.sum().to(pool_lost.dtype)
    slot_widx = torch.amax(shards.slot_widx, dim=0)
    cur_widx = torch.amax(shards.cur_widx)
    RESHARD_SPLIT.clear()
    RESHARD_SPLIT.update(split)
    return ShardedState(LSketchState(
        key=key, C=C, P=P, pool_key=pool_key, pool_C=pool_C, pool_P=pool_P,
        pool_lost=pool_lost,
        slot_widx=slot_widx[None].expand(n_shards, -1).contiguous(),
        cur_widx=cur_widx.expand(n_shards).contiguous()))


def reshard(spec: SketchSpec, state: ShardedState, n_shards: int,
            routing=None, *, detector=None,
            heat_threshold: float | None = None) -> ShardedState:
    """Re-partition a handle's contents over ``n_shards`` balanced shards
    (see the module docstring); returns a fresh ``ShardedState`` for
    ``spec.replace(n_shards=n_shards)`` on the input's device, which is
    not consumed.

    ``routing`` (a ``RoutingTable``; default the spec's own) applies
    hot-key splits during the replay, so a ``recommend_budget`` table can
    be applied to stored history. ``detector`` with ``heat_threshold``
    un-splits the keys that cooled (``prune_routing``) before the replay;
    callers keep serving with ``spec.replace(n_shards=..., routing=
    pruned)``. A mesh-resident handle's rows are gathered first and the
    result is host-resident (it carries no ``MeshContext``), as the
    reference's is.
    """
    if spec.kind == "lgs":
        raise NotImplementedError(
            "LGS stores no keys — there is no key space to re-partition; "
            "restore keeps the merge-into-shard-0 path for LGS")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if (detector is None) != (heat_threshold is None):
        raise ValueError("detector and heat_threshold come together — the "
                         "un-split prune needs both the heat summary and "
                         "the threshold it was split under")
    target = _target(spec, n_shards, routing, detector, heat_threshold)
    if mesh_context(state) is not None:  # every rank reshards the stack
        state = ShardedState(fleet_shards(spec, state))
    return _reshard(spec, state, target, card=state.device.type == "cuda")
