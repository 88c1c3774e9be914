"""Block-binned first-fit insert and the stream-order pool pass: CUDA
kernel wrappers and plain versions.

``sketch_insert_kernel_sharded`` replaces the TPU kernel
``repro/kernels/sketch_insert/kernel.py::sketch_insert_kernel_sharded``
(source: ``csrc/sketch_insert.cu``, a gather, a walk of one warp per
(shard, bin) over a shared-memory claim table, and a counter pass; what
bounds it is noted there). ``sketch_insert_plain`` is its vectorized
PyTorch twin (the counterpart of ``sketch_insert_stream_walk``): one step
walks edge ``t`` of every bin at once.

``pool_pass_kernel_sharded`` replaces the XLA ``while_loop`` of
``repro/kernels/sketch_insert/ops.py::_pool_pass`` (source:
``csrc/pool_pass.cu``: a compaction across the card, then one walk block
per shard in speculative rounds); ``pool_pass_plain`` is a loop over
``_pool_step``. Each wrapper takes its plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.

Contract (both versions, in place on ``key``/``C``/``P``):
  rows/cols/keys [S, B, s] absolute probe coordinates in stream order;
  w/le [S, B]; slot [S] each shard's ring slot; order [S, B] the stable
  bin sort; offs/counts [S, n^2] bin start and fill in the sorted stream;
  key [S, d, d, 2], C [S, d, d, 2, k], P [S, d, d, 2, k, c].
  Bin ``(sh, nb)`` walks its first ``min(counts, max_bin)`` edges.
  Returns ``inserted`` bool [S, B] in stream order.

Pool-pass contract (both versions, in place on the pool leaves
``pool_key`` [S, Q, 2], ``pool_C`` [S, Q, k], ``pool_P`` [S, Q, k, c],
``pool_lost`` [S]): ``pid_src``/``pid_dst``/``w_count``/``w_key``/``sl``/
``le``/``eligible`` [S, B] in stream order (``sl`` the item's ring slot,
``eligible`` 0/1); an item's pool probe slots are
``hashing.pool_slot_seq(pid_src, pid_dst, Q, probes, seed)``. Each
shard's eligible items are walked in stream order by ``_pool_step``'s
rule.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing as hsh
from repro_torch.core.types import EMPTY
from repro_torch.kernels import build

# the walk's claim table holds at most 2^13 claims a bin (2^14 slots);
# claims past it are read back from the key plane (csrc/sketch_insert.cu)
TABLE_LOG2_MAX = 14


def sketch_insert_plain(rows, cols, keys, w, le, slot, order, offs, counts,
                        key, C, P, max_bin: int):
    S, B, s = rows.shape
    nb2 = counts.shape[1]
    NB = S * nb2
    dev = rows.device
    cnt = counts.reshape(NB).clamp(max=max_bin)
    limit = int(cnt.max()) if NB else 0
    shard = torch.arange(NB, device=dev) // nb2
    base = shard * B + offs.reshape(NB)
    order_g = (order.long() + torch.arange(S, device=dev)[:, None] * B
               ).reshape(S * B)  # sorted position -> global stream index
    rows_f, cols_f, keys_f = (x.reshape(S * B, s) for x in (rows, cols, keys))
    w_f, le_f = w.reshape(S * B), le.reshape(S * B)
    tz2 = torch.arange(2, device=dev)
    inserted = torch.zeros(S * B, dtype=torch.bool, device=dev)
    for t in range(limit):
        live = t < cnt
        gi = order_g[(base + t).clamp(max=S * B - 1)]
        r, cc, kk = rows_f[gi].long(), cols_f[gi].long(), keys_f[gi]
        cur = key[shard[:, None, None], r[:, :, None], cc[:, :, None],
                  tz2[None, None, :]]  # [NB, s, 2], probe-major
        ok = ((cur == kk[:, :, None]) | (cur == EMPTY)).reshape(NB, 2 * s)
        w_t = w_f[gi]
        found = ok.any(1) & (w_t > 0) & live
        first = torch.argmax(ok.to(torch.uint8), dim=1)
        pi, tz = first // 2, first % 2
        sel = torch.nonzero(found).flatten()
        if sel.numel() == 0:
            continue
        sh, pis, tzs, g = shard[sel], pi[sel], tz[sel], gi[sel]
        rs = r[sel, pis]
        cs = cc[sel, pis]
        ws = w_t[sel]
        key[sh, rs, cs, tzs] = kk[sel, pis]
        sl = slot.long()[sh]
        C[sh, rs, cs, tzs, sl] += ws  # bins own disjoint cells: no repeats
        P[sh, rs, cs, tzs, sl, le_f[g].long()] += ws
        inserted[g] = True
    return inserted.reshape(S, B)


def claim_table_log2(counts, max_bin: int) -> int:
    """log2 of the walk's claim-table size: the smallest power of two at
    least twice the flush's largest walked bin fill (one host read),
    between 2 and 2^TABLE_LOG2_MAX."""
    fill = int(counts.clamp(max=max_bin).max()) if counts.numel() else 0
    return min(TABLE_LOG2_MAX, max(1, (2 * fill - 1).bit_length()))


def sketch_insert_kernel_sharded(rows, cols, keys, w, le, slot, order, offs,
                                 counts, key, C, P, max_bin: int):
    if key.device.type == "cpu":
        return sketch_insert_plain(rows, cols, keys, w, le, slot, order,
                                   offs, counts, key, C, P, max_bin)
    build.check_cuda(rows, cols, keys, w, le, slot, order, offs, counts,
                     key, C, P)
    S, B, s = rows.shape
    d, k, c = key.shape[1], C.shape[-1], P.shape[-1]
    dev = key.device
    log2t = claim_table_log2(counts, max_bin)
    inserted = torch.zeros((S, B), dtype=torch.int32, device=dev)
    g_pre, g_cell, g_key = (torch.empty((S, B, 2 * s), dtype=torch.int32,
                                        device=dev) for _ in range(3))
    g_w, land = (torch.empty((S, B), dtype=torch.int32, device=dev)
                 for _ in range(2))
    build.call("lsk_sketch_insert", rows, cols, keys, w, le, slot, order,
               offs, counts, key, C, P, inserted, g_pre, g_cell, g_key, g_w,
               land, S, B, s, d, counts.shape[1], k, c, max_bin, log2t)
    sketch_insert_kernel_sharded.launches += 1
    return inserted.bool()


sketch_insert_kernel_sharded.launches = 0


def _first(ok: torch.Tensor) -> torch.Tensor:
    return torch.argmax(ok.to(torch.uint8), dim=-1)


def _pool_step(pool_key, pool_C, pool_P, pool_lost, sidx, ps, pid_s, pid_d,
               w_count, w_key, sl, le, eligible) -> None:
    """One stream-order item of the additional pool, every shard at once
    and in place on the pool leaves (``ps`` [S, probes], the rest [S]): an
    ``eligible`` item with ``w_key`` > 0 claims the first of its pool slots
    that holds its key or is EMPTY and adds ``w_count`` there at ring slot
    ``sl`` and label ``le``; with no such slot its ``w_key`` goes to
    ``pool_lost``. Both insert routes walk their pool items by this rule."""
    pk = pool_key[sidx[:, None], ps]  # [S, probes, 2]
    pmatch = (pk[..., 0] == pid_s[:, None]) & (pk[..., 1] == pid_d[:, None])
    pok = pmatch | (pk[..., 0] == EMPTY)
    pany = pok.any(1)
    pfound = pany & eligible & (w_key > 0)
    pslot = torch.gather(ps, 1, _first(pok)[:, None])[:, 0]
    pold = pool_key[sidx, pslot]  # [S, 2]
    pool_key[sidx, pslot, 0] = torch.where(pfound, pid_s, pold[:, 0])
    pool_key[sidx, pslot, 1] = torch.where(pfound, pid_d, pold[:, 1])
    pw = torch.where(pfound, w_count, 0)
    pool_C[sidx, pslot, sl] += pw
    pool_P[sidx, pslot, sl, le] += pw
    pool_lost += torch.where(eligible & ~pany, w_key, 0)


def pool_pass_plain(pid_src, pid_dst, w_count, w_key, sl, le, eligible,
                    pool_key, pool_C, pool_P, pool_lost, *, probes: int,
                    seed: int) -> None:
    """The pool pass as a host loop: a stable sort puts each shard's
    eligible items first, in stream order; step ``t`` takes the ``t``-th
    of every shard, and a step past a shard's last one is a no-op."""
    eligible = eligible.bool()
    n = int(eligible.sum(1).max()) if eligible.numel() else 0
    if n == 0:
        return
    S = eligible.shape[0]
    ps = hsh.pool_slot_seq(pid_src, pid_dst, pool_key.shape[1], probes,
                           seed).long()
    order = torch.argsort((~eligible).to(torch.uint8), dim=1, stable=True)
    sidx = torch.arange(S, device=eligible.device)
    for t in range(n):
        i = order[:, t]
        _pool_step(pool_key, pool_C, pool_P, pool_lost, sidx, ps[sidx, i],
                   pid_src[sidx, i], pid_dst[sidx, i], w_count[sidx, i],
                   w_key[sidx, i], sl[sidx, i].long(), le[sidx, i].long(),
                   eligible[sidx, i])


# the columns of the pool kernel's optional stats buffer [S, 11] int64
# (csrc/pool_pass.cu): counts, then globaltimer ns stamps
POOL_STATS = ("rounds", "voided_same_pair", "voided_other", "items",
              "merged_same_pair", "t_compact0", "t_compact1", "t_walk0",
              "t_staged", "t_walked", "t_written")


def pool_stats_buffer(S: int, device) -> torch.Tensor:
    """A fresh stats buffer for one pool-kernel launch: zeros, and the
    compaction's start (a minimum over its blocks) at 2^62."""
    st = torch.zeros((S, len(POOL_STATS)), dtype=torch.int64, device=device)
    st[:, POOL_STATS.index("t_compact0")] = 1 << 62
    return st


def pool_stats_split(stats: torch.Tensor) -> dict:
    """Per-shard lists of the counts and of each stage's ns: compaction,
    the gap to the walk's start, the plane's staging, the walk and the
    write-back."""
    col = {n: stats[:, i].tolist() for i, n in enumerate(POOL_STATS)}
    span = lambda a, b: [y - x for x, y in zip(col[a], col[b])]  # noqa
    out = {n: col[n] for n in POOL_STATS[:5]}
    out.update(compaction_ns=span("t_compact0", "t_compact1"),
               gap_ns=span("t_compact1", "t_walk0"),
               stage_ns=span("t_walk0", "t_staged"),
               walk_ns=span("t_staged", "t_walked"),
               writeback_ns=span("t_walked", "t_written"))
    return out


def pool_pass_kernel_sharded(pid_src, pid_dst, w_count, w_key, sl, le,
                             eligible, pool_key, pool_C, pool_P, pool_lost,
                             *, probes: int, seed: int, stats=None) -> None:
    """``stats``: None, or a ``pool_stats_buffer`` on the card that the
    kernel fills (measurement only; the CPU path leaves it as it is)."""
    if pool_key.device.type == "cpu":
        return pool_pass_plain(pid_src, pid_dst, w_count, w_key, sl, le,
                               eligible, pool_key, pool_C, pool_P, pool_lost,
                               probes=probes, seed=seed)
    items = (pid_src, pid_dst, w_count, w_key, sl, le, eligible)
    build.check_cuda(*items, pool_key, pool_C, pool_P, pool_lost)
    S, B = pid_src.shape
    Q, k, c = pool_key.shape[1], pool_C.shape[-1], pool_P.shape[-1]
    if any(tuple(x.shape) != (S, B) for x in items) or \
            tuple(pool_key.shape) != (S, Q, 2) or \
            tuple(pool_lost.shape) != (S,):
        raise ValueError("pool pass: bad shapes")
    if stats is not None and (stats.device != pool_key.device or
                              stats.dtype != torch.int64 or
                              tuple(stats.shape) != (S, len(POOL_STATS))):
        raise ValueError("pool pass: bad stats buffer")
    # each item's 8-int record, then each 1024-item chunk's count
    scratch = torch.empty(S * B * 8 + S * -(-B // 1024), dtype=torch.int32,
                          device=pool_key.device)
    seed32 = ((seed & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000  # as C's int
    build.call("lsk_pool_pass", *items, pool_key, pool_C, pool_P, pool_lost,
               scratch, stats, S, B, probes, Q, k, c, seed32)
    pool_pass_kernel_sharded.launches += 1


pool_pass_kernel_sharded.launches = 0
