"""The pool kernel's walk (``csrc/pool_pass.cu``) emulated in numpy, with no
JAX: imported by ``tests/test_torch_insert_walk.py`` (against the plain
version and ``repro``) and by ``tests/test_torch_gpu.py`` (against the
kernel's stats buffer on the card)."""

import bisect

import numpy as np
import torch

from repro_torch.core import hashing as th
from repro_torch.core.types import EMPTY

CHUNK = 1024  # csrc/pool_pass.cu LSK_POOL_THREADS: the compaction's chunk
GROUP = 32  # items a round decides at most


def compact(elig, chunk=CHUNK):
    """The compaction across the card, then the walk's reads: each chunk
    of ``chunk`` items writes its eligible items at chunk-local ranks and
    its count; the walk finds rank g's chunk by a search over the chunk
    offsets. Returns the item indices in the order the walk reads them."""
    B = len(elig)
    n_chunks = -(-B // chunk)
    rec = np.full(n_chunks * chunk, -1, np.int64)
    counts = []
    for c in range(n_chunks):
        idx = np.flatnonzero(elig[c * chunk:(c + 1) * chunk]) + c * chunk
        rec[c * chunk:c * chunk + len(idx)] = idx
        counts.append(len(idx))
    coff = np.concatenate([[0], np.cumsum(counts)])
    n = int(coff[-1])
    # the kernel's binary search keeps coff[lo] <= g < coff[hi]
    order = [rec[(lo := bisect.bisect_right(coff, g) - 1) * chunk + g -
                 coff[lo]] for g in range(n)]
    return np.asarray(order, np.int64)


def emulate_pool_rounds(pid_s, pid_d, w_count, w_key, sl, le, elig,
                        pool_key, pool_C, pool_P, lost, *, probes, seed,
                        same_pair=True, chunk=CHUNK):
    """The pool kernel's walk (numpy, in place on the pool leaves): each
    shard's eligible items in the compaction's order, 32 a group, in
    speculative rounds that decide from the pool at the round's start.
    A lane whose claimed slot an earlier lane claims voids the round from
    it on, unless (``same_pair``) it carries the pair of the slot's first
    claimer: then it adds there without claiming. ``same_pair=False`` is
    the rule of the one-block kernel before it. Returns per-shard stats:
    rounds, rounds voided by a lane carrying its slot's first claimer's
    pair and by another lane, lanes committed by the same-pair rule."""
    ps = th.pool_slot_seq(torch.from_numpy(pid_s.astype(np.int32)),
                          torch.from_numpy(pid_d.astype(np.int32)),
                          pool_key.shape[1], probes, seed).numpy()
    S = pid_s.shape[0]
    stats = {k: [0] * S for k in ("rounds", "voided_same_pair",
                                  "voided_other", "merged_same_pair")}
    for sh in range(S):
        items = compact(elig[sh], chunk)
        assert np.array_equal(items, np.flatnonzero(elig[sh]))
        pk = pool_key[sh]
        pair = lambda i: (pid_s[sh, i], pid_d[sh, i])  # noqa: E731
        for g0 in range(0, len(items), GROUP):
            group = items[g0:g0 + GROUP]
            start = 0
            while start < len(group):
                dec = {}
                for j in range(start, len(group)):
                    i = group[j]
                    for q in ps[sh, i]:
                        if pk[q, 0] == EMPTY:
                            dec[j] = (q, w_key[sh, i] > 0)
                            break
                        if (pk[q, 0], pk[q, 1]) == pair(i):
                            dec[j] = (q, False)
                            break
                end, first, merged = len(group), {}, set()
                for j in range(start, len(group)):
                    if j not in dec or not dec[j][1]:
                        continue
                    q = dec[j][0]
                    if q not in first:
                        first[q] = j
                        continue
                    same = pair(group[first[q]]) == pair(group[j])
                    if same and same_pair:
                        merged.add(j)
                        continue
                    end = j
                    stats["voided_same_pair" if same else
                          "voided_other"][sh] += 1
                    break
                for j in range(start, end):
                    i = group[j]
                    if j not in dec:
                        lost[sh] += w_key[sh, i]
                    elif w_key[sh, i] > 0:
                        q, claim = dec[j]
                        if claim and j not in merged:
                            pk[q] = pair(i)
                        pool_C[sh, q, sl[sh, i]] += w_count[sh, i]
                        pool_P[sh, q, sl[sh, i], le[sh, i]] += w_count[sh, i]
                stats["merged_same_pair"][sh] += len(merged & set(
                    range(start, end)))
                stats["rounds"][sh] += 1
                start = end
    return stats
