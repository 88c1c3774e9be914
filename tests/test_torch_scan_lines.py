"""The line-major vertex scan's arithmetic on the CPU, against the JAX
package (exact int32 equality).

``emulate_line_scan`` replays ``csrc/vertex_scan.cu`` in numpy: a counting
sort of the nq x r (query, candidate index) references by line (a
histogram that ranks each reference in its line, an exclusive scan, a
scatter), then per (line, shard) for ``out`` and per (tile of 32
columns, shard) for ``in`` the block's references in chunks, each chunk
a table of their distinct match keys ((f, i), and the column in the tile
for ``in``);
every occupied cell of the tile's referenced lines is decoded once and
adds cw to its key's sum and its pw vector to the key's per-label sums;
each chunk ends with one uint32 add per reference of its key's sum and
of its label's. It is held equal to
``vertex_scan_plain``, to ``repro``'s ``vertex_scan_xla`` and to the
interpreted Pallas ``vertex_scan_kernel_sharded``. The CUDA kernel itself
is held against the plain version on the card by
``tests/test_torch_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vertex_scan.kernel import (vertex_scan_kernel_sharded,
                                              vertex_scan_xla)

from repro_torch.core import hashing as th
from repro_torch.kernels.vertex_scan.kernel import vertex_scan_plain

EMPTY = -1
IDX_RADIX = 16
TILE = 32
CHUNK = 512  # csrc/vertex_scan.cu LSK_SCAN_CHUNK
OUT_CHUNK = 128  # LSK_SCAN_OUT_CHUNK
OUT_LINES = 1  # rows of an "out" block: one line
LSUMS = 7680  # LSK_SCAN_LSUMS


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _u32(x):
    return np.asarray(x, dtype=np.int64) & 0xFFFFFFFF


def line_sort(lines, d):
    """The counting sort: (offsets [d + 1], references in line order).
    Reference t is query t // r at candidate index t % r; a line outside
    [0, d) is left out."""
    flat = np.asarray(lines, dtype=np.int64).reshape(-1)
    cnt = np.zeros(d, np.int64)
    rank = np.full(flat.size, -1, np.int64)
    for t, line in enumerate(flat):  # the histogram's atomic ranks
        if 0 <= line < d:
            rank[t] = cnt[line]
            cnt[line] += 1
    off = np.zeros(d + 1, np.int64)
    off[1:] = np.cumsum(cnt)
    order = np.empty(off[d], np.int64)
    for t, line in enumerate(flat):
        if rank[t] >= 0:
            order[off[line] + rank[t]] = t
    return off, order


def kernel_chunk(c, with_le, direction):
    """References a block takes at once: the chunk of its direction, cut
    so that a chunk's per-label sums fit LSK_SCAN_LSUMS."""
    most = CHUNK if direction == "in" else OUT_CHUNK
    return min(most, LSUMS // c) if with_le else most


def emulate_line_scan(lines, f, le, key_plane, cw, pw, *, r, F, direction,
                      chunk=None, merge_per_q_line=False):
    """The CUDA kernel's steps (``chunk``: the kernel's by default).
    Returns (w, w_label) int32 [S, nq] and stats (groups walked, chunks,
    the largest reference count on one group). ``merge_per_q_line`` is a
    mutation: it keeps one reference per (query, line)."""
    key_plane, cw, pw = (np.asarray(x, np.int64) for x in (key_plane, cw,
                                                           pw))
    S, _, d, _ = key_plane.shape
    nq = len(f)
    chunk = chunk or kernel_chunk(pw.shape[-1], le is not None, direction)
    flat = np.asarray(lines, np.int64).reshape(-1)
    off, order = line_sort(lines, d)
    if merge_per_q_line:
        seen, kept = set(), []
        for t in order:
            if (t // r, flat[t]) not in seen:
                seen.add((t // r, flat[t]))
                kept.append(t)
        order = np.asarray(kept, np.int64)
        off = np.searchsorted(flat[order], np.arange(d + 1))
    w = np.zeros((S, nq), np.int64)
    wl = np.zeros((S, nq), np.int64)
    width = TILE if direction == "in" else OUT_LINES
    groups = [(g0, off[g0], off[min(g0 + width, d)])
              for g0 in range(0, d, width)]
    stats = {"groups": 0, "chunks": 0, "largest": 0}
    for g0, lo, hi in groups:
        if hi == lo:
            continue  # the block exits at once
        stats["groups"] += 1
        stats["largest"] = max(stats["largest"], int(hi - lo))
        for sh in range(S):
            if direction == "out":  # the line's 2 x d cells, read once
                rows = [j for j in range(g0, min(g0 + width, d))
                        if off[j + 1] > off[j]]
                kv = key_plane[sh][:, rows]  # [2, rows, d]
                cwv, pwv = cw[sh][:, rows], pw[sh][:, rows]
                col = np.broadcast_to(
                    (np.asarray(rows) - g0)[None, :, None], kv.shape)
            else:  # the tile's 2 x d rows of 32 columns
                cols = slice(g0, min(g0 + TILE, d))
                kv = key_plane[sh, :, :, cols]
                cwv, pwv = cw[sh, :, :, cols], pw[sh, :, :, cols, :]
                col = np.broadcast_to(np.arange(kv.shape[-1]), kv.shape)
            occ = kv != EMPTY
            rest = kv // F
            idx = rest // F
            if direction == "out":
                ci, cf = idx // IDX_RADIX, rest % F
            else:
                ci, cf = idx % IDX_RADIX, kv % F
            live = occ & (ci >= 0) & (ci < r)
            ckey = (cf * r + ci) * width + col
            for c0 in range(lo, hi, chunk):
                stats["chunks"] += sh == 0
                refs = order[c0:min(c0 + chunk, hi)]
                # the chunk's distinct keys, each summing cw and (with the
                # label) its per-label pw; duplicates share a key
                ref_key, kw, kwl = {}, {}, {}
                for ref in refs:
                    q, i = divmod(int(ref), r)
                    if not 0 <= f[q] < F:
                        continue
                    k = (int(f[q]) * r + i) * width + int(flat[ref]) - g0
                    ref_key[int(ref)] = k
                    kw[k] = 0
                    kwl[k] = np.zeros(pw.shape[-1], np.int64)
                hit = live & np.isin(ckey, list(kw))
                for pos in zip(*np.nonzero(hit)):
                    k = int(ckey[pos])
                    kw[k] = _u32(kw[k] + cwv[pos])
                    kwl[k] = _u32(kwl[k] + pwv[pos])
                for ref in refs:  # one add per reference
                    q = int(ref) // r
                    k = ref_key.get(int(ref))
                    if k is None:
                        continue
                    w[sh, q] = _u32(w[sh, q] + kw[k])
                    if le is not None:
                        wl[sh, q] = _u32(wl[sh, q] + kwl[k][le[q]])
    to32 = lambda x: x.astype(np.uint32).view(np.int32)  # noqa: E731
    return to32(w), to32(wl), stats


def _planes(rng, S, d, c, r, F, neg=False):
    """Packed keys (about half the cells EMPTY) with candidate indices
    below r and small fingerprints, so queries match often."""
    shape = (S, 2, d, d)
    key = th.pack_key(*[_t(rng.integers(0, hi, shape))
                        for hi in (r, r, F, F)], F).numpy()
    key[rng.random(shape) < 0.5] = EMPTY
    if neg:  # negative non-EMPTY keys: the floor decode
        sel = rng.random(shape) < 0.2
        key[sel] = -rng.integers(2, 30000, int(sel.sum()))
    cw = rng.integers(0, 1 << 30, shape).astype(np.int32)  # sums wrap
    pw = rng.integers(0, 1 << 30, shape + (c,)).astype(np.int32)
    return key.astype(np.int32), cw, pw


def _case(name, S, rng):
    """(lines [nq, r], f, le, key, cw, pw, r, F) of one case."""
    r, F, c = 4, 4, 3
    d = {"sparse-tiles": 128, "ragged-d": 70}.get(name, 64)
    if name == "ragged-d":  # a last column tile of 6; F not a power of 2
        F = 3
    nq = 24
    key, cw, pw = _planes(rng, S, d, c, r, F, neg=name == "negative-keys")
    lines = rng.integers(0, d, (nq, r))
    f = rng.integers(0, F, nq)
    le = rng.integers(0, c, nq)
    if name == "two-i":  # one query names one line at two values of i
        lines[:, 1] = lines[:, 0]
        lines[3, 3] = lines[3, 0]
    elif name == "duplicates":
        lines[8:16], f[8:16], le[8:16] = lines[:8], f[:8], le[:8]
    elif name == "hub":  # one line shared by every query: many chunks
        nq = CHUNK + 88
        lines = rng.integers(0, d, (nq, r))
        lines[:, 2] = 5
        f, le = rng.integers(0, F, nq), rng.integers(0, c, nq)
    elif name == "sparse-tiles":  # references in one tile only
        lines = rng.integers(40, 64, (nq, r))
    elif name == "f-out-of-range":
        f[::5] = F + 3
    return lines.astype(np.int32), f.astype(np.int32), le.astype(np.int32), \
        key, cw, pw, r, F


def _pallas(lines, f, le, key, cw, pw, *, r, F, direction):
    """The interpreted TPU kernel, as ``repro``'s ops call it: ``in``
    transposes the planes and swaps the packed fields (valid keys only)."""
    if direction == "in":
        occ = key != EMPTY
        ia, ib, fa, fb = th.unpack_key(_t(key), F)
        key = np.where(occ, th.pack_key(ib, ia, fb, fa, F).numpy(), key)
        key, cw = (np.swapaxes(x, 2, 3) for x in (key, cw))
        pw = np.swapaxes(pw, 2, 3)
    nq = len(f)
    w, wl = vertex_scan_kernel_sharded(
        *map(jnp.asarray, (lines, f, le, key, cw, pw)), n_shards=key.shape[0],
        r=r, F=F, c=pw.shape[-1], chunk=nq, interpret=True)
    return np.asarray(w), np.asarray(wl)


CASES = ["two-i", "duplicates", "hub", "sparse-tiles", "negative-keys",
         "f-out-of-range", "ragged-d"]


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("direction", ["out", "in"])
def test_line_scan_emulation_matches_plain_xla_and_pallas(direction, case,
                                                         S):
    rng = np.random.default_rng(len(case) + 7 * S)
    lines, f, le, key, cw, pw, r, F = _case(case, S, rng)
    kw = dict(r=r, F=F, direction=direction)
    pallas = _pallas(lines, f, le, key, cw, pw, **kw) \
        if case != "negative-keys" or direction == "out" else None
    for lab in (le, None):
        xla = vertex_scan_xla(*map(jnp.asarray, (lines, f)),
                              None if lab is None else jnp.asarray(lab),
                              *map(jnp.asarray, (key, cw, pw)), **kw)
        plain = vertex_scan_plain(_t(lines), _t(f),
                                  None if lab is None else _t(lab),
                                  *map(_t, (key, cw, pw)), **kw)
        # the kernel's chunk, and a small one that splits the hub line
        for chunk in (None, 37):
            w, wl, stats = emulate_line_scan(lines, f, lab, key, cw, pw,
                                             chunk=chunk, **kw)
            np.testing.assert_array_equal(w, plain[0].numpy())
            np.testing.assert_array_equal(wl, plain[1].numpy())
            np.testing.assert_array_equal(w, np.asarray(xla[0]))
            np.testing.assert_array_equal(wl, np.asarray(xla[1]))
            if pallas is not None:
                np.testing.assert_array_equal(w, pallas[0])
                if lab is not None:
                    np.testing.assert_array_equal(wl, pallas[1])
        assert (w != 0).any()  # the case matches something
    if case == "hub":
        assert stats["largest"] >= len(f) > 5
        assert stats["chunks"] > stats["groups"]
    if case == "sparse-tiles":
        n_tiles = -(-key.shape[2] // TILE)
        assert stats["groups"] < (n_tiles if direction == "in"
                                  else key.shape[2])


def test_line_sort_groups_every_reference_by_line():
    lines = np.array([[3, 1, 3], [0, 3, 7], [3, 3, 1]])
    off, order = line_sort(lines, 8)
    assert off.tolist() == [0, 1, 3, 3, 8, 8, 8, 8, 9]
    flat = lines.reshape(-1)
    assert sorted(order.tolist()) == list(range(9))
    assert flat[order].tolist() == sorted(flat.tolist())
    # a line outside [0, d) is left out
    off, order = line_sort(np.array([[2, 9]]), 4)
    assert order.tolist() == [0] and off[-1] == 1


@pytest.mark.parametrize("direction", ["out", "in"])
def test_merging_references_per_query_and_line_is_caught(direction):
    """The mutation the design rules out: one reference per (query, line)
    loses the second candidate index of a query that names one line
    twice, and the comparison with the plain version catches it."""
    rng = np.random.default_rng(3)
    lines, f, le, key, cw, pw, r, F = _case("two-i", 2, rng)
    kw = dict(r=r, F=F, direction=direction)
    plain = vertex_scan_plain(*map(_t, (lines, f, le, key, cw, pw)), **kw)
    w, wl, _ = emulate_line_scan(lines, f, le, key, cw, pw, **kw)
    np.testing.assert_array_equal(w, plain[0].numpy())
    bad, _, _ = emulate_line_scan(lines, f, le, key, cw, pw,
                                  merge_per_q_line=True, **kw)
    assert not np.array_equal(bad, plain[0].numpy())
