"""Pure-Python LSketch oracle with the paper's *literal* prime-product
counter (port of ``repro.core.ref_prime``; no tensor anywhere).

The fidelity reference of the tensorized sketch:

  * cells are dicts (pointer realization, like the paper's C++);
  * counter P is an actual product of primes, decoded by repeated division
    (paper Algorithm 3, lines 5-8) — unbounded Python ints;
  * the sliding window is the paper's eager shift (Algorithm 2, lines 6-9):
    counter lists are literally shifted left when a subwindow expires;
  * probing order, twin cells and the pool fallback are those of the
    tensorized path (the same hash family, kept here as plain Python
    integer code; held bit for bit against ``core/hashing.py`` by the
    tests).

For any stream the tensorized sketch and this oracle agree exactly on
every query: the per-label counter vectors carry the same information as
the prime products.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .types import IDX_RADIX, LSketchConfig

MASK32 = 0xFFFFFFFF
M31 = 0x7FFFFFFF
LCG_T, LCG_I = 1103515245, 12345

# first 64 primes — the paper's "predefined list of prime numbers" P_r
PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
    151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227,
    229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311,
]


def mix32(x: int, seed: int) -> int:
    h = (x ^ (seed & MASK32)) & MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK32
    h ^= h >> 16
    return h


def hash31(x: int, seed: int) -> int:
    return mix32(x, seed) & M31


def lcg_next(x: int) -> int:
    return ((LCG_T * x) + LCG_I) & M31


def candidate_offsets(f: int, r: int) -> List[int]:
    outs, x = [], lcg_next(f)
    for _ in range(r):
        outs.append(x)
        x = lcg_next(x)
    return outs


def sample_pairs(fa: int, fb: int, r: int, s: int) -> List[Tuple[int, int]]:
    outs, x = [], lcg_next((fa + fb) & MASK32)
    for _ in range(s):
        outs.append(((x // r) % r, x % r))
        x = lcg_next(x)
    return outs


@dataclass
class _Cell:
    key: int  # packed (ia, ib, fa, fb)
    C: List[int]  # length k counter list (index k-1 = newest)
    P: List[int]  # length k prime products


@dataclass
class _PoolEntry:
    C: List[int]
    P: List[int]


class PrimeLSketch:
    """Paper-literal LSketch (dict cells, prime products, eager shift)."""

    def __init__(self, cfg: LSketchConfig):
        assert cfg.c <= len(PRIMES)
        self.cfg = cfg
        self.k = cfg.effective_k
        self.cells: Dict[Tuple[int, int, int], _Cell] = {}  # (row, col, twin)
        self.pool: Dict[Tuple[int, int], _PoolEntry] = {}
        self.pool_order: List[Tuple[int, int]] = []
        self.pool_lost = 0
        self.t_n: Optional[int] = None  # start widx of newest subwindow
        starts, widths = cfg.block_start_width()
        self._starts = [int(x) for x in starts]
        self._widths = [int(x) for x in widths]

    # ---- addressing (Algorithm 1) ----
    def _pre(self, v: int, label: int):
        cfg = self.cfg
        m = hash31(label, cfg.seed ^ 0x5B1D) % cfg.n_blocks
        start, width = self._starts[m], self._widths[m]
        h = hash31(v, cfg.seed)
        f = h % cfg.F
        s = (h // cfg.F) % width
        offs = candidate_offsets(f, cfg.r)
        vid = (m * 2048 + s) * cfg.F + f
        return m, start, width, s, f, offs, vid

    def _probes(self, pa, pb):
        cfg = self.cfg
        _, sa_start, sa_w, sa, fa, offa, _ = pa
        _, sb_start, sb_w, sb, fb, offb, _ = pb
        out = []
        for ai, bi in sample_pairs(fa, fb, cfg.r, cfg.s):
            row = sa_start + (sa + offa[ai]) % sa_w
            col = sb_start + (sb + offb[bi]) % sb_w
            key = (((ai * IDX_RADIX + bi) * cfg.F) + fa) * cfg.F + fb
            out.append((row, col, key))
        return out

    # ---- sliding window (Algorithm 2 lines 6-9, eager shift) ----
    def _advance(self, widx: int):
        if self.t_n is None:
            self.t_n = widx
            return
        steps = widx - self.t_n
        if steps <= 0:
            return
        for cell in self.cells.values():
            for _ in range(min(steps, self.k)):
                cell.C.pop(0); cell.C.append(0)
                cell.P.pop(0); cell.P.append(1)
        for ent in self.pool.values():
            for _ in range(min(steps, self.k)):
                ent.C.pop(0); ent.C.append(0)
                ent.P.pop(0); ent.P.append(1)
        self.t_n = widx

    # ---- insertion (Algorithm 2) ----
    def insert(self, a, b, la, lb, le, w, t):
        cfg = self.cfg
        widx = t // cfg.subwindow_size
        self._advance(widx)
        if widx < self.t_n:  # expired item (stream is ahead); ignore
            return
        pa, pb = self._pre(a, la), self._pre(b, lb)
        prime = PRIMES[hash31(le, cfg.seed ^ 0x77E1) % cfg.c]
        for row, col, key in self._probes(pa, pb):
            for tz in (0, 1):
                cell = self.cells.get((row, col, tz))
                if cell is None:
                    cell = _Cell(key, [0] * self.k, [1] * self.k)
                    self.cells[(row, col, tz)] = cell
                if cell.key == key:
                    cell.C[-1] += w
                    cell.P[-1] *= prime ** w
                    return
        # additional pool
        pk = (pa[6], pb[6])
        ent = self.pool.get(pk)
        if ent is None:
            if len(self.pool) >= cfg.pool_capacity:
                self.pool_lost += w
                return
            ent = _PoolEntry([0] * self.k, [1] * self.k)
            self.pool[pk] = ent
        ent.C[-1] += w
        ent.P[-1] *= prime ** w

    # ---- GETWEIGHTSINM (Algorithm 3): decode prime products ----
    def _weights(self, C: List[int], P: List[int], prime: Optional[int],
                 last: Optional[int]):
        lo = 0 if last is None else max(0, self.k - last)
        w = sum(C[lo:])
        if prime is None:
            return w, w
        wl = 0
        for p in P[lo:]:
            while p % prime == 0:
                wl += 1
                p //= prime
        return w, wl

    def _prime_of(self, le: int) -> int:
        return PRIMES[hash31(le, self.cfg.seed ^ 0x77E1) % self.cfg.c]

    # ---- queries ----
    def edge_weight(self, a, la, b, lb, le=None, last=None):
        pa, pb = self._pre(a, la), self._pre(b, lb)
        prime = None if le is None else self._prime_of(le)
        for row, col, key in self._probes(pa, pb):
            for tz in (0, 1):
                cell = self.cells.get((row, col, tz))
                if cell is None:  # empty slot: never inserted into matrix
                    return 0
                if cell.key == key:
                    w, wl = self._weights(cell.C, cell.P, prime, last)
                    return wl if le is not None else w
        ent = self.pool.get((pa[6], pb[6]))
        if ent is None:
            return 0
        w, wl = self._weights(ent.C, ent.P, prime, last)
        return wl if le is not None else w

    def vertex_weight(self, v, lv, le=None, direction="out", last=None):
        cfg = self.cfg
        m, start, width, s, f, offs, vid = self._pre(v, lv)
        prime = None if le is None else self._prime_of(le)
        total = 0
        lines = [start + (s + offs[i]) % width for i in range(cfg.r)]
        for (row, col, tz), cell in self.cells.items():
            line = row if direction == "out" else col
            if line not in lines:
                continue
            ia, ib, fa, fb = self._unpack(cell.key)
            idx = ia if direction == "out" else ib
            fp = fa if direction == "out" else fb
            # paper: match if the *stored* index maps this vertex to this line
            if fp != f or idx >= cfg.r:
                continue
            if (start + (s + offs[idx]) % width) != line:
                continue
            w, wl = self._weights(cell.C, cell.P, prime, last)
            total += wl if le is not None else w
        pcol = 0 if direction == "out" else 1
        for pk, ent in self.pool.items():
            if pk[pcol] == vid:
                w, wl = self._weights(ent.C, ent.P, prime, last)
                total += wl if le is not None else w
        return total

    def _unpack(self, key: int):
        fb = key % self.cfg.F
        rest = key // self.cfg.F
        fa = rest % self.cfg.F
        idx = rest // self.cfg.F
        return idx // IDX_RADIX, idx % IDX_RADIX, fa, fb
