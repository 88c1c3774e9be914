"""LSketch's hashing and addressing in plain NumPy (the paper's Algorithm 1
and Eq. 3/4), written from the sketch's published rules: murmur3's
finalizer with a seed, the 31-bit linear congruence for candidate lists
and probe pairs, the packed keys and vertex identities, the label blocks,
the edge-label buckets, the pool's open-addressing sequence and the shard
hash. Every value is computed in wrapping 32-bit arithmetic (NumPy uint32,
or int64 masked to 32 bits) and returned as int64 arrays.
"""

from __future__ import annotations

import numpy as np

EMPTY = -1
IDX_RADIX = 16
_U32 = 0xFFFFFFFF
_M31 = 0x7FFFFFFF
_LCG_T, _LCG_I = 1103515245, 12345
_SHARD_SALT = 0x51AD


def _u32(x) -> np.ndarray:
    return np.asarray(x, np.int64) & _U32


def _mul32(x, const: int) -> np.ndarray:
    """(x * const) mod 2**32, as int64."""
    return ((_u32(x).astype(np.uint64) * np.uint64(const)) &
            np.uint64(_U32)).astype(np.int64)


def _wrap32(x) -> np.ndarray:
    """int64 values wrapped to the int32 range (two's complement)."""
    return ((np.asarray(x, np.int64) + 2**31) & _U32) - 2**31


def mix32(x, seed: int) -> np.ndarray:
    """Murmur3's 32-bit finalizer of ``x`` xor ``seed`` (uint32 in int64)."""
    h = (_u32(x) ^ (seed & _U32)).astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h.astype(np.int64)


def hash31(x, seed: int) -> np.ndarray:
    return mix32(x, seed) & _M31


def lcg_next(x) -> np.ndarray:
    return (_LCG_T * _u32(x) + _LCG_I) & _M31


def candidate_offsets(f, r: int) -> np.ndarray:
    """The candidate list l_1..l_r of fingerprint ``f``: ``[..., r]``."""
    out, x = [], lcg_next(f)
    for _ in range(r):
        out.append(x)
        x = lcg_next(x)
    return np.stack(out, -1)


def sample_pairs(fa, fb, r: int, s: int):
    """The s sampled subscript pairs (i_A, i_B) in [0, r): ``[..., s]``."""
    ai, bi = [], []
    x = lcg_next((_u32(fa) + _u32(fb)) & _U32)
    for _ in range(s):
        ai.append((x // r) % r)
        bi.append(x % r)
        x = lcg_next(x)
    return np.stack(ai, -1), np.stack(bi, -1)


def pack_key(ia, ib, fa, fb, F: int) -> np.ndarray:
    idx = _wrap32(np.asarray(ia, np.int64) * IDX_RADIX + ib)
    return _wrap32(_wrap32(idx * F + fa) * F + fb)


def unpack_key(key, F: int):
    key = np.asarray(key, np.int64)
    rest = key // F
    idx = rest // F
    return idx // IDX_RADIX, idx % IDX_RADIX, rest % F, key % F


def pack_vertex_id(m, s, f, F: int) -> np.ndarray:
    return _wrap32(_wrap32(np.asarray(m, np.int64) * 2048 + s) * F + f)


def vertex_block(cfg, label) -> np.ndarray:
    return hash31(label, cfg.seed ^ 0x5B1D) % cfg.n_blocks


def edge_label_bucket(cfg, label) -> np.ndarray:
    return hash31(label, cfg.seed ^ 0x77E1) % cfg.c


def pool_slots(cfg, pid_src, pid_dst) -> np.ndarray:
    """The pool's probe sequence of an edge's packed endpoint ids:
    ``[..., pool_probes]`` slots."""
    h = mix32(_mul32(pid_src, 0x9E3779B9) ^ _u32(pid_dst), cfg.seed ^ 0x0031)
    base = (h & _M31) % cfg.pool_capacity
    return (base[..., None] + np.arange(cfg.pool_probes)) % \
        cfg.pool_capacity


def addressing(cfg, v, label):
    """Algorithm 1 for vertices ``v`` with labels ``label``: a dict of the
    block ``m``, its ``start`` and ``width``, the address ``s``, the
    fingerprint ``f``, the candidate offsets ``offs`` ``[..., r]``, the
    candidate lines ``lines`` ``[..., r]`` and the packed identity
    ``vid``. Blocks are uniform (``d / n_blocks`` wide)."""
    b = cfg.d // cfg.n_blocks
    m = vertex_block(cfg, label)
    h = hash31(v, cfg.seed)
    s = (h // cfg.F) % b
    f = h % cfg.F
    offs = candidate_offsets(f, cfg.r)
    # the address plus an offset wraps in 32 bits before the floor modulo
    lines = m[..., None] * b + _wrap32(s[..., None] + offs) % b
    return dict(m=m, start=m * b, width=b, s=s, f=f, offs=offs, lines=lines,
                vid=pack_vertex_id(m, s, f, cfg.F))


def edge_probes(cfg, src, la, dst, lb):
    """Eq. 3/4: the s probe cells and candidate keys of each edge
    (``rows``, ``cols``, ``keys`` ``[n, s]``) and its pool ids."""
    pa, pb = addressing(cfg, src, la), addressing(cfg, dst, lb)
    ai, bi = sample_pairs(pa["f"], pb["f"], cfg.r, cfg.s)
    off_a = np.take_along_axis(pa["offs"], ai, -1)
    off_b = np.take_along_axis(pb["offs"], bi, -1)
    b = cfg.d // cfg.n_blocks
    rows = pa["start"][..., None] + _wrap32(pa["s"][..., None] + off_a) % b
    cols = pb["start"][..., None] + _wrap32(pb["s"][..., None] + off_b) % b
    keys = pack_key(ai, bi, pa["f"][..., None], pb["f"][..., None], cfg.F)
    return dict(rows=rows, cols=cols, keys=keys, pid_src=pa["vid"],
                pid_dst=pb["vid"], tile=pa["m"] * cfg.n_blocks + pb["m"])


def shard_of(cfg, n_shards: int, src, src_label) -> np.ndarray:
    """The home shard of each edge: the source entity's hash."""
    if n_shards == 1:
        return np.zeros(np.shape(src), np.int64)
    mixed = _mul32(src, 2654435761) ^ ((_u32(src_label) << 9) & _U32)
    return hash31(mixed, cfg.seed ^ _SHARD_SALT) % n_shards
