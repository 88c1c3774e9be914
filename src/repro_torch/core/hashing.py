"""Vectorized integer hashing for LSketch, bit-identical to
``repro.core.hashing``.

The reference computes in wrapping uint32. PyTorch has no uint32
arithmetic on every backend, so each value is carried in int64 and
masked with ``& 0xFFFFFFFF`` after every step; a 32x32-bit product is
split into 16-bit halves so that no intermediate leaves int64. Floor
``//`` and ``%`` follow ``jnp``: ``torch.div(..., rounding_mode="floor")``
and ``torch.remainder``. Every public function returns int32 tensors.
"""

from __future__ import annotations

import torch

from .types import IDX_RADIX

LCG_T = 1103515245
LCG_I = 12345
M_MASK = 0x7FFFFFFF  # M = 2**31
_U32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """int64 holding the uint32 reinterpretation of int32 ``x``
    (``-1 -> 0xFFFFFFFF``, as ``jnp.astype(uint32)``)."""
    return torch.as_tensor(x).to(torch.int64) & _U32


def _mul32(h: torch.Tensor, const: int) -> torch.Tensor:
    """(h * const) mod 2**32 for h in [0, 2**32), without int64 overflow."""
    lo, hi = const & 0xFFFF, const >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (int32 overflow semantics)."""
    return (((x + 2**31) & _U32) - 2**31).to(torch.int32)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def mix32(x, seed: int) -> torch.Tensor:
    """Murmur3 finalizer with seed; returns the uint32 value in int64."""
    h = _u32(x) ^ (seed & _U32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash31(x, seed: int) -> torch.Tensor:
    """H(.) in [0, 2^31)."""
    return (mix32(x, seed) & M_MASK).to(torch.int32)


def fingerprint_split(h: torch.Tensor, F: int, width):
    """Split H(v) into (address s(v) in [0, width), fingerprint f(v))."""
    h = torch.as_tensor(h).to(torch.int32)
    f = torch.remainder(h, F)
    s = torch.remainder(_fdiv(h, F), torch.as_tensor(width).to(h.device))
    return s.to(torch.int32), f.to(torch.int32)


def lcg_next(x: torch.Tensor) -> torch.Tensor:
    """One linear-congruence step in [0, 2^31) (int64)."""
    return (LCG_T * _u32(x) + LCG_I) & M_MASK


def candidate_offsets(f: torch.Tensor, r: int) -> torch.Tensor:
    """Candidate list l_1..l_r seeded by fingerprint f: int32 [..., r]."""
    outs = []
    x = lcg_next(f)
    for _ in range(r):
        outs.append(x.to(torch.int32))
        x = lcg_next(x)
    return torch.stack(outs, dim=-1)


def sample_pairs(fa: torch.Tensor, fb: torch.Tensor, r: int, s: int):
    """Sampled probe subscripts (A_i, B_i), int32 [..., s] in [0, r)."""
    ai, bi = [], []
    x = lcg_next((_u32(fa) + _u32(fb)) & _U32)
    for _ in range(s):
        xi = x.to(torch.int32)
        ai.append(torch.remainder(_fdiv(xi, r), r))
        bi.append(torch.remainder(xi, r))
        x = lcg_next(x)
    return (torch.stack(ai, dim=-1).to(torch.int32),
            torch.stack(bi, dim=-1).to(torch.int32))


def pack_key(ia, ib, fa, fb, F: int) -> torch.Tensor:
    """((ia * IDX_RADIX + ib) * F + fa) * F + fb, with int32 wrap."""
    i64 = lambda v: torch.as_tensor(v).to(torch.int64)
    idx = _wrap32(i64(ia) * IDX_RADIX + i64(ib)).to(torch.int64)
    x = _wrap32(idx * F + i64(fa)).to(torch.int64)
    return _wrap32(x * F + i64(fb))


def unpack_key(key: torch.Tensor, F: int):
    """Inverse of pack_key -> (ia, ib, fa, fb). Undefined on EMPTY."""
    fb = torch.remainder(key, F)
    rest = _fdiv(key, F)
    fa = torch.remainder(rest, F)
    idx = _fdiv(rest, F)
    return (_fdiv(idx, IDX_RADIX), torch.remainder(idx, IDX_RADIX), fa, fb)


def pack_vertex_id(m, s, f, F: int) -> torch.Tensor:
    """(m * 2048 + s) * F + f, with int32 wrap."""
    i64 = lambda v: torch.as_tensor(v).to(torch.int64)
    x = _wrap32(i64(m) * 2048 + i64(s)).to(torch.int64)
    return _wrap32(x * F + i64(f))


def unpack_vertex_id(vid: torch.Tensor, F: int):
    f = torch.remainder(vid, F)
    rest = _fdiv(vid, F)
    return _fdiv(rest, 2048), torch.remainder(rest, 2048), f


def chain_select(f, idx, r: int) -> torch.Tensor:
    """``candidate_offsets(f, r)[..., idx]`` without the ``[..., r]``
    tensor: the LCG chain replayed ``r`` steps with the entry at ``idx``
    latched (int64; 0 where ``idx`` is outside ``[0, r)``)."""
    idx = torch.as_tensor(idx)
    x = lcg_next(f)
    sel = torch.zeros_like(x)
    for i in range(r):
        sel = torch.where(idx == i, x, sel)
        x = lcg_next(x)
    return sel


def decode_line_vid(lines, idx, f, starts, widths, r: int, F: int
                    ) -> torch.Tensor:
    """Invert one stored key side back to its packed vertex identity (the
    reversibility seam of ``repro.core.hashing.decode_line_vid``): a cell
    on absolute line ``lines`` whose key stores candidate index ``idx``
    and fingerprint ``f`` was addressed as
    ``line = start_m + (s + offs(f)[idx]) % width_m``, so
    ``s = (line - start_m - offs(f)[idx]) mod width_m``. The block is
    ``searchsorted(starts, line, right) - 1``; the difference wraps in
    int32 and the modulo is floor (``jnp`` semantics). Inputs broadcast;
    ``idx`` outside ``[0, r)`` (only on EMPTY cells, which callers mask)
    gives an unspecified identity."""
    lines = torch.as_tensor(lines).to(torch.int32)
    starts = torch.as_tensor(starts).to(torch.int32)
    widths = torch.as_tensor(widths).to(torch.int32)
    m = torch.searchsorted(starts, lines.contiguous(), right=True) - 1
    off = chain_select(f, idx, r)
    diff = _wrap32(lines.to(torch.int64) - starts[m].to(torch.int64) - off)
    s = torch.remainder(diff, widths[m])
    return pack_vertex_id(m, s, f, F)


def vertex_label_block(label, n_blocks: int, seed: int) -> torch.Tensor:
    """m = H(l) % n  (paper Algorithm 1, line 2)."""
    return torch.remainder(hash31(label, seed ^ 0x5B1D), n_blocks).to(
        torch.int32)


def edge_label_bucket(label, c: int, seed: int) -> torch.Tensor:
    """Edge-label bucket in [0, c)."""
    return torch.remainder(hash31(label, seed ^ 0x77E1), c).to(torch.int32)


def pool_slot_seq(pk_src, pk_dst, q: int, probes: int, seed: int):
    """Open-addressing probe sequence for the additional pool: [..., probes]."""
    h0 = mix32(_mul32(_u32(pk_src), 0x9E3779B9) ^ _u32(pk_dst),
               seed ^ 0x0031)
    base = torch.remainder((h0 & M_MASK), q)
    offs = torch.arange(probes, dtype=torch.int64, device=base.device)
    return torch.remainder(base[..., None] + offs, q).to(torch.int32)
