"""Flash attention: CUDA kernel wrapper and plain version.

``flash_attention_kernel`` replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_kernel`` (body
``_flash_body``; source ``csrc/flash_attention.cu``: FlashAttention-2 on
the tensor cores, one block of 4 warps per (batch x query head, 64-row
query tile; 8 above dh=128, a warp pair sharing each 16 rows), bf16 MMAs
for bf16 inputs and split-TF32 MMAs for f32 ones;
what bounds it is noted there). ``flash_attention_plain`` computes the
same function in plain PyTorch over blocks of query rows, so that a
block's scores ``[B, Hq, bq, Lk]`` fit on the card at the main path's
sizes. The wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.

Both compute what ``_flash_body`` computes: q scaled by 1/sqrt(dh) before
the dot, the causal mask on absolute positions with the TPU kernel's
top-left rule ``i >= j`` (masked scores -1e30; with ``q_offset``, query row
i sits at position ``q_offset + i`` and the rule is ``q_offset + i >= j``,
as the reference's ``_attn_block(..., q_offset, ...)``: a block of query
rows of a longer sequence, the sequence-parallel split of a layer), the result
``acc / max(l, 1e-30)`` cast to q's dtype, every sum in f32. Query head h
reads KV head ``h // (Hq // Hkv)``. The plain version widens bf16 inputs
to f32; the kernel's bf16 variant scales the f32 scores after the product
and rounds the softmax weights to bf16 for the product with V, and its
f32 variant keeps f32 accuracy by splitting every operand into two TF32
parts (``tests/test_torch_flash_numerics.py`` emulates both on the CPU).

q [B, Hq, Lq, dh]; k, v [B, Hkv, Lk, dh]; returns [B, Hq, Lq, dh] and,
when asked (``lse=True``), the per-row log-sum-exp of the scaled,
masked scores, f32 ``[B, Hq, Lq]``: what the backward reads to recompute
the softmax weights.

The backward (``flash_attention_backward_kernel``, source
``csrc/flash_attention_bwd.cu``) replaces no TPU kernel: the JAX kernel
has no VJP, and the JAX trainer differentiates its masked XLA attention.
It is the gradient of the same function, in two launches without atomics,
so a step is bitwise repeatable: dq and D (a block of 64 query rows walks
the key tiles), then dk and dv (a block of 64 keys walks its KV head's
query heads and their query tiles, computing the transposed score tile
so that P^T and dS^T feed its products as they stand). Every product runs
on the tensor cores through ``mma.sync``, with ``cp.async`` rings for the
streamed tiles: split-TF32 for f32 (hi and lo terms, each tile's sum
started from zero), bf16 MMAs for bf16 with P and dS rounded to bf16
(``tests/test_torch_flash_bwd_numerics.py`` emulates both). Its bound is
operations: 2.5 times the forward's flops, f32 as split-TF32's three
MMAs a product over 495 TFLOP/s, bf16 over 989; it does 14 dh flops a
kept pair against that bound's 10 (S and dP in both kernels), and what
it reaches and what remains (the FA3 shape, one S a tile pair) is in
``PERF.md``. ``flash_attention_backward_plain`` is its plain version,
with the explicit formulas.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 128, 256)  # the kernel's template instances
DTYPES = (torch.float32, torch.bfloat16)
PLAIN_BLOCK_Q = 512  # query rows per block of the plain version


def flash_attention_plain(q, k, v, causal: bool = True, lse: bool = False,
                          q_offset: int = 0):
    B, Hq, Lq, dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = 1.0 / (dh ** 0.5)
    # GQA without a repeat: query heads grouped under their KV head
    kf = k.float()[:, :, None]  # [B, Hkv, 1, Lk, dh]
    vf = v.float()[:, :, None]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse_out = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    j = torch.arange(Lk, device=q.device)
    for a in range(0, Lq, PLAIN_BLOCK_Q):
        z = min(a + PLAIN_BLOCK_Q, Lq)
        qb = q[:, :, a:z].float().reshape(B, Hkv, g, z - a, dh) * scale
        s = qb @ kf.transpose(-1, -2)  # [B, Hkv, g, bq, Lk]
        if causal:
            i = torch.arange(a, z, device=q.device) + q_offset
            s = s.masked_fill(i[:, None] < j[None, :], NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        acc = p @ vf
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[:, :, a:z] = (acc / l).reshape(B, Hq, z - a, dh).to(q.dtype)
        lse_out[:, :, a:z] = (m + torch.log(l)).reshape(B, Hq, z - a)
    return (out, lse_out) if lse else out


def flash_attention_backward_plain(q, k, v, out, lse, dout,
                                   causal: bool = True, q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention_plain``'s function, in plain
    PyTorch over blocks of PLAIN_BLOCK_Q query rows, every sum in f32:
    P = exp(S scale - lse) under the forward's top-left causal rule
    (masked P = 0), D = rowsum(dO o O), dV = P^T dO, dS = P o (dO V^T -
    D), dq = dS K scale, dK = dS^T q scale; dK and dV summed over each KV
    head's query group. The grads come back in q's dtype."""
    B, Hq, Lq, dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = 1.0 / (dh ** 0.5)
    kf = k.float()[:, :, None]  # [B, Hkv, 1, Lk, dh]
    vf = v.float()[:, :, None]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    j = torch.arange(Lk, device=q.device)
    for a in range(0, Lq, PLAIN_BLOCK_Q):
        z = min(a + PLAIN_BLOCK_Q, Lq)

        def grouped(x):
            return x[:, :, a:z].float().reshape(B, Hkv, g, z - a, -1)

        qb, ob, dob = grouped(q), grouped(out), grouped(dout)
        s = (qb @ kf.transpose(-1, -2)) * scale  # [B, Hkv, g, bq, Lk]
        p = torch.exp(s - grouped(lse[..., None]))
        if causal:
            i = torch.arange(a, z, device=q.device) + q_offset
            p = p.masked_fill(i[:, None] < j[None, :], 0.0)
        dv += (p.transpose(-1, -2) @ dob).sum(2, keepdim=True)
        dd = (dob * ob).sum(-1, keepdim=True)
        ds = p * (dob @ vf.transpose(-1, -2) - dd)
        dq[:, :, a:z] = ((ds @ kf) * scale).reshape(B, Hq, z - a, dh).to(
            q.dtype)
        dk += (ds.transpose(-1, -2) @ qb).sum(2, keepdim=True) * scale
    return dq, dk[:, :, 0].to(k.dtype), dv[:, :, 0].to(v.dtype)


def _check(q, k, v):
    for t in (q, k, v):
        if t.device.type != "cuda" or t.dtype not in DTYPES \
                or not t.is_contiguous() or t.dim() != 4:
            raise ValueError(f"flash attention takes contiguous 4-D f32 or "
                             f"bf16 CUDA tensors, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    if not (q.device == k.device == v.device
            and q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v differ in device or dtype")
    B, Hq, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh \
            or k.shape[1] == 0 or Hq % k.shape[1]:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} has no kernel instance "
                         f"(one of {HEAD_DIMS})")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash attention takes 16-byte aligned tensors "
                         "(the kernel copies 16 B at a time)")


def _check_offset(q_offset) -> None:
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"q_offset must be a non-negative int, got "
                         f"{q_offset!r}")


def flash_attention_kernel(q, k, v, causal: bool = True, lse: bool = False,
                           q_offset: int = 0):
    """out, or (out, lse) with ``lse``: serving passes no lse buffer and the
    kernel writes none."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, lse, q_offset)
    _check(q, k, v)
    _check_offset(q_offset)
    B, Hq, Lq, dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse_out = torch.empty((B, Hq, Lq), dtype=torch.float32,
                          device=q.device) if lse else None
    build.call("lsk_flash_attention", q, k, v, out, lse_out, B, Hq, Hkv, Lq,
               Lk, dh, int(causal), int(q.dtype == torch.bfloat16),
               int(q_offset))
    flash_attention_kernel.launches += 1
    return (out, lse_out) if lse else out


flash_attention_kernel.launches = 0


def flash_attention_backward_kernel(q, k, v, out, lse, dout,
                                    causal: bool = True, q_offset: int = 0):
    """(dq, dk, dv) by the two backward launches: ``lsk_flash_bwd_dq``
    (which writes D, f32 [B, Hq, Lq]) then ``lsk_flash_bwd_dkdv``. One
    launch of the pair adds one to ``launches``."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, dout, causal,
                                              q_offset)
    _check(q, k, v)
    _check_offset(q_offset)
    _check(out, dout, dout)  # device, dtype, layout and alignment
    if out.shape != q.shape or dout.shape != q.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must match q's "
                         f"{tuple(q.shape)} {q.dtype}")
    B, Hq, Lq, dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if lse.shape != (B, Hq, Lq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous f32 {(B, Hq, Lq)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} "
                         f"on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    bf16 = int(q.dtype == torch.bfloat16)
    build.call("lsk_flash_bwd_dq", q, k, v, out, dout, lse, delta, dq, B, Hq,
               Hkv, Lq, Lk, dh, int(causal), bf16, int(q_offset))
    build.call("lsk_flash_bwd_dkdv", q, k, v, dout, lse, delta, dk, dv, B,
               Hq, Hkv, Lq, Lk, dh, int(causal), bf16, int(q_offset))
    flash_attention_backward_kernel.launches += 1
    return dq, dk, dv


flash_attention_backward_kernel.launches = 0
