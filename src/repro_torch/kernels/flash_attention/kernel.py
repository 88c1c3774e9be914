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
top-left rule ``i >= j`` (masked scores -1e30), the result
``acc / max(l, 1e-30)`` cast to q's dtype, every sum in f32. Query head h
reads KV head ``h // (Hq // Hkv)``. The plain version widens bf16 inputs
to f32; the kernel's bf16 variant scales the f32 scores after the product
and rounds the softmax weights to bf16 for the product with V, and its
f32 variant keeps f32 accuracy by splitting every operand into two TF32
parts (``tests/test_torch_flash_numerics.py`` emulates both on the CPU).

q [B, Hq, Lq, dh]; k, v [B, Hkv, Lk, dh]; returns [B, Hq, Lq, dh].
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 128, 256)  # the kernel's template instances
DTYPES = (torch.float32, torch.bfloat16)
PLAIN_BLOCK_Q = 512  # query rows per block of the plain version


def flash_attention_plain(q, k, v, causal: bool = True):
    B, Hq, Lq, dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = 1.0 / (dh ** 0.5)
    # GQA without a repeat: query heads grouped under their KV head
    kf = k.float()[:, :, None]  # [B, Hkv, 1, Lk, dh]
    vf = v.float()[:, :, None]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    j = torch.arange(Lk, device=q.device)
    for a in range(0, Lq, PLAIN_BLOCK_Q):
        z = min(a + PLAIN_BLOCK_Q, Lq)
        qb = q[:, :, a:z].float().reshape(B, Hkv, g, z - a, dh) * scale
        s = qb @ kf.transpose(-1, -2)  # [B, Hkv, g, bq, Lk]
        if causal:
            i = torch.arange(a, z, device=q.device)
            s = s.masked_fill(i[:, None] < j[None, :], NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        acc = p @ vf
        o = acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[:, :, a:z] = o.reshape(B, Hq, z - a, dh).to(q.dtype)
    return out


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


def flash_attention_kernel(q, k, v, causal: bool = True):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    _check(q, k, v)
    B, Hq, Lq, dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    build.call("lsk_flash_attention", q, k, v, out, B, Hq, Hkv, Lq, Lk, dh,
               int(causal), int(q.dtype == torch.bfloat16))
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
