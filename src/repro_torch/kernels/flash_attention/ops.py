"""Public wrapper for flash attention (counterpart of
``repro.kernels.flash_attention.ops.attention``).

``attention(q, k, v, causal, q_offset)`` is what the models call: the CUDA kernel
for tensors on the card, its plain version for tensors on the CPU
(``kernel.py``). The kernel masks ragged lengths itself, so nothing is
padded; as in the JAX wrapper, non-causal attention over a key length
that is not a multiple of its 128-row block raises.

Where a gradient is wanted (grad mode on and q, k or v requiring one) the
call goes through ``FlashAttention``, a ``torch.autograd.Function``: its
forward asks the kernel for the per-row log-sum-exp as well and saves q,
k, v, out and lse; its backward is ``flash_attention_backward_kernel``
(the backward kernels on the card, the plain backward on the CPU). Any
other call, serving's, writes no lse.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_backward_kernel, flash_attention_kernel

RAGGED_BLOCK = 128  # the JAX wrapper's key block (bk)


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        out, lse = flash_attention_kernel(q, k, v, causal, lse=True,
                                          q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_kernel(
            q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.q_offset)
        return dq, dk, dv, None, None


def attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """q: [B, Hq, Lq, dh]; k/v: [B, Hkv, Lk, dh] -> [B, Hq, Lq, dh];
    query row i at absolute position ``q_offset + i`` (causal)."""
    if not causal and k.shape[2] % RAGGED_BLOCK:
        raise ValueError("non-causal padding unsupported; pad kv upstream")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, q_offset)
    return flash_attention_kernel(q, k, v, causal, q_offset=q_offset)
