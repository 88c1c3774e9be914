"""Public wrapper for flash attention (counterpart of
``repro.kernels.flash_attention.ops.attention``).

``attention(q, k, v, causal)`` is what the models call: the CUDA kernel
for tensors on the card, its plain version for tensors on the CPU
(``kernel.py``). The kernel masks ragged lengths itself, so nothing is
padded; as in the JAX wrapper, non-causal attention over a key length
that is not a multiple of its 128-row block raises.
"""

from __future__ import annotations

from .kernel import flash_attention_kernel

RAGGED_BLOCK = 128  # the JAX wrapper's key block (bk)


def attention(q, k, v, causal: bool = True):
    """q: [B, Hq, Lq, dh]; k/v: [B, Hkv, Lk, dh] -> [B, Hq, Lq, dh]."""
    if not causal and k.shape[2] % RAGGED_BLOCK:
        raise ValueError("non-causal padding unsupported; pad kv upstream")
    return flash_attention_kernel(q, k, v, causal)
