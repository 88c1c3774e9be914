"""ModelConfig — one dataclass describing every architecture (same fields,
defaults and check as ``repro.models.config.ModelConfig``, with torch
dtypes).

``attn_impl`` picks the full-sequence attention of ``gqa_train``:
``"kernel"`` (the default) goes through the flash-attention wrapper — the
CUDA kernel for tensors on the card, its plain version for tensors on the
CPU — and ``"plain"`` through ``_masked_attention`` (the JAX package's
``"xla"`` path). The JAX default is its plain path because "TPU
deployments flip the config flag"; the port's deployment is the card, so
its default is the kernel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch

ATTN_IMPLS = ("kernel", "plain")


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 2
    d_head: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab_size: int = 1024

    # attention flavor
    attention: str = "gqa"  # gqa | mla
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 = global; >0 = local window (tokens)
    global_every: int = 0  # gemma3: 1 global layer per this many (0 = all global)
    kv_lora_rank: int = 0  # MLA
    q_lora_rank: int = 0
    rope_dim: int = 64  # MLA decoupled rope head dim

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0  # leading dense layers (deepseek style)
    capacity_factor: float = 1.25
    moe_every: int = 1  # apply MoE every Nth layer (jamba: 2)

    # hybrid / ssm
    layer_pattern: Tuple[str, ...] = ()  # e.g. ("attn","mamba",...) period
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    mlstm_chunk: int = 64

    # enc-dec
    encoder_layers: int = 0

    # modality frontend stubs
    frontend: str = ""  # "" | vision | audio
    frontend_len: int = 0  # patches/frames prepended (vision) or enc len

    # numerics
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: str = "none"  # none | full | dots (the reference's activation
    # rematerialisation; the port's trainer does not rematerialise)
    attn_impl: str = "kernel"  # kernel | plain
    # storage dtype of the [B,H,Sq,Sk] score/prob tensors of the plain
    # attention; the softmax itself always reduces in f32
    attn_mat_dtype: Any = torch.float32

    def __post_init__(self):
        if self.n_heads % max(1, self.n_kv_heads) != 0:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / local-attn)."""
        return (self.family in ("ssm", "hybrid")
                or (self.sliding_window > 0 and self.global_every > 0))

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic total parameter count (as the JAX package counts it)."""
        D, H, KV, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        V, F = self.vocab_size, self.d_ff
        emb = V * D * (1 if self.tie_embeddings else 2)

        def attn_params():
            if self.attention == "mla":
                r, qr, rd = self.kv_lora_rank, self.q_lora_rank or D, self.rope_dim
                return (D * qr + qr * H * dh            # q path
                        + D * (r + rd)                  # kv down + rope
                        + r * H * (dh + dh)             # k,v up
                        + H * dh * D)                   # out
            return D * H * dh + 2 * D * KV * dh + H * dh * D

        def mlp_params(ff):
            return 3 * D * ff  # swiglu

        def mamba_params():
            di = self.ssm_expand * D
            return (2 * D * di + di * self.ssm_conv_dim
                    + di * (2 * self.ssm_state_dim + 2) + di * D)

        def mlstm_params():
            di = self.ssm_expand * D
            return 2 * D * di + 3 * di * di // max(1, H) * H + di * D

        def layer_kind(li):
            pattern = self.layer_pattern or ("attn",)
            return pattern[li % len(pattern)]

        def is_moe_layer(li):
            return (self.n_experts > 0 and li >= self.first_k_dense
                    and li % self.moe_every == 0)

        total = emb
        for li in range(self.n_layers + self.encoder_layers):
            kind = layer_kind(li)
            if kind == "attn":
                total += attn_params()
            elif kind == "mamba":
                total += mamba_params()
            elif kind in ("mlstm", "slstm"):
                total += mlstm_params()
            if kind in ("attn", "mamba"):
                if is_moe_layer(li):
                    total += (self.n_experts + self.n_shared_experts) * \
                        mlp_params(self.moe_d_ff)
                    total += D * self.n_experts  # router
                elif self.family != "ssm":
                    total += mlp_params(F)
        if self.is_encdec:  # cross attention in decoder layers
            total += self.n_layers * (D * H * dh + 2 * D * KV * dh + H * dh * D)
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k routed + shared only)."""
        if self.n_experts == 0:
            return self.param_count()
        delta = 0
        for li in range(self.n_layers):
            if (li >= self.first_k_dense and li % self.moe_every == 0):
                inactive = self.n_experts - self.top_k
                delta += inactive * 3 * self.d_model * self.moe_d_ff
        return self.param_count() - delta
