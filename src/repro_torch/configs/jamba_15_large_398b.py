"""Jamba-1.5-Large 398B [arXiv:2403.19887] — Mamba+attn 1:7, MoE 16e top-2.

72L d_model=8192 64H (kv 8) d_ff=24576(moe expert) vocab=65536; period-8
blocks: 1 attention + 7 mamba; MoE every other layer.
"""

from repro_torch.models.config import ModelConfig

PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=24576, vocab_size=65536,
        layer_pattern=PATTERN,
        n_experts=16, top_k=2, moe_d_ff=24576, moe_every=2,
        ssm_state_dim=16, ssm_conv_dim=4, ssm_expand=2,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256,
        layer_pattern=PATTERN,
        n_experts=4, top_k=2, moe_d_ff=64, moe_every=2,
        ssm_state_dim=4, ssm_conv_dim=4, ssm_expand=2,
    )
