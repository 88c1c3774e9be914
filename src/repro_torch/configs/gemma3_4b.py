"""Gemma-3 4B [hf:google/gemma-3; unverified] — 5:1 local:global, 128k ctx.

34L d_model=2560 8H (kv 4) d_ff=10240 vocab=262144; sliding window 1024 on
local layers, every 6th layer global.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_head=256,
        d_ff=10240, vocab_size=262144,
        sliding_window=1024, global_every=6, qk_norm=True,
        rope_theta=1_000_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256,
        sliding_window=8, global_every=6, qk_norm=True,
    )
