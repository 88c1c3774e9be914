"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense, GQA kv=8, qk_norm.

36L d_model=4096 32H (kv 8) d_ff=12288 vocab=151936.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=12288, vocab_size=151936, qk_norm=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, qk_norm=True,
    )
