"""Qwen1.5-110B [hf] — dense, GQA kv=8, QKV bias.

80L d_model=8192 64H (kv 8) d_ff=49152 vocab=152064.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=49152, vocab_size=152064, qkv_bias=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=192, vocab_size=256, qkv_bias=True,
    )
