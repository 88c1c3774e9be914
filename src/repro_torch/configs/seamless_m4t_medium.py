"""SeamlessM4T-medium [arXiv:2308.11596] — enc-dec, audio frontend stub.

12L encoder + 12L decoder, d_model=1024 16H (MHA) d_ff=4096 vocab=256206;
encoder consumes precomputed speech-frame embeddings (stub frontend).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, encoder_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
        d_ff=4096, vocab_size=256206,
        frontend="audio",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="audio",
        n_layers=2, encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256,
        frontend="audio",
    )
