"""Phi-3-Vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct] — phi3-mini + CLIP stub.

32L d_model=3072 32H (kv 32 = MHA) d_ff=8192 vocab=32064; 576 precomputed
CLIP patch embeddings prepended (modality frontend is a stub per the
assignment: ``input_specs`` provides the patch embeddings).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
        d_ff=8192, vocab_size=32064,
        frontend="vision", frontend_len=576,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="phi3v-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256,
        frontend="vision", frontend_len=16,
    )
