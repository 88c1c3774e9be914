"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small.

30L d_model=576 9H (kv 3) d_ff=1536 vocab=49152; tied embeddings.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_head=64,
        d_ff=1536, vocab_size=49152, tie_embeddings=True,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_head=16,
        d_ff=96, vocab_size=256, tie_embeddings=True,
    )
