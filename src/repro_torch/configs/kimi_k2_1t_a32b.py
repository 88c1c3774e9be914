"""Kimi K2 1T-A32B [arXiv:2501.kimi2; paper-table, unverified] — trillion-param MoE.

61L d_model=7168 64H (GQA kv=8) d_ff(expert)=2048 vocab=163840;
MoE 384 routed experts top-8 + 1 shared; first layer dense.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=18432, vocab_size=163840,
        n_experts=384, n_shared_experts=1, top_k=8, moe_d_ff=2048,
        first_k_dense=1,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=192, vocab_size=256,
        n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=32,
        first_k_dense=1,
    )
