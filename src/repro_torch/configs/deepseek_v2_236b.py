"""DeepSeek-V2 236B [arXiv:2405.04434; hf] — MoE + MLA.

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400; MLA kv_lora=512,
q_lora=1536, decoupled rope head 64; 2 shared + 160 routed experts, top-6;
first layer dense (d_ff 12288).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_head=128,
        d_ff=12288, vocab_size=102400,
        attention="mla", kv_lora_rank=512, q_lora_rank=1536, rope_dim=64,
        n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
        first_k_dense=1,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256,
        attention="mla", kv_lora_rank=32, q_lora_rank=48, rope_dim=8,
        n_experts=8, n_shared_experts=2, top_k=2, moe_d_ff=32,
        first_k_dense=1,
    )
