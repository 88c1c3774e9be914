"""xLSTM-1.3B [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks.

48L d_model=2048 4H d_ff=0 (the block IS the mixer) vocab=50304;
7 mLSTM : 1 sLSTM interleave (xLSTM[7:1]).
"""

from repro_torch.models.config import ModelConfig

PATTERN = ("mlstm", "mlstm", "mlstm", "slstm",
           "mlstm", "mlstm", "mlstm", "mlstm")


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        layer_pattern=PATTERN, ssm_expand=2, mlstm_chunk=64,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=256,
        layer_pattern=PATTERN, ssm_expand=2, mlstm_chunk=8,
    )
