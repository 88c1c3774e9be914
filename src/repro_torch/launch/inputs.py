"""Model inputs of a shape cell (counterpart of ``repro.launch.inputs``).

``train_input_specs``/``decode_input_specs``/``input_specs`` give every
input as a ``(shape, dtype)`` stand-in (no allocation);
``random_inputs`` materialises them from an explicit ``torch.Generator``
on ``device``. Modality frontends are stubs, as in the JAX package:
vision provides ``prefix_emb`` (precomputed patch embeddings), audio
``frame_emb`` (precomputed speech-frame embeddings, a fixed 4096-frame
encoder window).
"""

from __future__ import annotations

import torch

from repro_torch.configs.shapes import ShapeCell
from repro_torch.models.config import ModelConfig

AUDIO_ENC_FRAMES = 4096  # stub encoder window (≈40 s of speech frames)


def train_input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    B, S = cell.global_batch, cell.seq_len
    tok = ((B, S), torch.int32)
    specs = {"tokens": tok, "labels": tok}
    if cfg.frontend == "vision":
        specs["prefix_emb"] = ((B, cfg.frontend_len, cfg.d_model),
                               cfg.compute_dtype)
    if cfg.is_encdec:
        frames = min(AUDIO_ENC_FRAMES, cell.seq_len)
        specs["frame_emb"] = ((B, frames, cfg.d_model), cfg.compute_dtype)
    return specs


def decode_input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    from repro_torch.models.lm import plans
    from repro_torch.models.transformer import layer_cache_spec

    B = cell.global_batch
    dec, _ = plans(cfg)
    specs = {
        "tokens": ((B, 1), torch.int32),
        "caches": [layer_cache_spec(cfg, p, B, cell.seq_len)
                   for p in dec.layers],
    }
    if cfg.is_encdec:
        frames = min(AUDIO_ENC_FRAMES, cell.seq_len)
        specs["memory"] = ((B, frames, cfg.d_model), cfg.compute_dtype)
    return specs


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    if cell.mode == "decode":
        return decode_input_specs(cfg, cell)
    return train_input_specs(cfg, cell)


def random_inputs(cfg: ModelConfig, cell: ShapeCell,
                  generator: torch.Generator, device) -> dict:
    """Inputs matching ``input_specs``, drawn in the specs' order from
    ``generator`` (which lives on ``device``): int32 leaves uniform in
    [0, vocab), float leaves normal x 0.02."""

    def mk(spec):
        if isinstance(spec, dict):
            return {k: mk(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [mk(v) for v in spec]
        shape, dtype = spec
        if dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, shape, generator=generator,
                                 dtype=torch.int32, device=device)
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    return mk(input_specs(cfg, cell))
