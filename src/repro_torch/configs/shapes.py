"""The four assigned input-shape cells and per-arch applicability (the
port's copy of ``repro.configs.shapes``).

  train_4k     seq 4096,    global batch 256  -> train_step
  prefill_32k  seq 32768,   global batch 32   -> train_step fwd (prefill)
  decode_32k   seq 32768,   global batch 128  -> serve_step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524288,  global batch 1    -> serve_step; requires
               sub-quadratic attention — run for SSM/hybrid/local-attn,
               skipped for pure full-attention archs.

Encoder-decoder archs run decode cells on their decoder (the 32k/500k is
the decoder-side cache; the encoder memory is a fixed 4096-frame stub).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def skip_reason(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    if cell.name == "long_500k" and not cfg.is_subquadratic:
        return ("pure full-attention arch: 512k dense KV decode is not "
                "sub-quadratic; skipped per assignment note")
    return None


def applicable_shapes(cfg: ModelConfig):
    """[(cell, skip_reason|None)] for all four cells."""
    return [(cell, skip_reason(cfg, cell)) for cell in SHAPES]


def reduced_cell(cell: ShapeCell) -> ShapeCell:
    """Tiny analog of a cell for CPU smoke tests."""
    seq = 32 if cell.mode != "decode" else 64
    return dataclasses.replace(cell, seq_len=seq, global_batch=2)
