"""Rank bodies of ``tests/test_torch_elastic.py`` (no JAX here; the ranks
import this module by path)."""

from __future__ import annotations

from repro_torch.distributed import elastic

# SmolLM's reduced trainer, as tests/torch_sharded_ranks.py's resume case
RESUME = dict(arch="smollm_135m", batch_size=4, seq_len=32, seed=0,
              lr_peak=1e-3, log_every=100, ckpt_every=0, schedule_steps=6)
SPLIT, STEPS = 3, 6


def restore_then_continue(shape, kw: dict) -> list:
    """Two segments of ``elastic.remesh``'s rank body at ``shape`` in one
    group: the step-SPLIT checkpoint restored and saved again with no
    step between (its leaves gathered back from this mesh's shards), then
    training on to STEPS; returns the second segment's losses."""
    elastic._segment_rank(shape, "cpu", dict(kw, steps=SPLIT))
    return elastic._segment_rank(shape, "cpu", dict(kw, steps=STEPS))
