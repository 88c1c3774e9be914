"""Rank body of ``tests/test_torch_train.py``'s ``compressed_psum`` case,
imported by the spawned gloo ranks (no JAX here)."""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim import compressed_psum


def compressed_psum_steps(grads_by_rank, device="cpu"):
    """Each rank feeds its own per-step gradient dicts (numpy) through
    ``compressed_psum`` with error feedback, its tensors on ``device``
    (the card's for NCCL ranks); returns every step's mean and error state
    (numpy) of this rank."""
    rank = dist.get_rank()
    err, out = None, []
    for step in grads_by_rank[rank]:
        g = {k: torch.from_numpy(v).to(device) for k, v in step.items()}
        mean, err = compressed_psum(g, error_state=err)
        out.append(({k: v.cpu().numpy() for k, v in mean.items()},
                    {k: v.cpu().numpy() for k, v in err.items()}))
    return out
