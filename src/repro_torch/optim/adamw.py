"""AdamW with global-norm clipping and a warmup-cosine schedule
(counterpart of ``repro.optim.adamw``).

Plain functions on tensor trees: a tree is a flat dict of name ->
tensor (``dict(params.named_parameters())``), the optimizer state
``{"mu": tree, "nu": tree, "step": int32 scalar tensor}``. The arithmetic
is the reference's, in f32 tensors (the schedule too, so that a resumed
run replays it exactly), with the moments stored in
``cfg.moment_dtype``. ``apply_updates`` writes the new parameters and
moments into the tensors it is given (the port's counterpart of buffer
donation: no second copy of the model and its moments) and returns them.
``torch.optim.AdamW`` is not used: its order of operations differs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32  # bf16 halves optimizer memory


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int32 tensor, or a Python int as
    the reference's ``float(step)`` branch: its ratios in double, the rest
    in f32): linear warmup to ``lr_peak``, then a cosine to
    ``lr_min_ratio`` of it at ``decay_steps``. An f32 0-d tensor."""
    if isinstance(step, torch.Tensor):
        s = step.float()
        warm = torch.clamp_max((s + 1) / _f32(max(1, cfg.warmup_steps)), 1.0)
        prog = torch.clamp((s - cfg.warmup_steps)
                           / _f32(max(1, cfg.decay_steps
                                      - cfg.warmup_steps)), 0.0, 1.0)
    else:
        s = float(step)
        warm = _f32(min(1.0, (s + 1) / max(1, cfg.warmup_steps)))
        prog = _f32(min(max((s - cfg.warmup_steps)
                            / max(1, cfg.decay_steps - cfg.warmup_steps),
                            0.0), 1.0))
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    return cfg.lr_peak * warm * (cfg.lr_min_ratio
                                 + (1 - cfg.lr_min_ratio) * cos)


def init_opt_state(cfg: AdamWConfig, params: dict) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    dev = next(iter(params.values())).device if params else None
    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_spec_tree: dict) -> dict:
    """Optimizer-state specs mirror the param specs (ZeRO)."""
    return {"mu": param_spec_tree, "nu": param_spec_tree, "step": ()}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: dict,
                  grad_norm: torch.Tensor | None = None):
    """One AdamW step with global-norm clipping; returns (params, state,
    {"lr", "grad_norm"}). ``params`` and the moments are updated in place
    (their tensors are the ones returned); ``state["step"]`` is a new
    tensor. ``grad_norm``: the whole gradient's norm, where ``grads``
    holds only this rank's shards of it (``global_norm(grads)`` when
    None)."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    lr = lr_at(cfg, step).to(gnorm.device)
    sf = step.float()
    b1c = 1 - torch.pow(_f32(cfg.b1, sf.device), sf)
    b2c = 1 - torch.pow(_f32(cfg.b2, sf.device), sf)
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state["mu"][name], state["nu"][name]
        m1 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v1 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m1 / b1c
        vhat = v1 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m1)
        v.copy_(v1)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
