"""The decoder stack (counterpart of ``repro.models.transformer``).

Every architecture compiles into a static plan (``build_plan``, copied
from the JAX package): head layers, a repeating body period and tail
layers. The JAX package scans the body with parameters stacked over
periods; the port runs eagerly, so the stack is one ``nn.ModuleList`` of
per-layer parameters in ``plan.layers`` order and apply and decode are
loops over it. The head/body/tail split only matters when carrying JAX
weights across (``lm.from_jax_params``).

Only ``kind == "attn"`` layers with GQA attention and a dense MLP are
ported; any other layer kind, MoE or cross layer raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from . import attention as attn
from .config import ModelConfig
from .layers import mlp, mlp_defs, rmsnorm, rmsnorm_defs
from .params import ParamTree


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    kind: str  # attn | mamba | mlstm | slstm
    mlp: str  # dense | moe | none
    window: int = 0  # >0: local sliding-window attention
    cross: bool = False  # enc-dec decoder layer


@dataclasses.dataclass(frozen=True)
class StackPlan:
    head: Tuple[LayerPlan, ...]
    pattern: Tuple[LayerPlan, ...]
    n_periods: int
    tail: Tuple[LayerPlan, ...]

    @property
    def layers(self) -> List[LayerPlan]:
        return (list(self.head) + list(self.pattern) * self.n_periods
                + list(self.tail))


def build_plan(cfg: ModelConfig, decoder: bool = True) -> StackPlan:
    n_layers = cfg.n_layers if decoder else cfg.encoder_layers
    cross = cfg.is_encdec and decoder

    def mlp_kind(li: int, kind: str) -> str:
        if kind in ("mlstm", "slstm"):
            return "none"
        if (cfg.n_experts > 0 and li >= cfg.first_k_dense
                and li % cfg.moe_every == 0):
            return "moe"
        return "dense"

    def layer(li: int) -> LayerPlan:
        if cfg.layer_pattern:
            kind = cfg.layer_pattern[li % len(cfg.layer_pattern)]
        else:
            kind = "attn"
        window = 0
        if kind == "attn" and cfg.sliding_window and cfg.global_every:
            is_global = (li % cfg.global_every) == (cfg.global_every - 1)
            window = 0 if is_global else cfg.sliding_window
        elif kind == "attn" and cfg.sliding_window and not cfg.global_every:
            window = cfg.sliding_window
        return LayerPlan(kind=kind, mlp=mlp_kind(li, kind), window=window,
                         cross=cross)

    all_layers = [layer(li) for li in range(n_layers)]
    head = tuple(all_layers[:cfg.first_k_dense])
    body = all_layers[cfg.first_k_dense:]
    period = len(cfg.layer_pattern) if cfg.layer_pattern else 1
    if cfg.global_every:
        period = max(period, cfg.global_every)
    # a period is scannable only if the pattern of plans repeats exactly
    n_periods = len(body) // period if period else 0
    pattern = tuple(body[:period])
    ok = all(tuple(body[p * period:(p + 1) * period]) == pattern
             for p in range(n_periods))
    if not ok or n_periods == 0:
        return StackPlan(head=head, pattern=(), n_periods=0,
                         tail=tuple(body))
    tail = tuple(body[n_periods * period:])
    return StackPlan(head=head, pattern=pattern, n_periods=n_periods,
                     tail=tail)


class LayerParams(ParamTree):
    """One layer's parameters, with the plan that applies them."""

    def __init__(self, plan: LayerPlan, tree: dict):
        super().__init__(tree)
        self.plan = plan


def _check_ported(cfg: ModelConfig, plan: LayerPlan) -> None:
    if plan.kind != "attn" or cfg.attention != "gqa" \
            or plan.mlp != "dense" or plan.cross:
        raise NotImplementedError(
            f"layer {plan} of attention {cfg.attention!r} is not ported yet "
            f"(ROADMAP.md queue 1, item 15): only dense GQA decoder layers")


def layer_defs(cfg: ModelConfig, plan: LayerPlan):
    _check_ported(cfg, plan)
    D = cfg.d_model
    return {"norm1": rmsnorm_defs(D), "attn": attn.gqa_defs(cfg),
            "norm2": rmsnorm_defs(D), "mlp": mlp_defs(cfg)}


def layer_apply(cfg: ModelConfig, plan: LayerPlan, params, x):
    """Prefill application of one layer: x [B, L, D] -> [B, L, D]."""
    _check_ported(cfg, plan)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    x = x + attn.gqa_train(params["attn"], h, cfg, window=plan.window)
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + mlp(params["mlp"], h2)


def layer_decode(cfg: ModelConfig, plan: LayerPlan, params, x, cache):
    """Single-token decode of one layer. Returns (x, cache); the cache is
    updated in place."""
    _check_ported(cfg, plan)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    y, cache_m = attn.gqa_decode(params["attn"], h, cache["mixer"], cfg,
                                 window=plan.window)
    x = x + y
    x = x + mlp(params["mlp"], rmsnorm(params["norm2"], x, cfg.norm_eps))
    return x, {"mixer": cache_m}


def layer_cache_spec(cfg: ModelConfig, plan: LayerPlan, batch: int,
                     seq: int):
    _check_ported(cfg, plan)
    return {"mixer": attn.gqa_cache_spec(cfg, batch, seq,
                                         window=plan.window)}


def stack_apply(cfg: ModelConfig, layers, x):
    """Full-sequence forward through ``layers`` (``LayerParams`` in
    ``plan.layers`` order)."""
    for lp in layers:
        x = layer_apply(cfg, lp.plan, lp, x)
    return x


def stack_decode(cfg: ModelConfig, layers, x, caches):
    """Single-token decode through every layer."""
    new_caches = []
    for lp, cache in zip(layers, caches):
        x, c = layer_decode(cfg, lp.plan, lp, x, cache)
        new_caches.append(c)
    return x, new_caches


def stack_cache(cfg: ModelConfig, plan: StackPlan, batch: int, seq: int,
                device) -> list:
    """Zeroed per-layer caches, allocated on ``device``."""
    return [{"mixer": {name: torch.zeros(shape, dtype=dtype, device=device)
                       for name, (shape, dtype) in
                       layer_cache_spec(cfg, p, batch, seq)["mixer"].items()}}
            for p in plan.layers]
