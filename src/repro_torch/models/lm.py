"""End-to-end decoder-only language model: parameters, the prefill forward
and the cached decode step (counterpart of ``repro.models.lm``).

``forward`` is the prefill (every layer's attention through the flash
wrapper when ``cfg.attn_impl == "kernel"``); ``init_cache``/``serve_step``
the serving lowering, one token per step against per-layer KV caches.
Both run under ``torch.no_grad()``. A vision prefix and the
encoder-decoder topology wait for their slices; training (``loss_fn``)
waits for the training slice.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.types import resolve_device

from .config import ModelConfig
from .layers import embed, embed_defs, rmsnorm, rmsnorm_defs, unembed
from .params import ParamTree, init_tree
from .transformer import (LayerParams, build_plan, layer_defs, stack_apply,
                          stack_cache, stack_decode)


def plans(cfg: ModelConfig):
    dec = build_plan(cfg, decoder=True)
    enc = build_plan(cfg, decoder=False) if cfg.is_encdec else None
    return dec, enc


def _top_defs(cfg: ModelConfig):
    return {"embed": embed_defs(cfg), "final_norm": rmsnorm_defs(cfg.d_model)}


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError("the encoder-decoder stack is not ported "
                                  "yet (ROADMAP.md queue 1, item 15)")


class LMParams(ParamTree):
    """A decoder-only LM's parameters: ``embed``, ``final_norm`` and
    ``layers`` (an ``nn.ModuleList`` of ``LayerParams`` in
    ``plan.layers`` order)."""

    def __init__(self, top: dict, layers):
        super().__init__(top)
        self.layers = torch.nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> LMParams:
    """Parameters drawn from ``generator`` (a generator on ``device``,
    seeded 0 when not given) directly on ``device`` — the card unless the
    caller names the CPU."""
    _decoder_only(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot draw on "
                         f"{dev}")
    dec, _ = plans(cfg)
    top = init_tree(_top_defs(cfg), generator, cfg.param_dtype, dev)
    layers = [LayerParams(p, init_tree(layer_defs(cfg, p), generator,
                                       cfg.param_dtype, dev))
              for p in dec.layers]
    return LMParams(top, layers)


@torch.no_grad()
def forward(cfg: ModelConfig, params: LMParams, batch) -> torch.Tensor:
    """batch: {tokens [B, S]}. Returns logits [B, S, V] at the token
    positions."""
    _decoder_only(cfg)
    if "prefix_emb" in batch or "frame_emb" in batch:
        raise NotImplementedError("a vision prefix or encoder input is not "
                                  "ported yet (ROADMAP.md queue 1, item 15)")
    x = embed(params["embed"], batch["tokens"], cfg)
    x = stack_apply(cfg, params.layers, x)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg)


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> list:
    """Zeroed per-layer caches ``[{"mixer": {"k", "v", "pos"}}]`` on
    ``device`` (the card unless the caller names the CPU) — the allocating
    counterpart of the JAX ``init_cache_specs``."""
    _decoder_only(cfg)
    dec, _ = plans(cfg)
    return stack_cache(cfg, dec, batch, seq, resolve_device(device))


@torch.no_grad()
def serve_step(cfg: ModelConfig, params: LMParams, caches, tokens):
    """tokens: [B, 1] newest token ids. Returns (logits [B, 1, V], caches);
    the caches are updated in place."""
    x = embed(params["embed"], tokens, cfg)
    x, caches = stack_decode(cfg, params.layers, x, caches)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg), caches


def from_jax_params(cfg: ModelConfig, params_np: Dict[str, Any]) -> LMParams:
    """The JAX package's parameter pytree (leaves as numpy arrays) as the
    port's parameters, on the CPU (``.to(device)`` moves them):
    ``decoder.body``'s leading period axis is unstacked into per-layer
    modules in ``plan.layers`` order. Every JAX leaf is used exactly once;
    a missing or extra leaf raises ``ValueError``."""
    _decoder_only(cfg)
    dec, _ = plans(cfg)

    def take(defs: dict, tree: dict, path: str, period=None) -> dict:
        if not isinstance(tree, dict):
            raise ValueError(f"{path}: expected a subtree, got "
                             f"{type(tree).__name__}")
        extra = sorted(set(tree) - set(defs))
        missing = sorted(set(defs) - set(tree))
        if extra or missing:
            raise ValueError(f"{path}: extra leaves {extra}, missing leaves "
                             f"{missing}")
        out = {}
        for name, d in defs.items():
            sub = f"{path}.{name}"
            if isinstance(d, dict):
                out[name] = take(d, tree[name], sub, period)
                continue
            a = np.asarray(tree[name])
            if period is not None:
                if a.ndim != len(d.shape) + 1 or a.shape[0] != dec.n_periods:
                    raise ValueError(f"{sub}: {a.shape} is not stacked over "
                                     f"{dec.n_periods} periods")
                a = a[period]
            if tuple(a.shape) != tuple(d.shape):
                raise ValueError(f"{sub}: shape {a.shape} != {d.shape}")
            out[name] = torch.from_numpy(np.array(a)).to(cfg.param_dtype)
        return out

    expect = {"embed", "final_norm", "decoder"}
    if set(params_np) != expect:
        raise ValueError(f"top level: extra leaves "
                         f"{sorted(set(params_np) - expect)}, missing leaves "
                         f"{sorted(expect - set(params_np))}")
    top = {k: take(d, params_np[k], k) for k, d in _top_defs(cfg).items()}
    stack = params_np["decoder"]
    parts = {"head": len(dec.head), "body": len(dec.pattern),
             "tail": len(dec.tail)}
    if not isinstance(stack, dict) or set(stack) != set(parts) or any(
            len(stack[k]) != n for k, n in parts.items()):
        raise ValueError(f"decoder: expected head/body/tail lists of "
                         f"{parts}")
    layers = [LayerParams(p, take(layer_defs(cfg, p), stack["head"][i],
                                  f"decoder.head[{i}]"))
              for i, p in enumerate(dec.head)]
    for period in range(dec.n_periods):
        layers += [LayerParams(p, take(layer_defs(cfg, p), stack["body"][i],
                                       f"decoder.body[{i}]", period))
                   for i, p in enumerate(dec.pattern)]
    layers += [LayerParams(p, take(layer_defs(cfg, p), stack["tail"][i],
                                   f"decoder.tail[{i}]"))
               for i, p in enumerate(dec.tail)]
    return LMParams(top, layers)
