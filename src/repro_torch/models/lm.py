"""End-to-end language model: parameters, the prefill forward, the cached
decode step and the encoder (counterpart of ``repro.models.lm``).

Three input topologies, as in the JAX package:
  * decoder-only LM (tokens);
  * prefix-multimodal (``prefix_emb`` vision embeddings before the tokens,
    logits at the token positions) — phi-3-vision;
  * encoder-decoder (``frame_emb`` audio embeddings through the encoder;
    tokens through the decoder with cross attention to its memory) —
    seamless-m4t.

``forward`` is the prefill and the training forward (every global GQA
layer's attention through the flash wrapper when ``cfg.attn_impl ==
"kernel"``, differentiable through the flash backward) and returns
(logits, aux), the aux summed over the MoE layers; ``loss_fn`` the
training loss on it. ``init_cache``/``serve_step`` are the serving
lowering, one token per step against per-layer caches (``serve_step``
under ``torch.no_grad()``), with ``encode_memory`` run once per request
for the encoder-decoder. ``forward`` and ``encode_memory`` build a graph
only where a leaf requires a gradient: serving's frozen parameters
build none, and serving callers run them under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding_ctx import open_params, tp_split

from .config import ModelConfig
from .layers import (embed, embed_defs, embed_tp_uses, rmsnorm, rmsnorm_defs,
                     softmax_xent, unembed, vocab_start, whole_vocab)
from .params import ParamTree, init_one, spec_tree
from .transformer import (LayerParams, build_plan, layer_defs, stack_apply,
                          stack_cache, stack_decode, stack_specs)


def plans(cfg: ModelConfig):
    dec = build_plan(cfg, decoder=True)
    enc = build_plan(cfg, decoder=False) if cfg.is_encdec else None
    return dec, enc


def _top_defs(cfg: ModelConfig):
    defs = {"embed": embed_defs(cfg), "final_norm": rmsnorm_defs(cfg.d_model)}
    if cfg.is_encdec:
        defs["enc_norm"] = rmsnorm_defs(cfg.d_model)
    return defs


class LMParams(ParamTree):
    """An LM's parameters: ``embed``, ``final_norm`` (and ``enc_norm``),
    ``layers`` (an ``nn.ModuleList`` of ``LayerParams`` in the decoder
    plan's ``layers`` order) and, for an encoder-decoder, ``encoder`` (the
    same for the encoder plan; None otherwise)."""

    def __init__(self, top: dict, layers, encoder=None):
        super().__init__(top)
        self.layers = torch.nn.ModuleList(layers)
        self.encoder = None if encoder is None else \
            torch.nn.ModuleList(encoder)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> LMParams:
    """Parameters drawn from ``generator`` (a generator on ``device``,
    seeded 0 when not given) directly on ``device`` — the card unless the
    caller names the CPU: the top level, the decoder's layers, then the
    encoder's."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot draw on "
                         f"{dev}")
    return params_from_leaves(cfg, {
        name: init_one(d, generator, cfg.param_dtype, dev)
        for name, d in draw_order(cfg)})


def draw_order(cfg: ModelConfig):
    """(dotted name, ``ParamDef``) of every parameter in the order
    ``init_params`` draws them: the top level, the decoder's layers, the
    encoder's, each tree depth first in its defs' order."""
    def walk(defs, prefix):
        for k, d in defs.items():
            if isinstance(d, dict):
                yield from walk(d, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", d

    dec, enc = plans(cfg)
    yield from walk(_top_defs(cfg), "")
    for stack, plan in (("layers", dec), ("encoder", enc)):
        if plan is not None:
            for i, p in enumerate(plan.layers):
                yield from walk(layer_defs(cfg, p), f"{stack}.{i}.")


def _flat(tree: dict, prefix: str = ""):
    """A nested dict's leaves by dotted name, in ``ParamTree``'s
    ``named_parameters`` order: a level's own leaves, then its subtrees."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            yield f"{prefix}{k}", v
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")


def param_specs(cfg: ModelConfig, fsdp_axes=("data",),
                tp_axis="model") -> dict:
    """Every parameter's spec, keyed and ordered as
    ``params.named_parameters()`` (``embed.tok``, ``layers.3.attn.wq``)."""
    dec, enc = plans(cfg)
    out = dict(_flat(spec_tree(_top_defs(cfg), fsdp_axes, tp_axis)))
    for stack, plan in (("layers", dec), ("encoder", enc)):
        if plan is not None:
            for i, t in enumerate(stack_specs(cfg, plan, fsdp_axes,
                                              tp_axis)):
                out.update(_flat(t, f"{stack}.{i}."))
    return out


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's ``(shape, dtype)``, keyed as ``param_specs``
    (no allocation)."""
    dec, enc = plans(cfg)
    defs = dict(_flat(_top_defs(cfg)))
    for stack, plan in (("layers", dec), ("encoder", enc)):
        if plan is not None:
            for i, p in enumerate(plan.layers):
                defs.update(_flat(layer_defs(cfg, p), f"{stack}.{i}."))
    return {k: (d.shape, cfg.param_dtype) for k, d in defs.items()}


def params_from_leaves(cfg: ModelConfig, leaves: dict) -> LMParams:
    """``LMParams`` over the tensors of ``leaves`` (``{dotted name:
    tensor}``, the names of ``named_parameters``), which it shares."""
    def nest(defs, prefix):
        return {k: nest(d, f"{prefix}{k}.") if isinstance(d, dict)
                else leaves[f"{prefix}{k}"] for k, d in defs.items()}

    dec, enc = plans(cfg)

    def stack(plan, name):
        return [LayerParams(p, nest(layer_defs(cfg, p), f"{name}.{i}."))
                for i, p in enumerate(plan.layers)]

    return LMParams(nest(_top_defs(cfg), ""), stack(dec, "layers"),
                    None if enc is None else stack(enc, "encoder"))


def encode_memory(cfg: ModelConfig, params: LMParams, frame_emb):
    """Encoder-decoder: the encoder over frame embeddings ``[B, Se, D]``
    (causal, as the JAX encoder's ``gqa_train``), normed: the memory the
    decoder's cross attention reads."""
    if params.encoder is None:
        raise ValueError(f"{cfg.name} has no encoder")
    mem, _ = stack_apply(cfg, params.encoder, frame_emb.to(cfg.compute_dtype))
    with open_params(params, keys=("enc_norm",)) as top:
        return rmsnorm(top["enc_norm"], mem, cfg.norm_eps)


def forward(cfg: ModelConfig, params: LMParams, batch):
    """batch: {tokens [B, S], (prefix_emb [B, P, D] | frame_emb [B, Se,
    D])}. Returns (logits [B, S, V] at the token positions, aux); under
    the sharded train step's vocabulary split, this model rank's
    ``[B, S, V/tp]`` block (``layers.vocab_start``)."""
    tokens = batch["tokens"]
    uses = embed_tp_uses(cfg, tp_split())
    with open_params(params["embed"], uses, keys=("tok",)) as e:
        x = embed(e, tokens, cfg)
    memory = None
    if cfg.is_encdec:
        memory = encode_memory(cfg, params, batch["frame_emb"])
    n_prefix = 0
    if cfg.frontend == "vision" and "prefix_emb" in batch:
        pre = batch["prefix_emb"].to(cfg.compute_dtype)
        n_prefix = pre.shape[1]
        x = torch.cat([pre, x], dim=1)
    x, aux = stack_apply(cfg, params.layers, x, token_ids=tokens,
                         memory=memory)
    with open_params(params, keys=("final_norm",)) as top:
        x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    with open_params(params["embed"], uses, keys=(
            "tok" if cfg.tie_embeddings else "unembed",)) as e:
        return unembed(e, x, cfg), aux


def loss_fn(cfg: ModelConfig, params: LMParams, batch):
    """The training loss on ``forward``: token-mean cross entropy against
    ``batch["labels"]`` (masked by ``batch["mask"]`` where given; over the
    model ranks' vocabulary blocks where the sharded train step splits the
    logits), plus 0.01 lb_loss + 1e-3 z_loss for a MoE config. Returns
    (loss, aux)."""
    logits, aux = forward(cfg, params, batch)
    loss = softmax_xent(logits, batch["labels"], batch.get("mask"),
                        vocab_start=vocab_start(cfg))
    if cfg.n_experts:
        loss = loss + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return loss, aux


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> list:
    """Zeroed per-layer decoder caches ``[{"mixer": {...}}]`` on
    ``device`` (the card unless the caller names the CPU) — the
    allocating counterpart of the JAX ``init_cache_specs``."""
    dec, _ = plans(cfg)
    return stack_cache(cfg, dec, batch, seq, resolve_device(device))


@torch.no_grad()
def serve_step(cfg: ModelConfig, params: LMParams, caches, tokens,
               memory=None):
    """tokens: [B, 1] newest token ids (``memory``: the encoder-decoder's
    ``[B, Se, D]`` from ``encode_memory``). Returns (logits [B, 1, V],
    caches); the caches are updated in place. Under the sharded serve
    step the parameters open as ``forward``'s do, and the logits are the
    whole vocabulary's on every model rank (``layers.whole_vocab``)."""
    uses = embed_tp_uses(cfg, tp_split())
    with open_params(params["embed"], uses, keys=("tok",)) as e:
        x = embed(e, tokens, cfg)
    x, caches = stack_decode(cfg, params.layers, x, caches, memory=memory)
    with open_params(params, keys=("final_norm",)) as top:
        x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
    with open_params(params["embed"], uses, keys=(
            "tok" if cfg.tie_embeddings else "unembed",)) as e:
        return whole_vocab(unembed(e, x, cfg), cfg), caches


def _take(cfg: ModelConfig, defs: dict, tree, path: str, periods=None,
          period=None) -> dict:
    """The subtree ``tree`` (numpy leaves) checked against ``defs`` leaf
    for leaf, as CPU tensors; with ``period``, each leaf's slice of its
    leading axis of ``periods``."""
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
            out[name] = _take(cfg, d, tree[name], sub, periods, period)
            continue
        a = np.asarray(tree[name])
        if period is not None:
            if a.ndim != len(d.shape) + 1 or a.shape[0] != periods:
                raise ValueError(f"{sub}: {a.shape} is not stacked over "
                                 f"{periods} periods")
            a = a[period]
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{sub}: shape {a.shape} != {d.shape}")
        out[name] = torch.from_numpy(np.array(a)).to(cfg.param_dtype)
    return out


def stack_index(plan) -> list:
    """Where each layer of ``plan.layers`` sits in a JAX ``{head, body,
    tail}`` stack: ``(part, i, period)``, ``period`` the index along the
    scanned body's leading axis (None for head and tail)."""
    return ([("head", i, None) for i in range(len(plan.head))]
            + [("body", i, period) for period in range(plan.n_periods)
               for i in range(len(plan.pattern))]
            + [("tail", i, None) for i in range(len(plan.tail))])


def _unstack(cfg: ModelConfig, plan, stack, path: str) -> list:
    """A JAX ``{head, body, tail}`` stack as ``LayerParams`` in
    ``plan.layers`` order, ``body``'s period axis unstacked."""
    parts = {"head": len(plan.head), "body": len(plan.pattern),
             "tail": len(plan.tail)}
    if not isinstance(stack, dict) or set(stack) != set(parts) or any(
            len(stack[k]) != n for k, n in parts.items()):
        raise ValueError(f"{path}: expected head/body/tail lists of "
                         f"{parts}")
    return [LayerParams(p, _take(cfg, layer_defs(cfg, p), stack[part][i],
                                 f"{path}.{part}[{i}]", plan.n_periods,
                                 period))
            for p, (part, i, period) in zip(plan.layers, stack_index(plan))]


def from_jax_params(cfg: ModelConfig, params_np: Dict[str, Any]) -> LMParams:
    """The JAX package's parameter pytree (leaves as numpy arrays) as the
    port's parameters, on the CPU (``.to(device)`` moves them): each
    stack's ``body`` leading period axis is unstacked into per-layer
    modules in plan order (``decoder``, and ``encoder`` for an
    encoder-decoder). Every JAX leaf is used exactly once; a missing or
    extra leaf raises ``ValueError``."""
    dec, enc = plans(cfg)
    top_defs = _top_defs(cfg)
    expect = set(top_defs) | {"decoder"} | ({"encoder"} if enc else set())
    if set(params_np) != expect:
        raise ValueError(f"top level: extra leaves "
                         f"{sorted(set(params_np) - expect)}, missing leaves "
                         f"{sorted(expect - set(params_np))}")
    top = {k: _take(cfg, d, params_np[k], k) for k, d in top_defs.items()}
    layers = _unstack(cfg, dec, params_np["decoder"], "decoder")
    encoder = None if enc is None else \
        _unstack(cfg, enc, params_np["encoder"], "encoder")
    return LMParams(top, layers, encoder)
