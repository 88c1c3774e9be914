"""The decoder stack (counterpart of ``repro.models.transformer``).

Every architecture compiles into a static plan (``build_plan``, copied
from the JAX package): head layers, a repeating body period and tail
layers. The JAX package scans the body with parameters stacked over
periods; the port runs eagerly, so the stack is one ``nn.ModuleList`` of
per-layer parameters in ``plan.layers`` order and apply and decode are
loops over it. The head/body/tail split only matters when carrying JAX
weights across (``lm.from_jax_params``).

Every layer kind of the JAX package is here: GQA (global or sliding
window) or MLA attention, the Mamba, mLSTM and sLSTM mixers, a dense or
MoE MLP (or none), and the encoder-decoder's cross attention.

``stack_apply`` and ``stack_decode`` open each layer's parameters for the
length of its forward (``sharding_ctx.open_params``): the layer's own
tree on one device; under the sharded train step or the sharded serving
steps, the tensors the step gathers for it as ``layer_tp_uses`` asks
(this rank's model shards of the split blocks, whole weights for the
rest), freed when the layer's forward ends. Decode keeps heterogeneous
per-layer caches: ring buffers for local attention, MLA's compressed
cache, O(1) recurrent states. Under the sharded serve step a layer's
cache holds this rank's shards of its leaves, and ``{"seq": (n, r)}``
beside ``"mixer"`` says that its sequence axis is block r of n over
"data" (context parallelism; absent, the whole sequence).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.distributed.sharding_ctx import open_params, tp_split

from . import attention as attn
from . import ssm
from .config import ModelConfig
from .layers import mlp, mlp_defs, mlp_tp_uses, rmsnorm, rmsnorm_defs
from .moe import moe, moe_defs, moe_tp_uses, zero_aux
from .params import ParamTree, spec_tree


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


_MIXERS = {  # kind -> (defs, train, decode, cache spec, tp uses)
    "mamba": (ssm.mamba_defs, ssm.mamba_train, ssm.mamba_decode,
              ssm.mamba_cache_spec, ssm.mamba_tp_uses),
    "mlstm": (ssm.mlstm_defs, ssm.mlstm_train, ssm.mlstm_decode,
              ssm.mlstm_cache_spec, ssm.mlstm_tp_uses),
    "slstm": (ssm.slstm_defs, ssm.slstm_train, ssm.slstm_decode,
              ssm.slstm_cache_spec, ssm.slstm_tp_uses),
}


def layer_defs(cfg: ModelConfig, plan: LayerPlan):
    D = cfg.d_model
    defs: dict = {"norm1": rmsnorm_defs(D)}
    if plan.kind == "attn":
        defs["attn"] = (attn.mla_defs(cfg) if cfg.attention == "mla"
                        else attn.gqa_defs(cfg))
    else:
        defs["mixer"] = _MIXERS[plan.kind][0](cfg)
    if plan.cross:
        defs["norm_x"] = rmsnorm_defs(D)
        defs["cross"] = attn.cross_defs(cfg)
    if plan.mlp == "dense":
        defs["norm2"] = rmsnorm_defs(D)
        defs["mlp"] = mlp_defs(cfg)
    elif plan.mlp == "moe":
        defs["norm2"] = rmsnorm_defs(D)
        defs["moe"] = moe_defs(cfg)
    return defs


def stack_specs(cfg: ModelConfig, plan: StackPlan, fsdp_axes=("data",),
                tp_axis="model") -> list:
    """Each layer's spec tree, in ``plan.layers`` order: the reference's
    stacked specs without the scanned body's leading layer axis (always
    None)."""
    return [spec_tree(layer_defs(cfg, p), fsdp_axes, tp_axis)
            for p in plan.layers]


def layer_tp_uses(cfg: ModelConfig, plan: LayerPlan, tp: int, L: int,
                  tokens: int) -> dict:
    """How one layer over L rows (``tokens`` of them in the batch) takes
    its parameters over ``tp`` model ranks: ``{dotted name: "split" |
    "partial"}``, the rest whole ("full": the norms, the router, the
    mixers' gate biases)."""
    uses = {}

    def add(prefix, sub):
        uses.update({f"{prefix}.{k}": v for k, v in sub.items()})

    if plan.kind == "attn":
        add("attn", attn.mla_tp_uses(cfg, tp, L) if cfg.attention == "mla"
            else attn.gqa_tp_uses(cfg, tp, L))
    else:
        add("mixer", _MIXERS[plan.kind][4](cfg, tp, tokens))
    if plan.cross:
        add("cross", attn.gqa_tp_uses(cfg, tp, L, cross=True))
    if plan.mlp == "dense":
        add("mlp", mlp_tp_uses(cfg.d_ff, tp))
    elif plan.mlp == "moe":
        add("moe", moe_tp_uses(cfg, tp))
    return uses


def layer_apply(cfg: ModelConfig, plan: LayerPlan, params, x,
                token_ids=None, memory=None):
    """Prefill application of one layer: x [B, L, D] -> (x, aux); aux is
    the MoE layer's (``moe.moe``), None for a layer without experts."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if plan.kind == "attn":
        if cfg.attention == "mla":
            y = attn.mla_train(params["attn"], h, cfg)
        else:
            y = attn.gqa_train(params["attn"], h, cfg, window=plan.window)
    else:
        y = _MIXERS[plan.kind][1](params["mixer"], h, cfg)
    x = x + y
    if plan.cross:
        hx = rmsnorm(params["norm_x"], x, cfg.norm_eps)
        x = x + attn.cross_attention(params["cross"], hx, memory, cfg)
    aux = None
    if plan.mlp == "dense":
        x = x + mlp(params["mlp"], rmsnorm(params["norm2"], x, cfg.norm_eps),
                    cfg.d_ff)
    elif plan.mlp == "moe":
        y2, aux = moe(params["moe"], rmsnorm(params["norm2"], x,
                                             cfg.norm_eps),
                      cfg, token_ids=token_ids)
        x = x + y2
    return x, aux


def layer_decode(cfg: ModelConfig, plan: LayerPlan, params, x, cache,
                 memory=None):
    """Single-token decode of one layer. Returns (x, cache); the cache is
    updated in place (``cache["seq"]``: the module docstring)."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    seq = cache.get("seq", (1, 0))
    if plan.kind == "attn":
        if cfg.attention == "mla":
            y, cache_m = attn.mla_decode(params["attn"], h, cache["mixer"],
                                         cfg, seq=seq)
        else:
            y, cache_m = attn.gqa_decode(params["attn"], h, cache["mixer"],
                                         cfg, window=plan.window, seq=seq)
    else:
        y, cache_m = _MIXERS[plan.kind][2](params["mixer"], h,
                                           cache["mixer"], cfg)
    x = x + y
    if plan.cross:
        hx = rmsnorm(params["norm_x"], x, cfg.norm_eps)
        x = x + attn.cross_attention(params["cross"], hx, memory, cfg)
    if plan.mlp == "dense":
        x = x + mlp(params["mlp"], rmsnorm(params["norm2"], x, cfg.norm_eps),
                    cfg.d_ff)
    elif plan.mlp == "moe":
        # decode is drop-free (capacity = all tokens): serving must not
        # depend on what else is in the batch
        y2, _ = moe(params["moe"], rmsnorm(params["norm2"], x, cfg.norm_eps),
                    cfg, token_ids=None,
                    capacity_factor=float(cfg.n_experts))
        x = x + y2
    return x, {"mixer": cache_m}


def layer_cache_spec(cfg: ModelConfig, plan: LayerPlan, batch: int,
                     seq: int):
    """{"mixer": {leaf: (shape, dtype)}} of one layer's cache."""
    if plan.kind == "attn":
        if cfg.attention == "mla":
            spec = attn.mla_cache_spec(cfg, batch, seq)
        else:
            spec = attn.gqa_cache_spec(cfg, batch, seq, window=plan.window)
    else:
        spec = _MIXERS[plan.kind][3](cfg, batch)
    return {"mixer": spec}


def stack_apply(cfg: ModelConfig, layers, x, token_ids=None, memory=None):
    """Full-sequence forward through ``layers`` (``LayerParams`` in
    ``plan.layers`` order). Returns (x, aux), the aux summed over the
    layers as the JAX ``stack_apply`` sums it."""
    aux = zero_aux(cfg, x.device)
    tp = tp_split()
    for lp in layers:
        uses = layer_tp_uses(cfg, lp.plan, tp, x.shape[1],
                             x.shape[0] * x.shape[1]) if tp > 1 else {}
        with open_params(lp, uses) as p:
            x, a = layer_apply(cfg, lp.plan, p, x, token_ids, memory)
        if a is not None:
            aux = {k: aux[k] + a[k] for k in aux}
    return x, aux


def stack_decode(cfg: ModelConfig, layers, x, caches, memory=None):
    """Single-token decode through every layer, each opening its
    parameters as ``stack_apply``'s do."""
    new_caches = []
    tp = tp_split()
    for lp, cache in zip(layers, caches):
        uses = layer_tp_uses(cfg, lp.plan, tp, 1, x.shape[0]) \
            if tp > 1 else {}
        with open_params(lp, uses) as p:
            x, c = layer_decode(cfg, lp.plan, p, x, cache, memory)
        new_caches.append(c)
    return x, new_caches


def stack_cache(cfg: ModelConfig, plan: StackPlan, batch: int, seq: int,
                device) -> list:
    """Zeroed per-layer caches, allocated on ``device``."""
    return [{"mixer": {name: torch.zeros(shape, dtype=dtype, device=device)
                       for name, (shape, dtype) in
                       layer_cache_spec(cfg, p, batch, seq)["mixer"].items()}}
            for p in plan.layers]
