"""Shared model layers: RMSNorm, RoPE, SwiGLU MLP, embeddings and the
loss (counterpart of ``repro.models.layers``).

Under the sharded train step's tensor parallelism (``tp_split() > 1``,
``distributed.sharding_ctx``) the MLP is column- then row-parallel
(``w_gate``/``w_up`` this rank's columns, ``w_down`` its rows, between
``tp_copy`` and ``tp_sum``) where d_ff divides the model ranks, and the
vocabulary is split where it divides them: the embedding looks up this
rank's rows (a masked lookup, summed over the ranks), the logits are this
rank's columns and the cross entropy is vocab-parallel
(``softmax_xent(..., vocab_start=)``). The reference's ``constrain`` calls
on these activations resolve to the same split; a dimension that does not
divide keeps the whole computation on every rank, as its resolver drops
the axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed.sharding_ctx import (current, dp_sum, tp_copy,
                                                  tp_gather, tp_rank,
                                                  tp_split, tp_sum)

from .config import ModelConfig
from .params import FSDP, TP, ParamDef


# ---- RMSNorm --------------------------------------------------------------

def rmsnorm_defs(dim: int):
    return {"scale": ParamDef((dim,), (None,), init="ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(dt)


# ---- RoPE -----------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., L, H, dh]; positions: [..., L] int32. Split-halves
    rotation, in f32, cast back to x's dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [dh/2]
    ang = positions[..., None].float() * freqs  # [..., L, dh/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---- SwiGLU MLP -----------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None):
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    return {
        "w_gate": ParamDef((D, Fd), (FSDP, TP), init="scaled"),
        "w_up": ParamDef((D, Fd), (FSDP, TP), init="scaled"),
        "w_down": ParamDef((Fd, D), (TP, FSDP), init="scaled"),
    }


def mlp_split(d_ff: int, tp: int) -> bool:
    """Whether a d_ff-wide MLP splits over ``tp`` model ranks."""
    return tp > 1 and d_ff % tp == 0


def mlp_tp_uses(d_ff: int, tp: int) -> dict:
    """How the split MLP takes its parameters (``sharding_ctx.open_params``)."""
    if not mlp_split(d_ff, tp):
        return {}
    return {"w_gate": "split", "w_up": "split", "w_down": "split"}


def mlp(params, x, d_ff: int | None = None):
    """SwiGLU; with ``d_ff`` (the layer's full width) it splits over the
    model ranks where ``mlp_split`` says so, its weights then this rank's
    shards."""
    split = d_ff is not None and mlp_split(d_ff, tp_split())
    if split:
        x = tp_copy(x)
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    y = (F.silu(g) * u) @ params["w_down"]
    return tp_sum(y) if split else y


# ---- embeddings / unembedding ---------------------------------------------

def embed_defs(cfg: ModelConfig):
    defs = {"tok": ParamDef((cfg.vocab_size, cfg.d_model), (TP, FSDP))}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size), (FSDP, TP),
                                   init="scaled")
    return defs


def vocab_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether the vocabulary splits over ``tp`` model ranks."""
    return tp > 1 and cfg.vocab_size % tp == 0


def embed_tp_uses(cfg: ModelConfig, tp: int) -> dict:
    if not vocab_split(cfg, tp):
        return {}
    return {"tok": "split", "unembed": "split"}


def vocab_start(cfg: ModelConfig):
    """The first vocabulary id of this rank's logits, or None when the
    logits are whole."""
    tp = tp_split()
    return tp_rank() * (cfg.vocab_size // tp) if vocab_split(cfg, tp) \
        else None


def embed(params, tokens, cfg: ModelConfig):
    start = vocab_start(cfg)
    if start is None:
        return params["tok"][tokens.long()].to(cfg.compute_dtype)
    tok = params["tok"]  # this rank's rows
    t = tokens.long() - start
    inside = (t >= 0) & (t < tok.shape[0])
    e = tok[torch.where(inside, t, 0)].to(cfg.compute_dtype)
    return tp_sum(e.masked_fill(~inside[..., None], 0))


def unembed(params, x, cfg: ModelConfig):
    if vocab_start(cfg) is not None:
        x = tp_copy(x)
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w


def whole_vocab(logits, cfg: ModelConfig):
    """Logits over the whole vocabulary: under the split, this rank's
    columns joined with the other model ranks' (serving gathers them
    before any argmax or sampling)."""
    if vocab_start(cfg) is None:
        return logits
    return tp_gather(logits, logits.dim() - 1)


# ---- loss -----------------------------------------------------------------

class _VocabParallelXent(torch.autograd.Function):
    """Per-token logsumexp minus the gold logit of logits split over the
    model ranks by vocabulary (this rank's columns ``[start, start + V_l)``):
    the max, the sum of exponentials and the gold logit through
    ``all_reduce`` over ``group``. Backward: softmax minus one-hot on this
    rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        m = logits.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        lab = labels.long() - start
        inside = (lab >= 0) & (lab < logits.shape[-1])
        lab = torch.where(inside, lab, 0)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        sums = torch.stack([e.sum(dim=-1), gold * inside])
        dist.all_reduce(sums, group=group)
        ctx.save_for_backward(e, sums[0], lab, inside)
        return torch.log(sums[0]) + m - sums[1]

    @staticmethod
    def backward(ctx, g):
        e, total, lab, inside = ctx.saved_tensors
        grad = e / total[..., None]
        grad.scatter_add_(-1, lab[..., None],
                          -inside.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


def softmax_xent(logits, labels, mask=None, vocab_start=None):
    """Token-mean cross entropy in f32: logsumexp minus the gold logit;
    labels int, mask optional bool (a masked mean over max(sum(mask),
    1)). Under a sharding context with several data ranks, the mean over
    the global batch: the ranks' sums over their counts (``dp_sum``).
    ``vocab_start``: the logits are this model rank's columns from that id
    on (``layers.vocab_start``), completed over the model ranks."""
    logits = logits.float()
    if vocab_start is not None:
        nll = _VocabParallelXent.apply(logits, labels, vocab_start,
                                       current().model_group())
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = logz - gold
    ctx = current()
    if ctx is not None and ctx.dp_size > 1:
        m = torch.ones_like(nll) if mask is None else mask.float()
        return dp_sum(torch.sum(nll * m)) / torch.clamp_min(
            dp_sum(torch.sum(m)), 1.0)
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.mean(nll)
