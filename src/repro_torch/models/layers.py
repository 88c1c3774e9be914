"""Shared model layers: RMSNorm, RoPE, SwiGLU MLP, embeddings and the
loss (counterpart of ``repro.models.layers``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding_ctx import current, dp_sum

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


def mlp(params, x):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (F.silu(g) * u) @ params["w_down"]


# ---- embeddings / unembedding ---------------------------------------------

def embed_defs(cfg: ModelConfig):
    defs = {"tok": ParamDef((cfg.vocab_size, cfg.d_model), (TP, FSDP))}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size), (FSDP, TP),
                                   init="scaled")
    return defs


def embed(params, tokens, cfg: ModelConfig):
    return params["tok"][tokens.long()].to(cfg.compute_dtype)


def unembed(params, x, cfg: ModelConfig):
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w


# ---- loss -----------------------------------------------------------------

def softmax_xent(logits, labels, mask=None):
    """Token-mean cross entropy in f32: logsumexp minus the gold logit;
    labels int, mask optional bool (a masked mean over max(sum(mask),
    1)). Under a sharding context with several data ranks, the mean over
    the global batch: the ranks' sums over their counts (``dp_sum``)."""
    logits = logits.float()
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
