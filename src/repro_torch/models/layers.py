"""Shared model layers: RMSNorm, RoPE, SwiGLU MLP, embeddings (counterpart
of ``repro.models.layers``; the loss waits for the training slice)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamDef


# ---- RMSNorm --------------------------------------------------------------

def rmsnorm_defs(dim: int):
    return {"scale": ParamDef((dim,), init="ones")}


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
        "w_gate": ParamDef((D, Fd), init="scaled"),
        "w_up": ParamDef((D, Fd), init="scaled"),
        "w_down": ParamDef((Fd, D), init="scaled"),
    }


def mlp(params, x):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (F.silu(g) * u) @ params["w_down"]


# ---- embeddings / unembedding ---------------------------------------------

def embed_defs(cfg: ModelConfig):
    defs = {"tok": ParamDef((cfg.vocab_size, cfg.d_model))}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   init="scaled")
    return defs


def embed(params, tokens, cfg: ModelConfig):
    return params["tok"][tokens.long()].to(cfg.compute_dtype)


def unembed(params, x, cfg: ModelConfig):
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w
