"""GQA attention (+qk-norm, +bias, +sliding window): counterpart of the GQA
half of ``repro.models.attention``. MLA and cross attention wait for
their slices.

Two entry points:
  gqa_train : full-sequence causal attention (prefill) — the flash
              kernel when ``cfg.attn_impl == "kernel"`` and the layer has
              no window, else ``_masked_attention``;
  gqa_decode: one token against a KV cache (serving), updated in place.

Activations are ``[B, L, H, dh]``; the flash wrapper takes ``[B, H, L,
dh]``; caches are ``{"k": [B, S, KV, dh], "v": ..., "pos": [B] int32}``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import \
    attention as flash_attention

from .config import ModelConfig
from .layers import apply_rope, rmsnorm, rmsnorm_defs
from .params import ParamDef

NEG_INF = -1e30


def gqa_defs(cfg: ModelConfig):
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((D, H * dh), init="scaled"),
        "wk": ParamDef((D, KV * dh), init="scaled"),
        "wv": ParamDef((D, KV * dh), init="scaled"),
        "wo": ParamDef((H * dh, D), init="scaled"),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * dh,), init="zeros")
        defs["bk"] = ParamDef((KV * dh,), init="zeros")
        defs["bv"] = ParamDef((KV * dh,), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_defs(dh)
        defs["k_norm"] = rmsnorm_defs(dh)
    return defs


def _project_qkv(params, x, cfg: ModelConfig, positions):
    B, L, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, L, H, dh)
    k = k.reshape(B, L, KV, dh)
    v = v.reshape(B, L, KV, dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


CHUNKED_ATTN_THRESHOLD = 8192  # above this, q is processed in blocks


def _attn_block(qh, kh, vh, q_offset, dh, causal, window,
                mat_dtype=torch.float32):
    """qh: [B,H,Lq,dh]; kh/vh: [B,H,S,dh]. Returns [B,H,Lq,dh] f32.

    ``mat_dtype`` is the storage dtype of the score/prob tensors; the
    softmax reduces in f32 regardless."""
    S, Lq = kh.shape[2], qh.shape[2]
    s = (qh.to(mat_dtype) @ kh.to(mat_dtype).transpose(-1, -2)) / \
        torch.tensor(dh ** 0.5, dtype=mat_dtype)
    if causal:
        qi = q_offset + torch.arange(Lq, device=qh.device)[:, None]
        ki = torch.arange(S, device=qh.device)[None, :]
        m = ki <= qi
        if window:
            m = m & (ki > qi - window)
        s = torch.where(m, s, torch.tensor(NEG_INF, dtype=torch.float32
                                           ).to(mat_dtype))
    p = torch.softmax(s.float(), dim=-1).to(mat_dtype)
    return (p @ vh.to(mat_dtype)).float()


def _masked_attention(q, k, v, causal=True, window=0,
                      mat_dtype=torch.float32):
    """q: [B,L,H,dh]; k/v: [B,Lk,KV,dh].

    Sequences longer than ``CHUNKED_ATTN_THRESHOLD`` run q in chunks of up
    to 1,024 rows, so a score tensor is [B,H,chunk,S] instead of
    [B,H,L,S]."""
    B, L, H, dh = q.shape
    group = H // k.shape[2]
    qh = q.transpose(1, 2).float()  # [B,H,L,dh]
    kh = k.transpose(1, 2).repeat_interleave(group, dim=1).float()
    vh = v.transpose(1, 2).repeat_interleave(group, dim=1).float()
    if L <= CHUNKED_ATTN_THRESHOLD:
        out = _attn_block(qh, kh, vh, 0, dh, causal, window, mat_dtype)
    else:
        chunk = 1024
        while L % chunk:
            chunk //= 2
        out = torch.cat([_attn_block(qh[:, :, a:a + chunk], kh, vh, a, dh,
                                     causal, window, mat_dtype)
                         for a in range(0, L, chunk)], dim=2)
    return out.transpose(1, 2).to(q.dtype)


def causal_mask(L: int, window: int = 0, device=None):
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (j > i - window)
    return m


def gqa_train(params, x, cfg: ModelConfig, window: int = 0):
    B, L, D = x.shape
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device).expand(B, L)
    q, k, v = _project_qkv(params, x, cfg, positions)
    if cfg.attn_impl == "kernel" and window == 0:
        out = flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=True).transpose(1, 2)
    else:
        out = _masked_attention(q, k, v, causal=True, window=window,
                                mat_dtype=cfg.attn_mat_dtype)
    return out.reshape(B, L, cfg.n_heads * cfg.head_dim) @ params["wo"]


def gqa_decode(params, x, cache, cfg: ModelConfig, window: int = 0):
    """x: [B,1,D]; cache: {k: [B,S,KV,dh], v: ..., pos: [B]}; ring-buffered
    when ``window`` > 0 (local layers keep an O(window) cache). Writes the
    new key and value into the cache and advances ``pos`` in place (the
    port's counterpart of buffer donation); returns (y, cache)."""
    B = x.shape[0]
    pos = cache["pos"]  # [B] next absolute position
    q, k_new, v_new = _project_qkv(params, x, cfg, pos[:, None])
    S = cache["k"].shape[1]
    slot = pos % S if window > 0 else pos
    # the reference's dynamic_update_slice clamps the start into range
    slot = slot.clamp(0, S - 1).long()
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    # validity: a slot is live if already written (<= pos), or — for ring
    # buffers — always once the ring has wrapped (pos >= S)
    idx = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    valid = (idx <= pos[:, None]) | ((window > 0) & (pos[:, None] >= S))
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = H // KV
    qg = q[:, 0].float().reshape(B, KV, g, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     cache["k"].float()).reshape(B, H, S) / (dh ** 0.5)
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).reshape(B, KV, g, S)
    out = torch.einsum("bkgs,bskd->bkgd", p, cache["v"].float()).to(x.dtype)
    y = (out.reshape(B, H * dh) @ params["wo"])[:, None]
    pos.add_(1)
    return y, cache


def gqa_cache_spec(cfg: ModelConfig, batch: int, seq: int, window: int = 0):
    """{leaf: (shape, dtype)} of one layer's cache."""
    S = min(seq, window) if window else seq
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": ((batch, S, KV, dh), cfg.compute_dtype),
        "v": ((batch, S, KV, dh), cfg.compute_dtype),
        "pos": ((batch,), torch.int32),
    }
