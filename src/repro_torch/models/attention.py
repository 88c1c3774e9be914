"""Attention variants: GQA (+qk-norm, +bias, +sliding window), MLA and
cross attention (counterpart of ``repro.models.attention``).

Two entry points per variant:
  *_train : full-sequence causal attention (prefill) — for GQA the flash
            kernel when ``cfg.attn_impl == "kernel"`` and the layer has no
            window, else ``_masked_attention``; MLA's q/k are
            ``dh + rope_dim`` wide and its v ``dh``, so it always takes
            ``_masked_attention``, as in the JAX package;
  *_decode: one token against a cache (serving), updated in place.

MLA follows DeepSeek-V2: KV compressed to ``kv_lora_rank`` plus a
decoupled RoPE head; its decode is the absorbed form (q projected through
W_uk, scores read the compressed cache directly). Cross attention (the
encoder-decoder's) is non-causal ``_masked_attention`` over the encoder's
memory.

Activations are ``[B, L, H, dh]``; the flash wrapper takes ``[B, H, L,
dh]``; GQA caches are ``{"k": [B, S, KV, dh], "v": ..., "pos": [B]
int32}``, MLA's ``{"ckv": [B, S, r], "krope": [B, S, rope_dim], "pos"}``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import \
    attention as flash_attention

from .config import ModelConfig
from .layers import apply_rope, rmsnorm, rmsnorm_defs
from .params import FSDP, TP, ParamDef

NEG_INF = -1e30


def gqa_defs(cfg: ModelConfig):
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((D, H * dh), (FSDP, TP), init="scaled"),
        "wk": ParamDef((D, KV * dh), (FSDP, TP), init="scaled"),
        "wv": ParamDef((D, KV * dh), (FSDP, TP), init="scaled"),
        "wo": ParamDef((H * dh, D), (TP, FSDP), init="scaled"),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * dh,), (TP,), init="zeros")
        defs["bk"] = ParamDef((KV * dh,), (TP,), init="zeros")
        defs["bv"] = ParamDef((KV * dh,), (TP,), init="zeros")
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_defs(cfg: ModelConfig):
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    r, rd = cfg.kv_lora_rank, cfg.rope_dim
    qr = cfg.q_lora_rank
    defs = {
        "w_dkv": ParamDef((D, r), (FSDP, TP), init="scaled"),
        "w_krope": ParamDef((D, rd), (FSDP, None), init="scaled"),
        "w_uk": ParamDef((r, H, dh), (None, TP, None), init="scaled"),
        "w_uv": ParamDef((r, H, dh), (None, TP, None), init="scaled"),
        "wo": ParamDef((H * dh, D), (TP, FSDP), init="scaled"),
        "kv_norm": rmsnorm_defs(r),
    }
    if qr:
        defs["w_dq"] = ParamDef((D, qr), (FSDP, TP), init="scaled")
        defs["w_uq"] = ParamDef((qr, H, dh + rd), (None, TP, None),
                                init="scaled")
        defs["q_norm"] = rmsnorm_defs(qr)
    else:
        defs["wq"] = ParamDef((D, H, dh + rd), (FSDP, TP, None),
                              init="scaled")
    return defs


def _up(x, w):
    """x [..., r] through w [r, H, e] -> [..., H, e]."""
    r, H, e = w.shape
    return (x @ w.reshape(r, H * e)).reshape(*x.shape[:-1], H, e)


def _mla_q(params, x, cfg: ModelConfig, positions):
    dh = cfg.head_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
        q = _up(cq, params["w_uq"])
    else:
        q = _up(x, params["wq"])
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv_new(params, x, cfg: ModelConfig, positions):
    """The compressed KV ``[B, L, r]`` and the rotated shared RoPE key
    ``[B, L, 1, rope_dim]`` of x's positions."""
    c_kv = rmsnorm(params["kv_norm"], x @ params["w_dkv"], cfg.norm_eps)
    k_rope = apply_rope((x @ params["w_krope"])[:, :, None], positions,
                        cfg.rope_theta)
    return c_kv, k_rope


def mla_train(params, x, cfg: ModelConfig):
    """MLA full-sequence attention: the decoupled-RoPE score q_nope.k_nope +
    q_rope.k_rope is one dot over the concatenated [dh ; rope_dim] feature
    axis (k_rope broadcast per head)."""
    B, L, D = x.shape
    H, dh, rd = cfg.n_heads, cfg.head_dim, cfg.rope_dim
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device).expand(B, L)
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    c_kv, k_rope = _mla_kv_new(params, x, cfg, positions)
    k_nope = _up(c_kv, params["w_uk"])
    v = _up(c_kv, params["w_uv"])
    q_cat = torch.cat([q_nope, q_rope], dim=-1)  # [B, L, H, dh + rd]
    k_cat = torch.cat([k_nope, k_rope.expand(B, L, H, rd)], dim=-1)
    del k_nope
    out = _masked_attention(q_cat, k_cat, v, causal=True,
                            mat_dtype=cfg.attn_mat_dtype)
    return out.reshape(B, L, H * dh) @ params["wo"]


def mla_decode(params, x, cache, cfg: ModelConfig):
    """Absorbed-matrices decode against the compressed cache (c_kv,
    k_rope), written and advanced in place."""
    B = x.shape[0]
    H, dh, rd = cfg.n_heads, cfg.head_dim, cfg.rope_dim
    pos = cache["pos"]
    q_nope, q_rope = _mla_q(params, x, cfg, pos[:, None])  # [B, 1, H, *]
    c_new, kr_new = _mla_kv_new(params, x, cfg, pos[:, None])
    S = cache["ckv"].shape[1]
    slot = pos.clamp(0, S - 1).long()  # dynamic_update_slice's clamp
    rows = torch.arange(B, device=x.device)
    cache["ckv"][rows, slot] = c_new[:, 0].to(cache["ckv"].dtype)
    cache["krope"][rows, slot] = kr_new[:, 0, 0].to(cache["krope"].dtype)
    ckv = cache["ckv"].float()
    # absorb: q_c[h] = q_nope[h] @ W_uk[:, h, :]^T -> scores vs the cache
    q_c = torch.einsum("bhe,rhe->bhr", q_nope[:, 0], params["w_uk"])
    scale = 1.0 / ((dh + rd) ** 0.5)
    s = (torch.einsum("bhr,bsr->bhs", q_c.float(), ckv)
         + torch.einsum("bhe,bse->bhs", q_rope[:, 0].float(),
                        cache["krope"].float())) * scale
    valid = torch.arange(S, dtype=torch.int32,
                         device=x.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~valid[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhs,bsr->bhr", p, ckv)  # [B, H, r]
    out = torch.einsum("bhr,rhe->bhe", o_c.to(x.dtype), params["w_uv"])
    y = (out.reshape(B, H * dh) @ params["wo"])[:, None]
    pos.add_(1)
    return y, cache


def mla_cache_spec(cfg: ModelConfig, batch: int, seq: int):
    return {
        "ckv": ((batch, seq, cfg.kv_lora_rank), cfg.compute_dtype),
        "krope": ((batch, seq, cfg.rope_dim), cfg.compute_dtype),
        "pos": ((batch,), torch.int32),
    }


# ---------------------------------------------------------------------------
# cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_defs(cfg: ModelConfig):
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamDef((D, H * dh), (FSDP, TP), init="scaled"),
        "wk": ParamDef((D, KV * dh), (FSDP, TP), init="scaled"),
        "wv": ParamDef((D, KV * dh), (FSDP, TP), init="scaled"),
        "wo": ParamDef((H * dh, D), (TP, FSDP), init="scaled"),
    }


def cross_attention(params, x, memory, cfg: ModelConfig):
    """x: [B, L, D] decoder states; memory: [B, S, D] encoder output."""
    B, L, _ = x.shape
    S = memory.shape[1]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, L, H, dh)
    k = (memory @ params["wk"]).reshape(B, S, KV, dh)
    v = (memory @ params["wv"]).reshape(B, S, KV, dh)
    out = _masked_attention(q, k, v, causal=False,
                            mat_dtype=cfg.attn_mat_dtype)
    return out.reshape(B, L, H * dh) @ params["wo"]
