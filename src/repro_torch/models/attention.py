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

Tensor parallelism (the sharded train step, ``tp_split() > 1``): a layer
whose heads divide the model ranks runs this rank's heads (``wq``/``wo``
its columns and rows; ``wk``/``wv`` its KV heads' columns where the KV
heads divide too, else the whole weights, from which it takes the KV
heads its query heads read) between ``tp_copy`` and ``tp_sum``, the flash
kernel on ``[B, H/tp, L, dh]``. Where the heads do not divide, the
reference's resolver puts "sp" on the query axis: rank r projects the
queries of rows ``[r L/tp, (r+1) L/tp)`` and the keys and values of all
rows with the whole weights, attends with ``q_offset = r L/tp``, applies
``wo`` and joins the blocks of rows by ``tp_gather``; the whole weights'
gradients are then this rank's part ("partial"). Where L does not divide
either, the layer computes whole on every rank. ``*_tp_uses`` say how
each layer takes its parameters (``sharding_ctx.open_params``). Decode
(one query row, so never "sp") runs on the rank's heads in head mode and
whole otherwise, against caches the sharded serve step places as the
reference's cache rules do; a cache whose sequence axis splits over
"data" (context parallelism) is written by the rank that holds the slot,
masked by global slot index, and its softmax combined over the data
ranks (``sharding_ctx.cp_attend``).

Activations are ``[B, L, H, dh]``; the flash wrapper takes ``[B, H, L,
dh]``; GQA caches are ``{"k": [B, S, KV, dh], "v": ..., "pos": [B]
int32}``, MLA's ``{"ckv": [B, S, r], "krope": [B, S, rope_dim], "pos"}``.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding_ctx import (cp_attend, tp_copy,
                                                  tp_gather, tp_rank,
                                                  tp_split, tp_sum)
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


def _heads(x, w, b, dh: int):
    y = x @ w
    if b is not None:
        y = y + b
    return y.reshape(*x.shape[:2], -1, dh)


def _norm_rope(params, t, norm: str, cfg: ModelConfig, positions):
    if cfg.qk_norm:
        t = rmsnorm(params[norm], t, cfg.norm_eps)
    return apply_rope(t, positions, cfg.rope_theta)


def _bias(params, name: str, cfg: ModelConfig):
    return params[name] if cfg.qkv_bias else None


def _project_q(params, x, cfg: ModelConfig, positions):
    q = _heads(x, params["wq"], _bias(params, "bq", cfg), cfg.head_dim)
    return _norm_rope(params, q, "q_norm", cfg, positions)


def _project_kv(params, x, cfg: ModelConfig, positions):
    dh = cfg.head_dim
    k = _heads(x, params["wk"], _bias(params, "bk", cfg), dh)
    v = _heads(x, params["wv"], _bias(params, "bv", cfg), dh)
    return _norm_rope(params, k, "k_norm", cfg, positions), v


def _project_qkv(params, x, cfg: ModelConfig, positions):
    return (_project_q(params, x, cfg, positions),
            *_project_kv(params, x, cfg, positions))


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
                      mat_dtype=torch.float32, q_offset=0):
    """q: [B,L,H,dh]; k/v: [B,Lk,KV,dh]; query row i at absolute position
    ``q_offset + i``.

    Sequences longer than ``CHUNKED_ATTN_THRESHOLD`` run q in chunks of up
    to 1,024 rows, so a score tensor is [B,H,chunk,S] instead of
    [B,H,L,S]."""
    B, L, H, dh = q.shape
    group = H // k.shape[2]
    qh = q.transpose(1, 2).float()  # [B,H,L,dh]
    kh = k.transpose(1, 2).repeat_interleave(group, dim=1).float()
    vh = v.transpose(1, 2).repeat_interleave(group, dim=1).float()
    if L <= CHUNKED_ATTN_THRESHOLD:
        out = _attn_block(qh, kh, vh, q_offset, dh, causal, window,
                          mat_dtype)
    else:
        chunk = 1024
        while L % chunk:
            chunk //= 2
        out = torch.cat([_attn_block(qh[:, :, a:a + chunk], kh, vh,
                                     q_offset + a, dh, causal, window,
                                     mat_dtype)
                         for a in range(0, L, chunk)], dim=2)
    return out.transpose(1, 2).to(q.dtype)


def causal_mask(L: int, window: int = 0, device=None):
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (j > i - window)
    return m


# ---- tensor parallelism over "model" --------------------------------------

def attn_mode(n_heads: int, L: int, tp: int) -> str:
    """How a layer of ``n_heads`` heads over L query rows splits over
    ``tp`` model ranks, as the reference resolves ("dp", "tp", "sp", None)
    on its scores: "heads" where the heads divide, else "sp" (blocks of
    query rows) where L divides, else "none" (whole on every rank)."""
    if tp <= 1:
        return "none"
    if n_heads % tp == 0:
        return "heads"
    return "sp" if L % tp == 0 else "none"


def _leaf_names(defs: dict, prefix: str = "") -> list:
    out = []
    for k, d in defs.items():
        out += _leaf_names(d, f"{prefix}{k}.") if isinstance(d, dict) \
            else [f"{prefix}{k}"]
    return out


def gqa_tp_uses(cfg: ModelConfig, tp: int, L: int, cross: bool = False):
    """How a GQA (or, ``cross``, a cross-attention) layer over L query rows
    takes its parameters over ``tp`` model ranks."""
    mode = attn_mode(cfg.n_heads, L, tp)
    names = _leaf_names(cross_defs(cfg) if cross else gqa_defs(cfg))
    if mode == "none":
        return {}
    if mode == "sp":
        return dict.fromkeys(names, "partial")
    kv = "split" if cfg.n_kv_heads % tp == 0 else "partial"
    return {n: "split" if n in ("wq", "bq", "wo") else
            kv if n in ("wk", "wv", "bk", "bv") else "partial"
            for n in names}


def _kv_heads(cfg: ModelConfig, tp: int, rank: int) -> tuple:
    """(first, count, index) of the KV heads that rank's query heads read
    when the KV heads do not divide the ranks: query head ``rank H/tp + i``
    reads local KV head ``index[i]``, or ``i // (H/tp / count)`` (the flash
    kernel's grouping) where ``index`` is None."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Hl, g = H // tp, H // KV
    a = rank * Hl
    lo = a // g
    n = (a + Hl - 1) // g + 1 - lo
    idx = [(a + i) // g - lo for i in range(Hl)]
    grouped = Hl % n == 0 and idx == [i // (Hl // n) for i in range(Hl)]
    return lo, n, None if grouped else idx


def _local_kv_params(params, cfg: ModelConfig, tp: int) -> tuple:
    """In head mode, ``params`` with ``wk``/``wv`` (``bk``/``bv``) cut to
    the KV heads this rank reads, and the query heads' index into them
    (None: grouped). Where the KV heads divide the ranks the step already
    handed over this rank's shards."""
    if cfg.n_kv_heads % tp == 0:
        return params, None
    lo, n, idx = _kv_heads(cfg, tp, tp_rank())
    cols = slice(lo * cfg.head_dim, (lo + n) * cfg.head_dim)
    out = dict(params, wk=params["wk"][:, cols], wv=params["wv"][:, cols])
    if cfg.qkv_bias:
        out.update(bk=params["bk"][cols], bv=params["bv"][cols])
    return out, idx


def _by_query_head(t, idx):
    return t if idx is None else t[:, :, idx]


def _attend(q, k, v, cfg: ModelConfig, window: int, q_offset: int = 0):
    """Causal attention of q ``[B, Lq, Hq, dh]`` (rows from ``q_offset``)
    over k, v ``[B, L, Hkv, dh]``: the flash kernel for a global layer
    when ``cfg.attn_impl == "kernel"``, else the masked attention."""
    if cfg.attn_impl == "kernel" and window == 0:
        return flash_attention(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(), causal=True,
                               q_offset=q_offset).transpose(1, 2)
    return _masked_attention(q, k, v, causal=True, window=window,
                             mat_dtype=cfg.attn_mat_dtype, q_offset=q_offset)


def _query_rows(x, L: int, tp: int, mode: str) -> tuple:
    """(x entering a split block, the rows of it this rank queries from,
    the first one's position): all rows but in "sp", there this rank's
    block of L/tp."""
    if mode != "none":
        x = tp_copy(x)
    if mode != "sp":
        return x, x, 0
    off = tp_rank() * (L // tp)
    return x, x[:, off:off + L // tp], off


def _tp_join(y, mode: str):
    """Leave a split block: the ranks' partial outputs summed in head
    mode, their blocks of rows joined in "sp"."""
    if mode == "heads":
        return tp_sum(y)
    return tp_gather(y, 1) if mode == "sp" else y


def gqa_train(params, x, cfg: ModelConfig, window: int = 0):
    """Split over the model ranks as the module docstring says: this
    rank's query heads (head mode) or query rows ("sp")."""
    B, L, _ = x.shape
    tp = tp_split()
    mode = attn_mode(cfg.n_heads, L, tp)
    x, xq, off = _query_rows(x, L, tp, mode)
    Lq = xq.shape[1]
    kvp, idx = (_local_kv_params(params, cfg, tp) if mode == "heads"
                else (params, None))
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device).expand(B, L)
    q = _project_q(params, xq, cfg, positions[:, off:off + Lq])
    k, v = _project_kv(kvp, x, cfg, positions)
    out = _attend(q, _by_query_head(k, idx), _by_query_head(v, idx), cfg,
                  window, off)
    return _tp_join(out.reshape(B, Lq, -1) @ params["wo"], mode)


def _write_slot(cache, names, new, slot, seq):
    """Write ``new[i]`` (one ``[B, ...]`` tensor a leaf of ``names``) at
    each row's global ``slot`` [B]: in place on one rank; with the
    sequence axis split over "data" (``seq`` = (n, r)), only on the rank
    whose block holds the slot."""
    B = slot.shape[0]
    rows = torch.arange(B, device=slot.device)
    n, r = seq
    if n == 1:
        for name, t in zip(names, new):
            cache[name][rows, slot] = t.to(cache[name].dtype)
        return
    S_loc = cache[names[0]].shape[1]
    mine = (slot // S_loc) == r
    local = slot % S_loc
    for name, t in zip(names, new):
        c = cache[name]
        keep = mine.view(B, *([1] * (t.dim() - 1)))
        c[rows, local] = torch.where(keep, t.to(c.dtype), c[rows, local])


def _slot_indices(S_loc: int, seq, device):
    """The global slot indices ``[1, S_loc]`` of this rank's block."""
    n, r = seq
    return r * S_loc + torch.arange(S_loc, dtype=torch.int32,
                                    device=device)[None, :]


def _softmax_attend(s, values, eq: str, seq, shape=None):
    """Softmax over the last axis of the masked scores ``s`` (seen as
    ``shape``), then the weighted sum of ``values`` by ``eq``: on one
    rank as it stands; with the sequence split over "data", the ranks'
    parts combined (``sharding_ctx.cp_attend``)."""
    shape = shape or s.shape
    if seq[0] == 1:
        return torch.einsum(eq, torch.softmax(s, dim=-1).reshape(shape),
                            values)
    return cp_attend(s.reshape(shape), lambda e: torch.einsum(eq, e, values))


def gqa_decode(params, x, cache, cfg: ModelConfig, window: int = 0,
               seq=(1, 0)):
    """x: [B,1,D]; cache: {k: [B,S,KV,dh], v: ..., pos: [B]}; ring-buffered
    when ``window`` > 0 (local layers keep an O(window) cache). Writes the
    new key and value into the cache and advances ``pos`` in place (the
    port's counterpart of buffer donation); returns (y, cache).

    Split over the model ranks on this rank's query heads where they
    divide (the cache holding the rank's KV heads where those divide too,
    else all of them, every rank writing all of them from the whole
    ``wk``/``wv`` and reading those its query heads read); ``seq`` = (n,
    r): the cache's sequence axis is block r of n over "data" (the slot's
    rank writes it; validity by global slot; the softmax combined over
    the ranks)."""
    B = x.shape[0]
    pos = cache["pos"]  # [B] next absolute position
    tp = tp_split()
    mode = attn_mode(cfg.n_heads, 1, tp)
    if mode == "heads":
        x = tp_copy(x)
    q, k_new, v_new = _project_qkv(params, x, cfg, pos[:, None])
    S_loc = cache["k"].shape[1]
    S = S_loc * seq[0]
    slot = pos % S if window > 0 else pos
    # the reference's dynamic_update_slice clamps the start into range
    slot = slot.clamp(0, S - 1).long()
    _write_slot(cache, ("k", "v"), (k_new[:, 0], v_new[:, 0]), slot, seq)
    # validity: a slot is live if already written (<= pos), or — for ring
    # buffers — always once the ring has wrapped (pos >= S)
    idx = _slot_indices(S_loc, seq, x.device)
    valid = (idx <= pos[:, None]) | ((window > 0) & (pos[:, None] >= S))
    keys, values = cache["k"], cache["v"]
    if mode == "heads" and cfg.n_kv_heads % tp:
        lo, n, sel = _kv_heads(cfg, tp, tp_rank())
        keys, values = keys[:, :, lo:lo + n], values[:, :, lo:lo + n]
        keys, values = _by_query_head(keys, sel), _by_query_head(values, sel)
    H, KV, dh = q.shape[2], keys.shape[2], cfg.head_dim
    g = H // KV
    qg = q[:, 0].float().reshape(B, KV, g, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     keys.float()).reshape(B, H, S_loc) / (dh ** 0.5)
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    out = _softmax_attend(s, values.float(), "bkgs,bskd->bkgd", seq,
                          (B, KV, g, S_loc)).to(x.dtype)
    y = (out.reshape(B, H * dh) @ params["wo"])[:, None]
    pos.add_(1)
    return (tp_sum(y) if mode == "heads" else y), cache


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


def mla_tp_uses(cfg: ModelConfig, tp: int, L: int) -> dict:
    """How an MLA layer over L rows takes its parameters over ``tp`` model
    ranks: in head mode this rank's heads of the up-projections and ``wo``,
    the compressed KV, its RoPE key and the query's down-projection whole
    (each rank's gradient a part); in "sp" every weight whole."""
    mode = attn_mode(cfg.n_heads, L, tp)
    if mode == "none":
        return {}
    names = _leaf_names(mla_defs(cfg))
    if mode == "sp":
        return dict.fromkeys(names, "partial")
    split = ("w_uk", "w_uv", "wo", "w_uq", "wq")
    return {n: "split" if n in split else "partial" for n in names}


def mla_train(params, x, cfg: ModelConfig):
    """MLA full-sequence attention: the decoupled-RoPE score q_nope.k_nope +
    q_rope.k_rope is one dot over the concatenated [dh ; rope_dim] feature
    axis (k_rope broadcast per head). Split over the model ranks as the
    module docstring says (c_kv and k_rope on every rank)."""
    B, L, D = x.shape
    dh, rd = cfg.head_dim, cfg.rope_dim
    tp = tp_split()
    mode = attn_mode(cfg.n_heads, L, tp)
    x, xq, off = _query_rows(x, L, tp, mode)
    Lq = xq.shape[1]
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device).expand(B, L)
    q_nope, q_rope = _mla_q(params, xq, cfg, positions[:, off:off + Lq])
    H = q_nope.shape[2]  # this rank's heads in head mode
    c_kv, k_rope = _mla_kv_new(params, x, cfg, positions)
    k_nope = _up(c_kv, params["w_uk"])
    v = _up(c_kv, params["w_uv"])
    q_cat = torch.cat([q_nope, q_rope], dim=-1)  # [B, Lq, H, dh + rd]
    k_cat = torch.cat([k_nope, k_rope.expand(B, L, H, rd)], dim=-1)
    del k_nope
    out = _masked_attention(q_cat, k_cat, v, causal=True,
                            mat_dtype=cfg.attn_mat_dtype, q_offset=off)
    return _tp_join(out.reshape(B, Lq, H * dh) @ params["wo"], mode)


def mla_decode(params, x, cache, cfg: ModelConfig, seq=(1, 0)):
    """Absorbed-matrices decode against the compressed cache (c_kv,
    k_rope), written and advanced in place. Split over the model ranks on
    this rank's heads where they divide (the compressed cache whole on
    every rank, each writing it); ``seq`` as ``gqa_decode``'s."""
    B = x.shape[0]
    dh, rd = cfg.head_dim, cfg.rope_dim
    pos = cache["pos"]
    mode = attn_mode(cfg.n_heads, 1, tp_split())
    if mode == "heads":
        x = tp_copy(x)
    q_nope, q_rope = _mla_q(params, x, cfg, pos[:, None])  # [B, 1, H, *]
    H = q_nope.shape[2]
    c_new, kr_new = _mla_kv_new(params, x, cfg, pos[:, None])
    S_loc = cache["ckv"].shape[1]
    S = S_loc * seq[0]
    slot = pos.clamp(0, S - 1).long()  # dynamic_update_slice's clamp
    _write_slot(cache, ("ckv", "krope"), (c_new[:, 0], kr_new[:, 0, 0]),
                slot, seq)
    ckv = cache["ckv"].float()
    # absorb: q_c[h] = q_nope[h] @ W_uk[:, h, :]^T -> scores vs the cache
    q_c = torch.einsum("bhe,rhe->bhr", q_nope[:, 0], params["w_uk"])
    scale = 1.0 / ((dh + rd) ** 0.5)
    s = (torch.einsum("bhr,bsr->bhs", q_c.float(), ckv)
         + torch.einsum("bhe,bse->bhs", q_rope[:, 0].float(),
                        cache["krope"].float())) * scale
    valid = _slot_indices(S_loc, seq, x.device) <= pos[:, None]
    s = s.masked_fill(~valid[:, None], NEG_INF)
    o_c = _softmax_attend(s, ckv, "bhs,bsr->bhr", seq)  # [B, H, r]
    out = torch.einsum("bhr,rhe->bhe", o_c.to(x.dtype), params["w_uv"])
    y = (out.reshape(B, H * dh) @ params["wo"])[:, None]
    pos.add_(1)
    return (tp_sum(y) if mode == "heads" else y), cache


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
    """x: [B, L, D] decoder states; memory: [B, S, D] encoder output. Split
    over the model ranks as GQA (no causal mask: "sp" splits the decoder's
    rows and reads all of the memory)."""
    B, L, _ = x.shape
    tp, dh = tp_split(), cfg.head_dim
    mode = attn_mode(cfg.n_heads, L, tp)
    _, xq, _ = _query_rows(x, L, tp, mode)
    if mode != "none":
        memory = tp_copy(memory)
    kvp, idx = (_local_kv_params(params, cfg, tp) if mode == "heads"
                else (params, None))
    q = _heads(xq, params["wq"], None, dh)
    k = _heads(memory, kvp["wk"], None, dh)
    v = _heads(memory, kvp["wv"], None, dh)
    out = _masked_attention(q, _by_query_head(k, idx), _by_query_head(v, idx),
                            causal=False, mat_dtype=cfg.attn_mat_dtype)
    return _tp_join(out.reshape(B, xq.shape[1], -1) @ params["wo"], mode)
