"""Sequence-state mixers: Mamba (Jamba's hybrid) and xLSTM's mLSTM and
sLSTM (counterpart of ``repro.models.ssm``).

  * Mamba: selective SSM. Time runs in chunks (a loop over chunks, a
    parallel scan inside each: log2(W) doubling steps of the linear
    recurrence h_t = a_t h_{t-1} + b_t), so a chunk's ``[B, W, di, ds]``
    tensors are the only large transients. Decode carries (conv, ssm)
    states, O(1) a token.
  * mLSTM: matrix memory with sigmoid forget and input gates, chunkwise
    parallel (intra-chunk attention-like products and an inter-chunk
    (C, n) carry), as the JAX package computes it.
  * sLSTM: per-unit scalar memory, sequential over time (a loop over L,
    as the JAX package's ``lax.scan``).

Recurrent states are f32 where the JAX package keeps them f32 (Mamba's
ssm, mLSTM's C and n); decode writes each new state into the cache in
place and returns it.

Tensor parallelism: these mixers do not split over "model" (the
reference pins their channels to "tp"; the channel split is a later
item). Under the sharded train step a mixer's layer takes every weight
whole, gathered over "data" and "model", and computes the same on every
rank of a model row; each rank's gradient of such a leaf is then the
whole gradient, of which the step keeps this rank's slice, with no sum
over "model".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import FSDP, TP, ParamDef


# ---------------------------------------------------------------------------
# Mamba (S6, diagonal)
# ---------------------------------------------------------------------------

def mamba_defs(cfg: ModelConfig):
    D = cfg.d_model
    di = cfg.ssm_expand * D
    ds = cfg.ssm_state_dim
    kc = cfg.ssm_conv_dim
    return {
        "w_in": ParamDef((D, 2 * di), (FSDP, TP), init="scaled"),
        "conv_w": ParamDef((kc, di), (None, TP), init="scaled", scale=0.5),
        "w_bcdt": ParamDef((di, 2 * ds + 1), (TP, None), init="scaled"),
        "dt_bias": ParamDef((di,), (TP,), init="zeros"),
        "a_log": ParamDef((di, ds), (TP, None), init="zeros"),
        "d_skip": ParamDef((di,), (TP,), init="ones"),
        "w_out": ParamDef((di, D), (TP, FSDP), init="scaled"),
    }


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1
    by doubling: after the step of offset o every position holds the
    composition of its last 2o terms. Returns (prod of a up to t, h_t)."""
    W = a.shape[1]
    off = 1
    while off < W:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return a, b


def _mamba_inner(params, xz, cfg: ModelConfig, chunk: int):
    """xz: [B, L, 2 di] after the input projection. Returns [B, L, di]
    before the output projection."""
    B, L, _ = xz.shape
    ds, kc = cfg.ssm_state_dim, cfg.ssm_conv_dim
    x, z = xz.chunk(2, dim=-1)

    # causal depthwise conv (kernel kc)
    xp = F.pad(x, (0, 0, kc - 1, 0))
    x = sum(xp[:, i:i + L] * params["conv_w"][i] for i in range(kc))
    x = F.silu(x)

    bcdt = x @ params["w_bcdt"]
    Bc, Cc, dt = bcdt[..., :ds], bcdt[..., ds:2 * ds], bcdt[..., -1:]
    dt = F.softplus(dt + params["dt_bias"][None, None, :1])  # [B, L, 1]
    A = -torch.exp(params["a_log"].float())  # [di, ds]

    h = torch.zeros((B, x.shape[-1], ds), dtype=torch.float32,
                    device=x.device)
    ys = []
    for a0 in range(0, L, chunk):
        xx, dtc = x[:, a0:a0 + chunk].float(), dt[:, a0:a0 + chunk].float()
        bb, cc = Bc[:, a0:a0 + chunk].float(), Cc[:, a0:a0 + chunk].float()
        dec = torch.exp(dtc[..., None] * A)  # [B, W, di, ds]
        uu = (dtc * xx)[..., None] * bb[:, :, None, :]
        dec_c, hs = linear_scan(dec, uu)
        hs = hs + dec_c * h[:, None]  # the carry in
        ys.append(torch.einsum("blds,bls->bld", hs, cc))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1).to(x.dtype)
    y = y + x * params["d_skip"]
    return y * F.silu(z)


def mamba_train(params, h, cfg: ModelConfig):
    """h: [B, L, D] -> [B, L, D]."""
    xz = h @ params["w_in"]
    L = h.shape[1]
    di = cfg.ssm_expand * cfg.d_model
    # keep the chunk-local [B, W, di, ds] transient within ~16M elements
    budget = 1 << 24
    chunk = max(8, min(256, budget // max(1, di * cfg.ssm_state_dim)))
    chunk = min(chunk, L)
    while L % chunk:
        chunk //= 2
    y = _mamba_inner(params, xz, cfg, chunk=max(1, chunk))
    return y @ params["w_out"]


def mamba_decode(params, h, cache, cfg: ModelConfig):
    """h: [B, 1, D]; cache: conv [B, kc - 1, di], ssm [B, di, ds] f32."""
    ds = cfg.ssm_state_dim
    xz = (h @ params["w_in"])[:, 0]
    x, z = xz.chunk(2, dim=-1)
    conv_in = torch.cat([cache["conv"], x[:, None]], dim=1)  # [B, kc, di]
    xc = F.silu(torch.einsum("bkd,kd->bd", conv_in, params["conv_w"]))
    bcdt = xc @ params["w_bcdt"]
    Bc, Cc, dt = bcdt[:, :ds], bcdt[:, ds:2 * ds], bcdt[:, -1:]
    dt = F.softplus(dt + params["dt_bias"][None, :1])
    A = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt.float()[..., None] * A[None])  # [B, di, ds]
    hnew = decay * cache["ssm"].float() + \
        (dt * xc).float()[..., None] * Bc.float()[:, None, :]
    y = torch.einsum("bds,bs->bd", hnew, Cc.float()).to(h.dtype) \
        + xc * params["d_skip"]
    y = y * F.silu(z)
    out = (y @ params["w_out"])[:, None]
    cache["conv"].copy_(conv_in[:, 1:])
    cache["ssm"].copy_(hnew)
    return out, cache


def mamba_cache_spec(cfg: ModelConfig, batch: int):
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": ((batch, cfg.ssm_conv_dim - 1, di), cfg.compute_dtype),
        # the recurrent state stays f32: precision-critical
        "ssm": ((batch, di, cfg.ssm_state_dim), torch.float32),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory), chunkwise parallel
# ---------------------------------------------------------------------------

def mlstm_defs(cfg: ModelConfig):
    D, H = cfg.d_model, cfg.n_heads
    di = cfg.ssm_expand * D
    return {
        "w_in": ParamDef((D, 2 * di), (FSDP, TP), init="scaled"),
        "w_q": ParamDef((di, di), (TP, None), init="scaled"),
        "w_k": ParamDef((di, di), (TP, None), init="scaled"),
        "w_v": ParamDef((di, di), (TP, None), init="scaled"),
        "w_if": ParamDef((di, 2 * H), (TP, None), init="scaled"),
        "b_if": ParamDef((2 * H,), (None,), init="zeros"),
        "w_out": ParamDef((di, D), (TP, FSDP), init="scaled"),
    }


def _mlstm_qkv_gates(params, x, cfg: ModelConfig):
    """q, k (scaled by 1/sqrt(dh)), v [..., H, dh] and the gate
    pre-activations [..., 2H] of the mixer input x [..., di]."""
    H = cfg.n_heads
    dh = x.shape[-1] // H
    shape = (*x.shape[:-1], H, dh)
    q = (x @ params["w_q"]).reshape(shape)
    k = (x @ params["w_k"]).reshape(shape) / (dh ** 0.5)
    v = (x @ params["w_v"]).reshape(shape)
    return q, k, v, x @ params["w_if"] + params["b_if"]


def mlstm_train(params, h, cfg: ModelConfig):
    B, L, D = h.shape
    Hh = cfg.n_heads
    di = cfg.ssm_expand * D
    dh = di // Hh
    W = min(cfg.mlstm_chunk, L)
    while L % W:
        W //= 2
    W = max(1, W)
    f32 = torch.float32

    x, z = (h @ params["w_in"]).chunk(2, dim=-1)
    q, k, v, gates = _mlstm_qkv_gates(params, x, cfg)
    i_g = torch.sigmoid(gates[..., :Hh]).float()  # [B, L, H]
    lf = F.logsigmoid(gates[..., Hh:]).float()  # log f
    causal = torch.tril(torch.ones((W, W), dtype=torch.bool,
                                   device=h.device))

    C = torch.zeros((B, Hh, dh, dh), dtype=f32, device=h.device)
    n = torch.zeros((B, Hh, dh), dtype=f32, device=h.device)
    ys = []
    for a in range(0, L, W):
        qq, kk, vv = (t[:, a:a + W].float() for t in (q, k, v))
        ii = i_g[:, a:a + W]
        Fc = torch.cumsum(lf[:, a:a + W], dim=1)  # in-chunk cumulative log f
        # intra-chunk: s_jk = (q_j . k_k) exp(F_j - F_k) i_k for k <= j
        dmat = Fc[:, :, None, :] - Fc[:, None, :, :]  # [B, W, W, H]
        s = torch.einsum("bjhd,bkhd->bjkh", qq, kk) * torch.exp(dmat) * \
            ii[:, None, :, :]
        s = torch.where(causal[None, :, :, None], s, 0.0)
        y_intra = torch.einsum("bjkh,bkhd->bjhd", s, vv)
        # inter-chunk: the carry's contribution
        qd = qq * torch.exp(Fc)[..., None]
        y_inter = torch.einsum("bjhd,bhde->bjhe", qd, C)
        n_inter = torch.einsum("bjhd,bhd->bjh", qd, n)
        norm = s.sum(2) + n_inter
        y = (y_intra + y_inter) / torch.clamp(norm.abs(), min=1.0)[..., None]
        # carry update
        Ftot = Fc[:, -1]  # [B, H]
        wk = torch.exp(Ftot[:, None] - Fc) * ii  # [B, W, H]
        C = torch.exp(Ftot)[..., None, None] * C + \
            torch.einsum("bkh,bkhd,bkhe->bhde", wk, kk, vv)
        n = torch.exp(Ftot)[..., None] * n + \
            torch.einsum("bkh,bkhd->bhd", wk, kk)
        ys.append(y.to(h.dtype))
    y = torch.cat(ys, dim=1).reshape(B, L, di)
    y = y * F.silu(z)
    return y @ params["w_out"]


def mlstm_decode(params, h, cache, cfg: ModelConfig):
    B = h.shape[0]
    Hh = cfg.n_heads
    di = cfg.ssm_expand * cfg.d_model
    x, z = (h @ params["w_in"])[:, 0].chunk(2, dim=-1)
    q, k, v, gates = _mlstm_qkv_gates(params, x, cfg)
    q, k, v = q.float(), k.float(), v.float()
    i_g = torch.sigmoid(gates[:, :Hh]).float()[..., None, None]
    f_g = torch.sigmoid(gates[:, Hh:]).float()[..., None, None]
    C1 = f_g * cache["C"] + i_g * torch.einsum("bhd,bhe->bhde", k, v)
    n1 = f_g[..., 0] * cache["n"] + i_g[..., 0] * k
    num = torch.einsum("bhd,bhde->bhe", q, C1)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", q, n1).abs(), min=1.0)
    y = (num / den[..., None]).reshape(B, di).to(h.dtype)
    y = y * F.silu(z)
    cache["C"].copy_(C1)
    cache["n"].copy_(n1)
    return (y @ params["w_out"])[:, None], cache


def mlstm_cache_spec(cfg: ModelConfig, batch: int):
    di = cfg.ssm_expand * cfg.d_model
    dh = di // cfg.n_heads
    return {
        "C": ((batch, cfg.n_heads, dh, dh), torch.float32),
        "n": ((batch, cfg.n_heads, dh), torch.float32),
    }


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, sequential)
# ---------------------------------------------------------------------------

def slstm_defs(cfg: ModelConfig):
    D = cfg.d_model
    di = cfg.ssm_expand * D
    return {
        "w_in": ParamDef((D, di), (FSDP, TP), init="scaled"),
        "w_gates": ParamDef((di, 4 * di), (TP, None), init="scaled"),
        "b_gates": ParamDef((4 * di,), (None,), init="zeros"),
        "w_out": ParamDef((di, D), (TP, FSDP), init="scaled"),
    }


def _slstm_cell(params, x_t, c, n, hprev):
    """x_t and each state: [B, di]. Returns (c, n, h)."""
    gates = (x_t + hprev) @ params["w_gates"] + params["b_gates"]
    zi, ii, fi, oi = gates.chunk(4, dim=-1)
    zt = torch.tanh(zi)
    it, ft, ot = torch.sigmoid(ii), torch.sigmoid(fi), torch.sigmoid(oi)
    c1 = ft * c + it * zt
    n1 = ft * n + it
    return c1, n1, ot * c1 / torch.clamp(n1, min=1.0)


def slstm_train(params, h, cfg: ModelConfig):
    B, L, D = h.shape
    x = h @ params["w_in"]
    c = n = hs = torch.zeros((B, x.shape[-1]), dtype=h.dtype,
                             device=h.device)
    ys = []
    for t in range(L):
        c, n, hs = _slstm_cell(params, x[:, t], c, n, hs)
        ys.append(hs)
    return torch.stack(ys, dim=1) @ params["w_out"]


def slstm_decode(params, h, cache, cfg: ModelConfig):
    x = (h @ params["w_in"])[:, 0]
    c1, n1, h1 = _slstm_cell(params, x, cache["c"], cache["n"], cache["h"])
    out = (h1 @ params["w_out"])[:, None]
    cache["c"].copy_(c1)
    cache["n"].copy_(n1)
    cache["h"].copy_(h1)
    return out, cache


def slstm_cache_spec(cfg: ModelConfig, batch: int):
    di = cfg.ssm_expand * cfg.d_model
    z = ((batch, di), cfg.compute_dtype)
    return {"c": z, "n": z, "h": z}
