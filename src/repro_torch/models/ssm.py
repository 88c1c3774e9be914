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

Tensor parallelism (``tp_split() > 1``; the sharded train step and the
sharded serving steps): where di divides the model ranks each mixer runs
on its block of di channels (``channel_split``), as the reference's
channel axes on "tp" place it, between ``tp_copy`` on its input and
``tp_sum`` on its output projection (rows of ``w_out``). ``w_in`` is
``[x | z]`` for Mamba and mLSTM, so its contiguous shard would be two
blocks of x, or of z: the rank projects through its x- and z-blocks of
the whole weight, or, with fewer rows than d_model, through its shard,
the projections then gathered (``w_in_whole``). Projections out of the
channels (Mamba's ``w_bcdt``, mLSTM's ``w_q``, ``w_k``, ``w_v``,
``w_if``, sLSTM's ``w_gates`` at every time step) are partial sums,
completed by ``tp_sum`` and passed on through ``tp_copy`` (their
gradient summed over the ranks too, since each rank uses the sum on its
own channels). Mamba's ``dt_bias[:1]`` is the global element 0 (the
whole vector). mLSTM's core runs on the rank's heads where the heads
divide the ranks (as ``C`` and ``n`` are placed), else whole on every
rank, its output then cut to the rank's channels. The decode caches
hold the rank's channels (heads) in the same way. ``*_tp_uses`` say how
each leaf is taken (``sharding_ctx.open_params``).

Mamba's dt is one scalar a token shared by every channel and state, so
its gradient (and ``dt_bias``'s) is a sum that cancels heavily, and in
an f32 run its f32 sums in another order (the channels split over the
ranks) moved that gradient past the split's tests' bound. So there
Mamba's contractions over channels (``w_in``'s
backward, ``w_bcdt``, ``w_out``) accumulate in f64 and its scan's
backward is recomputed in f64 from the chunk's inputs, the ranks' parts
of dt's, B's and C's gradients summed in f64 (``_ScanChunk``): the split
then rounds as one device does. A bf16 run keeps its own dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding_ctx import (tp_copy, tp_gather,
                                                  tp_rank, tp_split, tp_sum)

from .config import ModelConfig
from .params import FSDP, TP, ParamDef


# ---------------------------------------------------------------------------
# the channel split over "model"
# ---------------------------------------------------------------------------

def channel_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether a mixer's di channels split over ``tp`` model ranks."""
    return tp > 1 and (cfg.ssm_expand * cfg.d_model) % tp == 0


def _split(cfg: ModelConfig) -> tuple:
    """(ranks, this rank) of the channel split, (1, 0) where the mixer
    computes whole."""
    tp = tp_split()
    return (tp, tp_rank()) if channel_split(cfg, tp) else (1, 0)


def _block(t, tp: int, r: int, start: int = 0, width: int | None = None):
    """Block r of ``tp`` of the last axis's ``[start, start + width)``."""
    width = t.shape[-1] - start if width is None else width
    n = width // tp
    return t[..., start + r * n:start + (r + 1) * n]


def w_in_whole(cfg: ModelConfig, tokens: int) -> bool:
    """Whether a split mixer over ``tokens`` rows takes ``w_in`` whole and
    projects through its x- and z-blocks, rather than projecting through
    its own shard and exchanging the projected blocks over the model
    ranks: whole where the rows outnumber d_model (the bytes each way
    moves are D x 2 di against rows x 2 di)."""
    return tokens >= cfg.d_model


def _in_proj(params, h, cfg: ModelConfig, tp: int, r: int, acc=None):
    """The ``[x | z]`` input projection ``[..., 2 di]`` (accumulated in
    ``acc``): under the split, x-block r and z-block r (``[..., 2 di /
    tp]``), through those columns of the whole ``w_in`` or, handed this
    rank's shard (``w_in_whole``), through the shard, the ranks'
    projections then gathered (their gradient summed over the ranks, each
    of which used its own blocks)."""
    w = params["w_in"]
    acc = h.dtype if acc is None else acc
    if tp == 1:
        return h @ w if acc == h.dtype else \
            (h.to(acc) @ w.to(acc)).to(h.dtype)
    di = cfg.ssm_expand * cfg.d_model
    hh = tp_copy(h.to(acc))
    if w.shape[1] == 2 * di:  # whole: only the rank's columns
        return (hh @ torch.cat([_block(w, tp, r, 0, di),
                                _block(w, tp, r, di, di)], dim=1).to(acc)
                ).to(h.dtype)
    full = tp_copy(tp_gather(hh @ w.to(acc), h.dim() - 1))
    return torch.cat([_block(full, tp, r, 0, di), _block(full, tp, r, di, di)],
                     dim=-1).to(h.dtype)


def _out(y, params, tp: int, acc=None):
    """The output projection: this rank's rows of ``w_out``, summed over
    the ranks under the split (accumulated in ``acc``)."""
    if acc in (None, y.dtype):
        out = y @ params["w_out"]
        return tp_sum(out) if tp > 1 else out
    out = y.to(acc) @ params["w_out"].to(acc)
    return (tp_sum(out) if tp > 1 else out).to(y.dtype)


def _acc(dtype):
    """The dtype Mamba's contractions over channels accumulate in: f64 in
    an f32 run (the module docstring), else the run's own."""
    return torch.float64 if dtype == torch.float32 else dtype


def _channel_uses(cfg: ModelConfig, tokens: int, split: tuple) -> dict:
    """``split`` leaves as this rank's shards, and ``w_in`` whole (each
    rank's gradient a part) or its shard as ``w_in_whole`` says."""
    uses = dict.fromkeys(split, "split")
    uses["w_in"] = "partial" if w_in_whole(cfg, tokens) else "split"
    return uses


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


def mamba_tp_uses(cfg: ModelConfig, tp: int, tokens: int) -> dict:
    """How a Mamba mixer over ``tokens`` rows takes its parameters over
    ``tp`` model ranks: its channels' shards; ``w_in`` whole (each rank's
    gradient a part) or its shard (``w_in_whole``); ``dt_bias`` whole (its
    global element 0, added to the completed sum)."""
    if not channel_split(cfg, tp):
        return {}
    return _channel_uses(cfg, tokens, ("conv_w", "w_bcdt", "a_log",
                                       "d_skip", "w_out"))


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


def _scan_chunk(xx, dtc, bb, cc, A, h):
    """One chunk of the selective scan: x ``[B, W, di]``, dt ``[B, W, 1]``,
    B and C ``[B, W, ds]``, A ``[di, ds]``, the carry in ``[B, di, ds]``.
    Returns (y ``[B, W, di]``, the carry out)."""
    dec = torch.exp(dtc[..., None] * A)  # [B, W, di, ds]
    uu = (dtc * xx)[..., None] * bb[:, :, None, :]
    dec_c, hs = linear_scan(dec, uu)
    hs = hs + dec_c * h[:, None]  # the carry in
    return torch.einsum("blds,bls->bld", hs, cc), hs[:, -1]


class _ScanChunk(torch.autograd.Function):
    """``_scan_chunk`` in x's dtype (dt, B and C given in f64, exactly
    x's values); backward, recomputed in f64 from the inputs, dt's, B's
    and C's gradients left in f64 for the sum over the model ranks."""

    @staticmethod
    def forward(ctx, xx, dtc, bb, cc, A, h):
        ctx.save_for_backward(xx, dtc, bb, cc, A, h)
        return _scan_chunk(xx, dtc.to(xx.dtype), bb.to(xx.dtype),
                           cc.to(xx.dtype), A, h)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        ins = [t.detach().double().requires_grad_(n)
               for t, n in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, h_out = _scan_chunk(*ins)
            outs = [(y, gy)] + ([(h_out, gh)] if gh is not None else [])
            want = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in outs], want, [g.double() for _, g in outs],
                allow_unused=True))
        grads = []
        for t, x in zip(ins, saved):
            g = next(got) if t.requires_grad else None
            if t.requires_grad and g is None:
                g = torch.zeros_like(t)
            grads.append(None if g is None else g.to(x.dtype))
        return tuple(grads)


def _mamba_inner(params, xz, cfg: ModelConfig, chunk: int, tp: int = 1):
    """xz: [B, L, 2 di] after the input projection (this rank's channels
    under the split, ``tp`` ranks). Returns [B, L, di] before the output
    projection."""
    B, L, _ = xz.shape
    ds, kc = cfg.ssm_state_dim, cfg.ssm_conv_dim
    x, z = xz.chunk(2, dim=-1)
    acc = _acc(x.dtype)

    # causal depthwise conv (kernel kc)
    xp = F.pad(x, (0, 0, kc - 1, 0))
    x = sum(xp[:, i:i + L] * params["conv_w"][i] for i in range(kc))
    x = F.silu(x)

    bcdt = x.to(acc) @ params["w_bcdt"].to(acc)
    if tp > 1:
        bcdt = tp_sum(bcdt)
    bcdt = bcdt.to(x.dtype)
    Bc, Cc, dt = bcdt[..., :ds], bcdt[..., ds:2 * ds], bcdt[..., -1:]
    dt = F.softplus(dt + params["dt_bias"][None, None, :1])  # [B, L, 1]
    exact = acc == torch.float64
    if exact or tp > 1:
        bcdt = torch.cat([Bc, Cc, dt], dim=-1).to(acc)
        if tp > 1:  # each rank uses B, C and dt on its own channels
            bcdt = tp_copy(bcdt)
        Bc, Cc, dt = bcdt.split([ds, ds, 1], dim=-1)
    A = -torch.exp(params["a_log"].float())  # [di, ds]

    h = torch.zeros((B, x.shape[-1], ds), dtype=torch.float32,
                    device=x.device)
    ys = []
    for a0 in range(0, L, chunk):
        xx = x[:, a0:a0 + chunk].float()
        dtc, bb, cc = (t[:, a0:a0 + chunk] for t in (dt, Bc, Cc))
        if exact:
            y, h = _ScanChunk.apply(xx, dtc, bb, cc, A, h)
        else:
            y, h = _scan_chunk(xx, dtc.float(), bb.float(), cc.float(), A,
                               h)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(x.dtype)
    y = y + x * params["d_skip"]
    return y * F.silu(z)


def mamba_train(params, h, cfg: ModelConfig):
    """h: [B, L, D] -> [B, L, D]."""
    tp, r = _split(cfg)
    xz = _in_proj(params, h, cfg, tp, r, _acc(h.dtype))
    L = h.shape[1]
    di = cfg.ssm_expand * cfg.d_model
    # keep the chunk-local [B, W, di, ds] transient within ~16M elements
    budget = 1 << 24
    chunk = max(8, min(256, budget // max(1, di * cfg.ssm_state_dim)))
    chunk = min(chunk, L)
    while L % chunk:
        chunk //= 2
    y = _mamba_inner(params, xz, cfg, chunk=max(1, chunk), tp=tp)
    return _out(y, params, tp, _acc(y.dtype))


def mamba_decode(params, h, cache, cfg: ModelConfig):
    """h: [B, 1, D]; cache: conv [B, kc - 1, di], ssm [B, di, ds] f32 (di
    this rank's channels under the split)."""
    ds = cfg.ssm_state_dim
    tp, r = _split(cfg)
    acc = _acc(h.dtype)
    x, z = _in_proj(params, h, cfg, tp, r, acc)[:, 0].chunk(2, dim=-1)
    conv_in = torch.cat([cache["conv"], x[:, None]], dim=1)  # [B, kc, di]
    xc = F.silu(torch.einsum("bkd,kd->bd", conv_in, params["conv_w"]))
    bcdt = xc.to(acc) @ params["w_bcdt"].to(acc)
    if tp > 1:
        bcdt = tp_sum(bcdt)
    bcdt = bcdt.to(xc.dtype)
    Bc, Cc, dt = bcdt[:, :ds], bcdt[:, ds:2 * ds], bcdt[:, -1:]
    dt = F.softplus(dt + params["dt_bias"][None, :1])
    A = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt.float()[..., None] * A[None])  # [B, di, ds]
    hnew = decay * cache["ssm"].float() + \
        (dt * xc).float()[..., None] * Bc.float()[:, None, :]
    y = torch.einsum("bds,bs->bd", hnew, Cc.float()).to(h.dtype) \
        + xc * params["d_skip"]
    y = y * F.silu(z)
    out = _out(y, params, tp, acc)[:, None]
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


def mlstm_tp_uses(cfg: ModelConfig, tp: int, tokens: int) -> dict:
    """How an mLSTM mixer over ``tokens`` rows takes its parameters over
    ``tp`` model ranks: the rows of its channels of the projections and
    ``w_out``; ``w_in`` as Mamba's; the gate bias whole, added to the
    completed sum."""
    if not channel_split(cfg, tp):
        return {}
    return _channel_uses(cfg, tokens, ("w_q", "w_k", "w_v", "w_if",
                                       "w_out"))


def _mlstm_qkv_gates(params, x, cfg: ModelConfig, tp: int = 1):
    """q, k (scaled by 1/sqrt(dh)), v [..., H, dh] and the gate
    pre-activations [..., 2H] of the mixer input x [..., di]; under the
    split, x is this rank's channels and the four projections' partial
    sums are completed together (one ``tp_sum``, then ``tp_copy``)."""
    H = cfg.n_heads
    if tp == 1:
        qp, kp, vp = (x @ params[n] for n in ("w_q", "w_k", "w_v"))
        gates = x @ params["w_if"] + params["b_if"]
    else:
        di = params["w_q"].shape[1]
        s = tp_sum(torch.cat([x @ params[n] for n in
                              ("w_q", "w_k", "w_v", "w_if")], dim=-1))
        s = tp_copy(torch.cat([s[..., :3 * di],
                               s[..., 3 * di:] + params["b_if"]], dim=-1))
        qp, kp, vp, gates = s.split([di, di, di, 2 * H], dim=-1)
    dh = qp.shape[-1] // H
    shape = (*qp.shape[:-1], H, dh)
    q = qp.reshape(shape)
    k = kp.reshape(shape) / (dh ** 0.5)
    v = vp.reshape(shape)
    return q, k, v, gates


def _mlstm_heads(cfg: ModelConfig, tp: int, r: int, q, k, v, gates):
    """q, k, v and the gates of the heads this rank's core runs: block r
    where the heads divide the ranks, else all of them."""
    H = cfg.n_heads
    if tp == 1 or H % tp:
        return q, k, v, gates
    n = H // tp
    heads = slice(r * n, (r + 1) * n)
    return (q[..., heads, :], k[..., heads, :], v[..., heads, :],
            torch.cat([_block(gates, tp, r, 0, H), _block(gates, tp, r, H, H)],
                      dim=-1))


def _mlstm_channels(cfg: ModelConfig, y, tp: int, r: int):
    """The core's output ``[..., di']`` on this rank's channels: as it is
    where the core ran on the rank's heads, block r where it ran whole."""
    if tp == 1 or cfg.n_heads % tp == 0:
        return y
    return _block(y, tp, r)


def mlstm_train(params, h, cfg: ModelConfig):
    B, L, D = h.shape
    W = min(cfg.mlstm_chunk, L)
    while L % W:
        W //= 2
    W = max(1, W)
    f32 = torch.float32
    tp, r = _split(cfg)

    x, z = _in_proj(params, h, cfg, tp, r).chunk(2, dim=-1)
    q, k, v, gates = _mlstm_heads(cfg, tp, r,
                                  *_mlstm_qkv_gates(params, x, cfg, tp))
    Hh, dh = q.shape[-2:]
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
    y = torch.cat(ys, dim=1).reshape(B, L, Hh * dh)
    y = _mlstm_channels(cfg, y, tp, r) * F.silu(z)
    return _out(y, params, tp)


def mlstm_decode(params, h, cache, cfg: ModelConfig):
    """h: [B, 1, D]; cache: C [B, H, dh, dh], n [B, H, dh] f32 (this rank's
    heads where the split runs the core on them)."""
    B = h.shape[0]
    tp, r = _split(cfg)
    x, z = _in_proj(params, h, cfg, tp, r)[:, 0].chunk(2, dim=-1)
    q, k, v, gates = _mlstm_heads(cfg, tp, r,
                                  *_mlstm_qkv_gates(params, x, cfg, tp))
    Hh = q.shape[1]
    q, k, v = q.float(), k.float(), v.float()
    i_g = torch.sigmoid(gates[:, :Hh]).float()[..., None, None]
    f_g = torch.sigmoid(gates[:, Hh:]).float()[..., None, None]
    C1 = f_g * cache["C"] + i_g * torch.einsum("bhd,bhe->bhde", k, v)
    n1 = f_g[..., 0] * cache["n"] + i_g[..., 0] * k
    num = torch.einsum("bhd,bhde->bhe", q, C1)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", q, n1).abs(), min=1.0)
    y = (num / den[..., None]).reshape(B, -1).to(h.dtype)
    y = _mlstm_channels(cfg, y, tp, r) * F.silu(z)
    cache["C"].copy_(C1)
    cache["n"].copy_(n1)
    return _out(y, params, tp)[:, None], cache


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


def slstm_tp_uses(cfg: ModelConfig, tp: int, tokens: int) -> dict:
    """How an sLSTM mixer takes its parameters over ``tp`` model ranks (at
    any ``tokens``): the columns of its channels of ``w_in`` (its shard),
    the rows of ``w_gates`` and ``w_out``; the gate bias whole, added to
    the completed sum."""
    if not channel_split(cfg, tp):
        return {}
    return dict.fromkeys(("w_in", "w_gates", "w_out"), "split")


def _slstm_cell(params, x_t, c, n, hprev, tp: int = 1, r: int = 0):
    """x_t and each state: [B, di] (this rank's channels under the split,
    where the recurrent product's partial sums are completed at every
    step and the rank's block taken from each of the four gate chunks).
    Returns (c, n, h)."""
    if tp == 1:
        gates = (x_t + hprev) @ params["w_gates"] + params["b_gates"]
        zi, ii, fi, oi = gates.chunk(4, dim=-1)
    else:
        gates = tp_copy(tp_sum((x_t + hprev) @ params["w_gates"])
                        + params["b_gates"])
        zi, ii, fi, oi = (_block(g, tp, r) for g in gates.chunk(4, dim=-1))
    zt = torch.tanh(zi)
    it, ft, ot = torch.sigmoid(ii), torch.sigmoid(fi), torch.sigmoid(oi)
    c1 = ft * c + it * zt
    n1 = ft * n + it
    return c1, n1, ot * c1 / torch.clamp(n1, min=1.0)


def slstm_train(params, h, cfg: ModelConfig):
    B, L, D = h.shape
    tp, r = _split(cfg)
    x = (tp_copy(h) if tp > 1 else h) @ params["w_in"]
    c = n = hs = torch.zeros((B, x.shape[-1]), dtype=h.dtype,
                             device=h.device)
    ys = []
    for t in range(L):
        c, n, hs = _slstm_cell(params, x[:, t], c, n, hs, tp, r)
        ys.append(hs)
    return _out(torch.stack(ys, dim=1), params, tp)


def slstm_decode(params, h, cache, cfg: ModelConfig):
    """h: [B, 1, D]; cache: c, n, h [B, di] (this rank's channels under
    the split)."""
    tp, r = _split(cfg)
    x = ((tp_copy(h) if tp > 1 else h) @ params["w_in"])[:, 0]
    c1, n1, h1 = _slstm_cell(params, x, cache["c"], cache["n"], cache["h"],
                             tp, r)
    out = _out(h1, params, tp)[:, None]
    cache["c"].copy_(c1)
    cache["n"].copy_(n1)
    cache["h"].copy_(h1)
    return out, cache


def slstm_cache_spec(cfg: ModelConfig, batch: int):
    di = cfg.ssm_expand * cfg.d_model
    z = ((batch, di), cfg.compute_dtype)
    return {"c": z, "n": z, "h": z}
