"""Mixture-of-Experts layer: shared and routed experts, top-k, capacity-
based sort dispatch (counterpart of ``repro.models.moe``), on one device
and, under a sharding context, expert-parallel.

Each token's top-k experts get it in stream order up to a capacity of
``int(max(1, min(N, cf N K / E)))`` tokens an expert; the rest are
dropped (their share of the output is zero). The packed ``[E, cap, D]``
buffer goes through the experts as batched matrix products. Dropped rows
land in one scratch row past the buffer (the JAX scatter's
``mode="drop"``), so the dispatch needs no host sync.

Expert parallelism (the reference's ``shard_map`` branch). Under a
``ShardingCtx`` a rank holds its data shard's rows (the trainer shards
every batch over dp, so N here is the reference's ``N_loc = N / ndp`` and
the capacity its ``cap_loc``; its fallback to ndp = 1 for N % ndp != 0,
a batch not split over dp, does not arise) and dispatches them locally.
Where the experts resolve onto "model" ("ep", the weights' TP axis), the
ranks of one model row hold the same packed buffer, so the reference's
first all-to-all is a slice: a rank runs only its own block of experts,
and the second is an all-gather over the model group. The two are each
other's gradient: the layer's input and output lie on the residual
stream, which is the same on every rank of a model row under tensor
parallelism too (the split blocks end in ``tp_sum`` and begin with
``tp_copy``, whose backward completes the input's gradient), so the
gathered output's gradient is the same on those ranks. The sharded train
step hands a rank its own experts' weights (``moe_tp_uses``); a whole
tree (one device, or a caller's own) is cut here. The router is whole on
every rank and the shared expert is the split MLP (``layers.mlp`` with its
width). The global quantities come
from sums over dp (``dp_sum``): ``density`` (a bincount), ``router_prob``
and the z-loss (means), ``dropped`` and the telemetry; ``lb_loss`` is their
product, so it is not a mean of the shards' values.

Telemetry: the router emits a (token-bucket x expert) count matrix — the
graph stream ``telemetry.router_sketch.RouterTelemetry`` summarises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed.sharding_ctx import current, dp_sum

from .config import ModelConfig
from .layers import mlp, mlp_defs, mlp_tp_uses
from .params import FSDP, TP, ParamDef

TELEMETRY_BUCKETS = 256  # token-hash buckets for the routing stream


def moe_defs(cfg: ModelConfig):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        "router": ParamDef((D, E), (FSDP, None), init="scaled"),
        "w_gate": ParamDef((E, D, Fd), (TP, FSDP, None), init="scaled"),
        "w_up": ParamDef((E, D, Fd), (TP, FSDP, None), init="scaled"),
        "w_down": ParamDef((E, Fd, D), (TP, None, FSDP), init="scaled"),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(cfg, cfg.moe_d_ff * cfg.n_shared_experts)
    return defs


def moe_tp_uses(cfg: ModelConfig, tp: int) -> dict:
    """How the layer takes its parameters over ``tp`` model ranks: this
    rank's experts where they divide (expert parallelism), the shared
    expert as the split MLP, the router whole."""
    uses = {}
    if tp > 1 and cfg.n_experts % tp == 0:
        uses.update(dict.fromkeys(("w_gate", "w_up", "w_down"), "split"))
    if cfg.n_shared_experts:
        uses.update({f"shared.{k}": v for k, v in mlp_tp_uses(
            cfg.moe_d_ff * cfg.n_shared_experts, tp).items()})
    return uses


def zero_aux(cfg: ModelConfig, device) -> dict:
    """The aux of a layer without experts: zero losses and counts."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z.clone(), "dropped": z.clone(),
            "telemetry": torch.zeros((TELEMETRY_BUCKETS,
                                      max(cfg.n_experts, 1)),
                                     dtype=torch.int32, device=device)}


class _ExpertSlice(torch.autograd.Function):
    """Forward: this rank's block ``index`` of ``n`` along the expert axis;
    backward: the blocks' gradients gathered over ``group``."""

    @staticmethod
    def forward(ctx, xe, index, n, group):
        ctx.n, ctx.group = n, group
        return xe.chunk(n, 0)[index].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.n, ctx.group), None, None, None


class _ExpertGather(torch.autograd.Function):
    """Forward: the ranks' expert blocks gathered over ``group``;
    backward: this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, ye, index, n, group):
        ctx.index, ctx.n = index, n
        return _gather(ye.contiguous(), n, group)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, 0)[ctx.index].clone(), None, None, None


def _gather(t, n, group):
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, 0)


def _expert_block(ctx, E: int, cap: int, D: int):
    """(index, n, group) of this rank's expert block when the experts
    resolve onto "model" (as the reference's ``constrain(xe, "ep", "dp",
    None)``), else None."""
    if ctx is None:
        return None
    spec = ctx.resolve(("ep", "dp", None), (E, cap * ctx.dp_size, D))
    if spec[0] != "model":
        return None
    return ctx.coordinate("model"), ctx.shape["model"], ctx.group("model")


def moe(params, x, cfg: ModelConfig, token_ids=None,
        capacity_factor: float | None = None):
    """x: [B, S, D] -> (y, aux); aux holds the load-balance and router
    z losses, the dropped share and the ``[TELEMETRY_BUCKETS, E]`` int32
    count matrix (zeros without ``token_ids``).

    ``capacity_factor`` overrides the config's (decode passes E: capacity
    = N tokens an expert, drop-free serving that matches the prefill)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    dev = x.device
    xf = x.reshape(N, D)
    cf = capacity_factor if capacity_factor is not None \
        else cfg.capacity_factor

    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)  # [N, K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- sort-based dispatch: slot = rank of (token, k) within its expert
    cap = int(max(1, min(N, cf * N * K / E)))
    fe = expert_ids.reshape(N * K)
    order = torch.argsort(fe, stable=True)
    grp_start = torch.searchsorted(fe[order],
                                   torch.arange(E, dtype=fe.dtype, device=dev))
    pos = torch.empty_like(fe)
    pos[order] = torch.arange(N * K, device=dev) - grp_start[fe[order]]
    keep = pos < cap
    dest = torch.where(keep, fe * cap + pos, E * cap)  # dropped: scratch row
    tok_idx = torch.arange(N * K, device=dev) // K
    buf = torch.zeros((E * cap + 1, D), dtype=xf.dtype, device=dev)
    buf[dest] = xf[tok_idx]
    xe = buf[:E * cap].view(E, cap, D)
    del buf

    ctx = current()
    ws = params["w_gate"], params["w_up"], params["w_down"]
    block = _expert_block(ctx, E, cap, D)
    if block is not None:  # expert parallelism: this rank's experts only
        xe = _ExpertSlice.apply(xe, *block)
        if ws[0].shape[0] == E:  # a whole tree: cut this rank's experts
            ws = [w.chunk(block[1], 0)[block[0]] for w in ws]
    g = torch.bmm(xe, ws[0])  # [E, cap, F]
    u = torch.bmm(xe, ws[1])
    del xe
    g = F.silu(g) * u
    del u
    ye = torch.bmm(g, ws[2]).to(xf.dtype)
    del g
    if block is not None:
        ye = _ExpertGather.apply(ye, *block)
    ye = ye.reshape(E * cap, D)
    back = ye[torch.where(keep, dest, 0)] * keep[:, None].to(ye.dtype)
    y = (back.reshape(N, K, D) * gate_vals[..., None].to(ye.dtype)).sum(1)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x,
                    cfg.moe_d_ff * cfg.n_shared_experts)

    # aux losses (Switch/GShard) and the router z-loss
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    counts = torch.bincount(fe, minlength=E).float()
    if ctx is None or ctx.dp_size == 1:
        density = counts / N
        lb_loss = E * torch.sum(density * probs.mean(0))
        z_loss = torch.mean(lse2)
        dropped = 1.0 - keep.sum().float() / (N * K)
    else:  # global over the data ranks, N tokens each
        n_all = N * ctx.dp_size
        density = dp_sum(counts) / n_all
        lb_loss = E * torch.sum(density * dp_sum(probs.sum(0)) / n_all)
        z_loss = dp_sum(lse2.sum()) / n_all
        dropped = 1.0 - dp_sum(keep.sum().float()) / (n_all * K)

    # telemetry stream: (token-bucket -> expert) weighted edges
    if token_ids is not None:
        bucket = (token_ids.reshape(N).long() % TELEMETRY_BUCKETS)
        cell = (bucket[:, None] * E + expert_ids).reshape(-1)
        tele = torch.bincount(cell, minlength=TELEMETRY_BUCKETS * E).view(
            TELEMETRY_BUCKETS, E).to(torch.int32)
        tele = dp_sum(tele)
    else:
        tele = torch.zeros((TELEMETRY_BUCKETS, E), dtype=torch.int32,
                           device=dev)
    return y, {"lb_loss": lb_loss, "z_loss": z_loss, "dropped": dropped,
               "telemetry": tele}
