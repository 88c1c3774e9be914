"""Mixture-of-Experts layer: shared and routed experts, top-k, capacity-
based sort dispatch (counterpart of ``repro.models.moe`` on one device,
its ``ctx is None`` branch; expert parallelism waits for the sharding
slice).

Each token's top-k experts get it in stream order up to a capacity of
``int(max(1, min(N, cf N K / E)))`` tokens an expert; the rest are
dropped (their share of the output is zero). The packed ``[E, cap, D]``
buffer goes through the experts as batched matrix products. Dropped rows
land in one scratch row past the buffer (the JAX scatter's
``mode="drop"``), so the dispatch needs no host sync.

Telemetry: the router emits a (token-bucket x expert) count matrix — the
graph stream ``telemetry.router_sketch.RouterTelemetry`` summarises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import mlp, mlp_defs
from .params import ParamDef

TELEMETRY_BUCKETS = 256  # token-hash buckets for the routing stream


def moe_defs(cfg: ModelConfig):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        "router": ParamDef((D, E), init="scaled"),
        "w_gate": ParamDef((E, D, Fd), init="scaled"),
        "w_up": ParamDef((E, D, Fd), init="scaled"),
        "w_down": ParamDef((E, Fd, D), init="scaled"),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(cfg, cfg.moe_d_ff * cfg.n_shared_experts)
    return defs


def zero_aux(cfg: ModelConfig, device) -> dict:
    """The aux of a layer without experts: zero losses and counts."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z.clone(), "dropped": z.clone(),
            "telemetry": torch.zeros((TELEMETRY_BUCKETS,
                                      max(cfg.n_experts, 1)),
                                     dtype=torch.int32, device=device)}


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

    g = torch.bmm(xe, params["w_gate"])  # [E, cap, F]
    u = torch.bmm(xe, params["w_up"])
    del xe
    g = F.silu(g) * u
    del u
    ye = torch.bmm(g, params["w_down"]).to(xf.dtype).view(E * cap, D)
    del g
    back = ye[torch.where(keep, dest, 0)] * keep[:, None].to(ye.dtype)
    y = (back.reshape(N, K, D) * gate_vals[..., None].to(ye.dtype)).sum(1)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x)

    # aux losses (Switch/GShard) and the router z-loss
    density = torch.bincount(fe, minlength=E).float() / N
    lb_loss = E * torch.sum(density * probs.mean(0))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = 1.0 - keep.sum().float() / (N * K)

    # telemetry stream: (token-bucket -> expert) weighted edges
    if token_ids is not None:
        bucket = (token_ids.reshape(N).long() % TELEMETRY_BUCKETS)
        cell = (bucket[:, None] * E + expert_ids).reshape(-1)
        tele = torch.bincount(cell, minlength=TELEMETRY_BUCKETS * E).view(
            TELEMETRY_BUCKETS, E).to(torch.int32)
    else:
        tele = torch.zeros((TELEMETRY_BUCKETS, E), dtype=torch.int32,
                           device=dev)
    return y, {"lb_loss": lb_loss, "z_loss": z_loss, "dropped": dropped,
               "telemetry": tele}
