"""Rank bodies of ``tests/test_torch_sharded_train.py``: the sharded train
step, the expert-parallel MoE and a resumed sharded run, on gloo ranks
(no JAX here; the ranks import this module by path)."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.distributed.sharding_ctx import (dp_sum, local_slice,
                                                  use_sharding_ctx)
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.step_fns import (full_state_leaves, init_train_state,
                                         local_rows, make_sharded_train_step,
                                         shard_state, state_placements)
from repro_torch.launch.train import train
from repro_torch.models.moe import moe, moe_defs
from repro_torch.models.params import init_tree
from repro_torch.optim import AdamWConfig

MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
SMOL, KIMI = "smollm_135m", "kimi_k2_1t_a32b"
B, S = 4, 32  # the reduced train cell's sequence length
STEPS = 2
SMOL_MICROBATCHES = 2
# eps = 1e-3: AdamW's update a smooth function of the gradient, so the
# sharded and single-device parameters agree to 1e-6 (test_torch_train)
OPT = AdamWConfig(lr_peak=1e-3, warmup_steps=2, decay_steps=10, eps=1e-3)
MOE_TOKENS = (4, 32)
MOE_CFS = ("drop-free", 1.25)
RESUME = dict(arch=SMOL, batch_size=4, seq_len=32, seed=0, lr_peak=1e-3,
              log_every=100, ckpt_every=0, schedule_steps=6)
RESUME_SPLIT = 3


def kimi_config():
    """Reduced Kimi-K2, drop-free (capacity factor E / K)."""
    cfg = configs.get(KIMI, reduced=True)
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


def batches(cfg, seed: int, n: int = STEPS) -> list:
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                              dtype=np.int32))
             for k in ("tokens", "labels")} for _ in range(n)]


def moe_inputs(cfg):
    """x, token ids, the loss's projection and the layer's parameters, one
    seed each."""
    rng = np.random.default_rng(7)
    b, s = MOE_TOKENS
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    ids = rng.integers(0, 4096, (b, s), dtype=np.int32)
    proj = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    params = init_tree(moe_defs(cfg), torch.Generator().manual_seed(3),
                       torch.float32, "cpu")
    return x, ids, proj, params


def capacity(cfg, cf):
    return float(cfg.n_experts / cfg.top_k) if cf == "drop-free" else cf


def check_shards(cfg, state, mesh) -> None:
    """Each parameter and moment rests as this rank's slice of its full
    leaf under the placements its specs resolve to."""
    want = state_placements(cfg, OPT, mesh)
    full = full_state_leaves(state)
    shards = {f"params.{k}": v for k, v in state.params.named_parameters()}
    shards.update({f"opt.mu.{k}": v for k, v in state.opt["mu"].items()})
    shards.update({f"opt.nu.{k}": v for k, v in state.opt["nu"].items()})
    for key, v in shards.items():
        assert isinstance(v, DTensor), key
        name = key.split(".", 2)[-1] if key.startswith("opt") else \
            key[len("params."):]
        assert tuple(v.placements) == tuple(want.params[name]), key
        assert torch.equal(v.to_local(),
                           local_slice(full[key], v.placements, mesh)), key


def sharded_steps(cfg, mesh, microbatches: int, seed: int) -> dict:
    """STEPS sharded steps from the seeded state on seeded batches: the
    metrics, the full leaves after them and the telemetry."""
    state = shard_state(cfg, OPT, init_train_state(
        cfg, OPT, torch.Generator().manual_seed(0), "cpu"), mesh)
    step = make_sharded_train_step(cfg, OPT, mesh, microbatches)
    n_data, row = mesh.size(0), mesh.get_coordinate()[0]
    metrics = []
    for b in batches(cfg, seed):
        state, m = step(state, local_rows(b, microbatches, n_data, row))
        metrics.append({k: float(v) for k, v in m.items()})
    check_shards(cfg, state, mesh)
    full = {k: v.numpy() for k, v in full_state_leaves(state).items()
            if k.startswith("params.")}
    return dict(metrics=metrics, params=full,
                telemetry=state.telemetry.numpy())


def moe_case(cfg, mesh, cf) -> dict:
    """The layer on this data rank's rows under the mesh: its output
    gathered over the data ranks, the aux, and the gradients (summed over
    the data ranks) of sum(y * proj) + 0.01 lb_loss + 1e-3 z_loss."""
    x, ids, proj, params = moe_inputs(cfg)
    n_data, row = mesh.size(0), mesh.get_coordinate()[0]
    rows = slice(row * x.shape[0] // n_data, (row + 1) * x.shape[0] // n_data)
    leaves = [params[k] for k in ("router", "w_gate", "w_up", "w_down")]
    leaves += [params["shared"][k] for k in ("w_gate", "w_up", "w_down")]
    for t in leaves:
        t.requires_grad_(True)
    xl = torch.from_numpy(x[rows]).requires_grad_(True)
    with use_sharding_ctx(mesh) as ctx:
        y, aux = moe(params, xl, cfg, token_ids=torch.from_numpy(ids[rows]),
                     capacity_factor=capacity(cfg, cf))
        loss = dp_sum(torch.sum(y * torch.from_numpy(proj[rows]))) + \
            0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
        grads = torch.autograd.grad(loss, [xl] + leaves)
        out = [y.detach(), grads[0]]
        gathered = []
        for t in out:
            parts = [torch.empty_like(t) for _ in range(n_data)]
            dist.all_gather(parts, t.contiguous(), group=ctx.dp_group())
            gathered.append(torch.cat(parts).numpy())
        wgrads = []
        n_model, col = mesh.size(1), mesh.get_coordinate()[1]
        for i, g in enumerate(grads[1:]):
            g = g.clone()
            dist.all_reduce(g, group=ctx.dp_group())
            if 1 <= i <= 3 and n_model > 1:
                # a routed expert's gradient lives on its model rank only:
                # gather the ranks' own blocks, as the trainer's slices
                parts = [torch.empty_like(b) for b in g.chunk(n_model)]
                dist.all_gather(parts, g.chunk(n_model)[col].contiguous(),
                                group=ctx.group("model"))
                g = torch.cat(parts)
            wgrads.append(g.numpy())
    return dict(y=gathered[0], x_grad=gathered[1], weight_grads=wgrads,
                lb_loss=float(aux["lb_loss"]), z_loss=float(aux["z_loss"]),
                dropped=float(aux["dropped"]),
                telemetry=aux["telemetry"].numpy())


def resume_case(mesh, tmp: str) -> dict:
    """SmolLM's trainer over the mesh: 6 steps straight, and 3 steps then a
    resume to 6 from the checkpoint; both runs' losses."""
    straight = train(**RESUME, steps=6, ckpt_dir=os.path.join(tmp, "a"),
                     device="cpu", mesh=mesh)
    first = train(**RESUME, steps=RESUME_SPLIT,
                  ckpt_dir=os.path.join(tmp, "b"), device="cpu", mesh=mesh)
    resumed = train(**RESUME, steps=6, resume=True,
                    ckpt_dir=os.path.join(tmp, "b"), device="cpu", mesh=mesh)
    return dict(straight=straight, first=first, resumed=resumed)


def run(world: int, tmp: str) -> dict:
    """Every case of this world's meshes; rank 0's results by mesh."""
    out = {}
    for shape in MESHES[world]:
        mesh = make_smoke_mesh(*shape, device_type="cpu")
        res = {"smollm": sharded_steps(configs.get(SMOL, reduced=True), mesh,
                                       SMOL_MICROBATCHES, seed=1),
               "kimi": sharded_steps(kimi_config(), mesh, 1, seed=2)}
        for cf in MOE_CFS:
            res[("moe", cf)] = moe_case(configs.get(KIMI, reduced=True),
                                        mesh, cf)
        res["resume"] = resume_case(mesh, os.path.join(
            tmp, f"{shape[0]}x{shape[1]}"))
        out[shape] = res
    return out
