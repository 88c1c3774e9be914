"""Rank bodies of ``tests/test_torch_tp_train.py``: the tensor-parallel
train step (``launch.step_fns.sharded_grads`` and
``make_sharded_train_step`` over a mesh with several model ranks), the
vocab-parallel embedding and cross entropy, and a resumed run, on gloo
ranks (no JAX here; the ranks import this module by path). The test
process draws every state with ``repro`` and hands it over as numpy
leaves."""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.distributed import sharding_ctx
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.step_fns import (_zero_state, full_state_leaves,
                                         local_rows, make_sharded_train_step,
                                         shard_state, sharded_grads)
from repro_torch.launch.train import train
from repro_torch.models import lm
from repro_torch.models.layers import embed, softmax_xent
from repro_torch.optim import AdamWConfig

from torch_serve_ranks import mixer_rows

B, S, FRAMES = 4, 32, 16
STEPS = 2
# eps = 1e-3: AdamW's update a smooth function of the gradient, so the
# split and single-device parameters agree to 1e-6 (test_torch_train)
OPT = AdamWConfig(lr_peak=1e-3, warmup_steps=2, decay_steps=10, eps=1e-3)
QWEN3, SMOL = "qwen3_8b", "smollm_135m"
# (arch, (data, model), microbatches): every arch once, Qwen3 on every mesh
CASES = {
    2: ((QWEN3, (1, 2), 1), (SMOL, (1, 2), 1), ("gemma3_4b", (1, 2), 1),
        ("qwen15_110b", (1, 2), 1), ("deepseek_v2_236b", (1, 2), 1),
        ("jamba_15_large_398b", (1, 2), 1), ("xlstm_13b", (1, 2), 1),
        ("seamless_m4t_medium", (1, 2), 1)),
    4: ((QWEN3, (2, 2), 2), (QWEN3, (1, 4), 1),
        ("kimi_k2_1t_a32b", (1, 4), 1)),
}
VOCABS = (256, 255)  # divides the two ranks, and does not
RESUME = dict(batch_size=4, seq_len=32, seed=0, lr_peak=1e-3, log_every=100,
              ckpt_every=0, schedule_steps=6)
RESUME_SPLIT = 3


def config(arch: str):
    cfg = configs.get(arch, reduced=True)
    if cfg.n_experts:  # drop-free: the per-shard capacity rule aside
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def batch(cfg, seed: int = 3) -> dict:
    """B x S tokens and labels (and the arch's prefix or frames), numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.frontend == "vision":
        out["prefix_emb"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frame_emb"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def state_of(cfg, leaves: dict):
    """A fresh train state on the CPU over the numpy ``leaves``."""
    params = lm.params_from_leaves(
        cfg, {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()})
    return _zero_state(cfg, OPT, params)


@contextlib.contextmanager
def flash_calls():
    """The flash wrapper's calls, noted as (q shape, k shape, q_offset)."""
    calls = []
    fwd = flash_ops.flash_attention_kernel

    def noted(q, k, v, causal=True, lse=False, q_offset=0):
        calls.append((tuple(q.shape), tuple(k.shape), q_offset))
        return fwd(q, k, v, causal, lse, q_offset)

    flash_ops.flash_attention_kernel = noted
    try:
        yield calls
    finally:
        flash_ops.flash_attention_kernel = fwd


def whole(grads: dict, placements: dict, mesh) -> dict:
    """Every rank's gradient shards joined (a collective)."""
    return {k: DTensor.from_local(g, mesh, placements[k]).full_tensor()
            .numpy() for k, g in grads.items()}


def split_case(arch, shape, microbatches, leaves) -> dict:
    """One step's loss and gradients by ``sharded_grads`` (joined over the
    ranks), the flash calls it made on each rank and rank 0's mixer calls,
    then STEPS train steps' metrics and parameters, all from the handed
    state."""
    cfg = config(arch)
    mesh = make_smoke_mesh(*shape, device_type="cpu")
    n_data, row = mesh.size(0), mesh.get_coordinate()[0]
    data = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    mine = local_rows(data, microbatches, n_data, row)
    state = shard_state(cfg, OPT, state_of(cfg, leaves), mesh)
    placements = {k: p.placements
                  for k, p in state.params.named_parameters()}
    with flash_calls() as calls, mixer_rows() as mixers:
        loss, aux, grads = sharded_grads(cfg, state, mine, mesh,
                                         microbatches)
    every = [None] * mesh.size()
    torch.distributed.all_gather_object(every, calls)
    out = dict(loss=float(loss), grads=whole(grads, placements, mesh),
               flash=every, telemetry=aux["telemetry"].numpy(),
               mixers=mixers)
    step = make_sharded_train_step(cfg, OPT, mesh, microbatches)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, local_rows(
            {k: torch.from_numpy(v) for k, v in batch(cfg, 10 + i).items()},
            microbatches, n_data, row))
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"] = metrics
    out["params"] = {k: v.numpy() for k, v in full_state_leaves(state).items()
                     if k.startswith("params.")}
    return out


class _Stub:
    """A parameter source that hands a tree as it is: the unit cases slice
    the shards themselves."""

    @contextlib.contextmanager
    def open(self, tree, uses, keys=None):
        yield tree


def vocab_case(vocab: int, table: np.ndarray, logits: np.ndarray,
               tokens: np.ndarray, labels: np.ndarray) -> dict:
    """The embedding of ``tokens`` and the cross entropy of ``logits``
    against ``labels`` with the vocabulary split over the two model ranks
    where it divides (this rank's rows of ``table``, its columns of
    ``logits``), else whole: outputs and gradients joined over the ranks."""
    cfg = configs.get(SMOL, reduced=True).replace(vocab_size=vocab)
    mesh = make_smoke_mesh(1, 2, device_type="cpu")
    rank, n = mesh.get_coordinate()[1], 2
    split = vocab % n == 0
    tab = torch.from_numpy(table)
    lg = torch.from_numpy(logits)
    if split:
        tab = tab.chunk(n, 0)[rank]
        lg = lg.chunk(n, -1)[rank]
    tab = tab.clone().requires_grad_(True)
    lg = lg.clone().requires_grad_(True)
    with sharding_ctx.use_sharding_ctx(mesh) as ctx:
        ctx.params_source = _Stub()
        start = rank * (vocab // n) if split else None
        x = embed({"tok": tab}, torch.from_numpy(tokens), cfg)
        loss = softmax_xent(lg, torch.from_numpy(labels), vocab_start=start)
        proj = torch.from_numpy(np.linspace(-1, 1, x.numel(), dtype=np.float32)
                                .reshape(x.shape))
        g_tab, g_lg = torch.autograd.grad(torch.sum(x * proj) + loss,
                                          [tab, lg])
        ctx.params_source = None

    def join(t, dim):
        if not split:
            return t.detach().numpy()
        return DTensor.from_local(t.detach().contiguous(), mesh, (
            torch.distributed.tensor.Replicate(),
            torch.distributed.tensor.Shard(dim))).full_tensor().numpy()

    return dict(x=x.detach().numpy(), loss=float(loss), g_tab=join(g_tab, 0),
                g_logits=join(g_lg, lg.dim() - 1))


def resume_case(tmp: str) -> dict:
    """Reduced Qwen3's trainer over (1, 2): 6 steps straight, and 3 steps
    then a resume to 6 from the checkpoint; both runs' losses."""
    mesh = make_smoke_mesh(1, 2, device_type="cpu")
    kw = dict(RESUME, cfg=config(QWEN3), device="cpu", mesh=mesh)
    straight = train(**kw, steps=6, ckpt_dir=os.path.join(tmp, "a"))
    train(**kw, steps=RESUME_SPLIT, ckpt_dir=os.path.join(tmp, "b"))
    resumed = train(**kw, steps=6, resume=True,
                    ckpt_dir=os.path.join(tmp, "b"))
    return dict(straight=straight, resumed=resumed)


def run(world: int, tmp: str, states: dict, vocab_inputs: dict) -> dict:
    """Every case of this world; rank 0's results."""
    torch.set_num_threads(1)
    out = {}
    for arch, shape, mb in CASES[world]:
        out[(arch, shape)] = split_case(arch, shape, mb, states[arch])
    if world == 2:
        for v in VOCABS:
            out[("vocab", v)] = vocab_case(v, *vocab_inputs[v])
        out["resume"] = resume_case(tmp)
    return out
