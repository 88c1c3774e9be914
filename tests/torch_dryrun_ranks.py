"""Rank bodies of ``tests/test_torch_dryrun.py``: one real sharded train
step a config and mesh on gloo ranks (two and four model ranks: the
tensor-parallel step), its state's local shard bytes and the bytes
of every collective it issued (no JAX here; the ranks import this module
by path)."""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.step_fns import (init_train_state,
                                         local_rows, make_sharded_train_step,
                                         shard_state)
from repro_torch.optim import AdamWConfig

ARCHS = ("smollm_135m", "kimi_k2_1t_a32b", "deepseek_v2_236b")
MESH = (2, 2)
SPLIT_MESH = (1, 4)  # every rank a model rank
B, S, MICROBATCHES = 4, 32, 2
OPT = AdamWConfig(lr_peak=1e-3, warmup_steps=2, decay_steps=10)


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(v) for v in x)
    return 0


class CommBytes(TorchDispatchMode):
    """The result bytes of every collective op dispatched while entered,
    by kind: the functional collectives ``DTensor`` issues and the
    ``c10d`` ops behind ``torch.distributed``'s calls."""

    KINDS = {"all_gather_into_tensor": "all-gather",
             "allgather_": "all-gather", "all_reduce": "all-reduce",
             "allreduce_": "all-reduce", "reduce_scatter_tensor":
             "reduce-scatter", "all_to_all_single": "all-to-all"}

    def __init__(self):
        super().__init__()
        self.bytes = defaultdict(int)
        self.ops = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns in ("c10d", "_c10d_functional") and name in self.KINDS:
            kind = self.KINDS[name]
            self.ops[f"{ns}.{name}"] += 1
            # result bytes: a c10d op's output operand (the list it fills
            # or the tensor it reduces in place), a functional op's return
            self.bytes[kind] += _bytes(args[0]) if ns == "c10d" \
                else _bytes(out)
        return out


def run() -> dict:
    """Rank 0's shard bytes and one step's collective bytes, by arch on
    MESH and by (SPLIT_MESH, arch)."""
    out = {}
    for shape in (MESH, SPLIT_MESH):
        mesh = make_smoke_mesh(*shape, device_type="cpu")
        for arch in ARCHS:
            key = arch if shape == MESH else (shape, arch)
            out[key] = _one_step(arch, shape, mesh)
    return out


def _one_step(arch, shape, mesh) -> dict:
    """Rank 0's shard bytes and one step's collective bytes."""
    cfg = configs.get(arch, reduced=True)
    state = shard_state(cfg, OPT, init_train_state(
        cfg, OPT, torch.Generator().manual_seed(0), "cpu"), mesh)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    batch = local_rows(batch, MICROBATCHES, shape[0],
                       mesh.get_coordinate()[0])
    step = make_sharded_train_step(cfg, OPT, mesh, MICROBATCHES)
    with CommBytes() as comm:
        state, _ = step(state, batch)
    local = [p.to_local() for p in state.params.parameters()]
    return dict(
        params=sum(_bytes(t) for t in local),
        moments=sum(_bytes(v.to_local()) for tree in (
            state.opt["mu"], state.opt["nu"]) for v in tree.values()),
        # the step's gradient shards: f32 sums over the microbatches
        grads=sum(t.numel() for t in local) * 4,
        collective=dict(comm.bytes), ops=dict(comm.ops))
