"""train_step / prefill_step / serve_step factories (counterpart of
``repro.launch.step_fns``), on one device and over a mesh.

``make_train_step`` returns f(train_state, batch) -> (train_state,
metrics): forward, backward (autograd; every global GQA layer's
attention through the flash kernel's backward on the card) and AdamW,
with optional microbatch gradient accumulation in f32. The reference's
int8 compressed all-reduce (``optim.compressed_psum``) is not called by
the step, as in the reference.

Over a ``("data", "model")`` ``DeviceMesh`` (``shard_state``,
``make_sharded_train_step``) the train state rests on each rank as the
shards its placements name (``train_state_specs`` through
``launch.shardings``: FSDP over "data", TP over "model"): parameters and
AdamW's moments as ``DTensor``s, the step counters and the telemetry
replicated. The step runs the forward and backward on plain tensors under
the mesh's sharding context (this rank's rows of the batch; the loss and
the MoE's global quantities through ``dp_sum``, so every rank computes
the global loss and its gradient share) and updates the shards. The
global gradient norm counts each element once. ``fully_shard`` (FSDP2) is
not used: it gathers in hooks on a module's ``forward``, and a
``ParamTree`` is never called.

With one model rank the step gathers every parameter whole
(``full_tensor``), sums the gradients over the data ranks and keeps each
leaf's slice. With several it splits the compute over "model" as the
reference's layout does (Megatron's tensor parallelism; the model
modules' ``*_tp_uses`` and ``distributed.sharding_ctx``): it hands each
layer its parameters as the layer opens (``_LayerGathers``): a split
leaf's model shard gathered over "data" alone, any other leaf whole; a
layer's gathered copies are freed when its forward ends and gathered
again for its backward (``torch.autograd.graph.saved_tensors_hooks``), so
at most about two layers' copies are live at a time. Each leaf's gradient
reaches its resting shard inside the backward: summed over "data" (and
over "model" first for a "partial" leaf, whose ranks each computed a
part: the "sp" fallback's whole weights, per-head norms, a KV head shared
by several ranks' query heads), then sliced. A leaf computed the same on
every model rank (the recurrent mixers, norms, router) is sliced with no
sum over "model".

Serving over a mesh (``shard_params``, ``shard_caches``,
``make_sharded_prefill_step``, ``make_sharded_serve_step``), forward
only: the parameters rest as the reference's serving cells place them
(FSDP over "data", TP over "model"), the caches as its cache rules do;
each layer opens through the same parameter source as the split train
step (gathered over "data", split over "model" as the models' ``*_tp_uses``
ask) and the logits are gathered over the vocabulary before any argmax.
Where the batch does not divide the data ranks, the caches' sequence
axis splits over "data" (context parallelism) and every data rank
decodes the same rows.

A train state's trees are flat dicts keyed by the parameters' dotted
names (``dict(params.named_parameters())``, e.g. ``layers.3.attn.wq``);
``state_leaves``/``load_state_leaves`` flatten a state to the checkpoint's
``{key: tensor}`` and back. ``from_jax_train_state`` carries the JAX
package's train state across (the tests step both packages from one
state).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding_ctx import (local_slice,
                                                  use_sharding_ctx)
from repro_torch.launch import shardings
from repro_torch.launch.mesh import axis_names, mesh_axes
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import whole_vocab
from repro_torch.models.moe import TELEMETRY_BUCKETS
from repro_torch.models.transformer import layer_cache_spec
from repro_torch.optim import (AdamWConfig, apply_updates, init_opt_state,
                               opt_state_specs)


class TrainState(NamedTuple):
    params: Any  # lm.LMParams, trainable
    opt: Any  # {"mu": {name: tensor}, "nu": {...}, "step": int32 scalar}
    telemetry: Any  # summed MoE routing count matrix (token-bucket x expert)
    step: torch.Tensor


def _zero_state(cfg: ModelConfig, opt_cfg: AdamWConfig, params) -> TrainState:
    params.requires_grad_(True)
    dev = params.device
    opt = init_opt_state(opt_cfg, dict(params.named_parameters()))
    tele = torch.zeros((TELEMETRY_BUCKETS, max(cfg.n_experts, 1)),
                       dtype=torch.int32, device=dev)
    return TrainState(params=params, opt=opt, telemetry=tele,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     generator: torch.Generator | None = None,
                     device=None) -> TrainState:
    """Parameters drawn by ``lm.init_params`` from ``generator`` on the
    generator's own device (``device`` when None), moved to ``device``
    (the card unless the caller names the CPU) and made trainable; zero
    moments, zero telemetry, step 0. A CPU generator gives the same
    weights whatever ``device`` is."""
    dev = resolve_device(device)
    params = lm.init_params(cfg, generator, dev if generator is None
                            else generator.device)
    return _zero_state(cfg, opt_cfg, params.to(dev))


def train_state_specs(cfg: ModelConfig, opt_cfg: AdamWConfig,
                      fsdp_axes=("data",), tp_axis="model") -> TrainState:
    """The train state's specs: parameters and AdamW's moments by
    ``lm.param_specs``, the step counters and telemetry replicated."""
    pspecs = lm.param_specs(cfg, fsdp_axes, tp_axis)
    return TrainState(params=pspecs, opt=opt_state_specs(pspecs),
                      telemetry=(), step=())


def state_leaves(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state as the checkpoint's ordered ``{key: tensor}``."""
    out = {f"params.{k}": p for k, p in state.params.named_parameters()}
    out.update({f"opt.mu.{k}": v for k, v in state.opt["mu"].items()})
    out.update({f"opt.nu.{k}": v for k, v in state.opt["nu"].items()})
    out["opt.step"] = state.opt["step"]
    out["telemetry"] = state.telemetry
    out["step"] = state.step
    return out


@torch.no_grad()
def load_state_leaves(state: TrainState, arrays) -> TrainState:
    """``state`` with every leaf overwritten, in ``state_leaves`` order, by
    ``arrays`` (numpy arrays as ``CheckpointManager.restore`` returns
    them); the tensors keep their devices and dtypes."""
    keys = list(state_leaves(state))
    if len(arrays) != len(keys):
        raise ValueError(f"{len(arrays)} arrays for {len(keys)} leaves")
    for (key, t), a in zip(state_leaves(state).items(), arrays):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {a.shape} != {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(a)))
    return state


def from_jax_train_state(cfg: ModelConfig, state_np,
                         device="cpu") -> TrainState:
    """The JAX package's ``TrainState`` (leaves as numpy arrays) as the
    port's: params, ``mu`` and ``nu`` through ``lm.from_jax_params``'s
    mapping (the moments in their own dtype, f32 or bf16), the step
    counters and the telemetry matrix as they are, on ``device``."""
    params = lm.from_jax_params(cfg, state_np.params).to(device)
    first = np.asarray(state_np.opt["mu"]["embed"]["tok"])
    moment_dtype = torch.bfloat16 if first.dtype.name == "bfloat16" \
        else torch.float32
    mcfg = cfg.replace(param_dtype=moment_dtype)

    def moments(tree):
        tree = _map_np(tree, lambda a: np.asarray(a, np.float32))
        return {k: v.detach().to(device) for k, v in
                lm.from_jax_params(mcfg, tree).named_parameters()}

    state = _zero_state(cfg, AdamWConfig(moment_dtype=moment_dtype), params)
    opt = {"mu": moments(state_np.opt["mu"]),
           "nu": moments(state_np.opt["nu"]),
           "step": torch.tensor(int(state_np.opt["step"]), dtype=torch.int32,
                                device=device)}
    return state._replace(
        opt=opt,
        telemetry=torch.from_numpy(np.array(state_np.telemetry,
                                            np.int32)).to(device),
        step=torch.tensor(int(state_np.step), dtype=torch.int32,
                          device=device))


def _map_np(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_np(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_np(v, fn) for v in tree]
    return fn(tree)


def _grads(cfg: ModelConfig, params, batch):
    """(loss, aux, {name: grad}) of ``lm.loss_fn``; a leaf the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives it."""
    names, leaves = zip(*params.named_parameters())
    loss, aux = lm.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, leaves, grads)}
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, grads


def _accumulate(cfg: ModelConfig, params, batch, microbatches: int):
    """(loss, aux, grads) of the batch: the mean over ``microbatches`` row
    blocks (gradients summed in f32, the loss their mean and aux the last
    block's, as the reference's scan)."""
    if microbatches == 1:
        return _grads(cfg, params, batch)
    B = next(iter(batch.values())).shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    mb = B // microbatches
    gsum, lsum = None, None
    for i in range(microbatches):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss_i, aux, g = _grads(cfg, params, part)
        if gsum is None:
            gsum = {k: v.float() for k, v in g.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=loss_i.device)
        else:
            for k, v in g.items():
                gsum[k] += v
        lsum = lsum + loss_i
        del g
    return lsum / microbatches, aux, \
        {k: v / microbatches for k, v in gsum.items()}


def _finish(cfg: ModelConfig, state: TrainState, opt, loss, aux, stats):
    """The next state (telemetry summed) and the step's metrics."""
    tele = state.telemetry
    metrics = {"loss": loss, **stats}
    if cfg.n_experts:
        tele = tele + aux["telemetry"]
        metrics["lb_loss"] = aux["lb_loss"]
        metrics["dropped"] = aux["dropped"]
    return TrainState(params=state.params, opt=opt, telemetry=tele,
                      step=state.step + 1), metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """f(state, batch) -> (state, metrics): the loss's gradient (the mean
    over ``microbatches`` row blocks of the batch), one AdamW step
    (parameters and moments updated in place), the MoE telemetry summed
    into ``state.telemetry``. Metrics: loss, lr, grad_norm (and lb_loss,
    dropped for a MoE config), 0-d tensors."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, aux, grads = _accumulate(cfg, state.params, batch,
                                       microbatches)
        _, opt, stats = apply_updates(
            opt_cfg, dict(state.params.named_parameters()), grads, state.opt)
        del grads
        return _finish(cfg, state, opt, loss, aux, stats)

    return train_step


# ---------------------------------------------------------------------------
# over a mesh
# ---------------------------------------------------------------------------

def state_placements(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     mesh) -> TrainState:
    """The train state's placements on ``mesh``: ``train_state_specs``
    through ``sanitize_specs`` and ``to_named``."""
    ax = mesh_axes(mesh)
    shapes = lm.param_shapes(cfg)
    scalar = ((), torch.int32)
    shape_tree = TrainState(
        params=shapes, opt={"mu": shapes, "nu": shapes, "step": scalar},
        telemetry=((TELEMETRY_BUCKETS, max(cfg.n_experts, 1)), torch.int32),
        step=scalar)
    specs = shardings.sanitize_specs(
        train_state_specs(cfg, opt_cfg, ax["fsdp"], ax["tp"]), shape_tree,
        mesh)
    return shardings.to_named(specs, mesh)


@torch.no_grad()
def shard_state(cfg: ModelConfig, opt_cfg: AdamWConfig, state: TrainState,
                mesh) -> TrainState:
    """A full train state (the same on every rank, e.g. drawn from one
    seed) resting on ``mesh``: each parameter and moment as a ``DTensor``
    holding this rank's slice of its placements (a copy: the full tensors
    can go); the step counters and telemetry as they are."""
    from torch.distributed.tensor import DTensor

    pl = state_placements(cfg, opt_cfg, mesh)
    params = lm.params_from_leaves(
        cfg, _shard_leaves(dict(state.params.named_parameters()), pl.params,
                           mesh))
    opt = {"mu": _shard_leaves(state.opt["mu"], pl.opt["mu"], mesh),
           "nu": _shard_leaves(state.opt["nu"], pl.opt["nu"], mesh),
           "step": state.opt["step"]}
    return TrainState(params=params, opt=opt, telemetry=state.telemetry,
                      step=state.step)


def _dtensor(t: torch.Tensor, placements, mesh):
    """``t`` (the full value, the same on every rank) as a ``DTensor``
    holding a copy of this rank's slice."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        local_slice(t.detach(), placements, mesh).clone(), mesh, placements,
        shape=t.shape, stride=t.stride())


def _shard_leaves(tree: dict, placements: dict, mesh) -> dict:
    return {k: _dtensor(t, placements[k], mesh) for k, t in tree.items()}


def full_state_leaves(state: TrainState) -> Dict[str, torch.Tensor]:
    """``state_leaves`` with every ``DTensor`` gathered to its full value
    (a collective: every rank of the mesh calls it)."""
    from torch.distributed.tensor import DTensor

    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in state_leaves(state).items()}


def local_rows(batch: Dict[str, torch.Tensor], microbatches: int,
               n_data: int, index: int) -> Dict[str, torch.Tensor]:
    """Data rank ``index``'s rows of a global batch: its block of each
    microbatch, in microbatch order, so that the step's microbatch i on
    every rank is the global microbatch i (as the reference splits a
    dp-sharded batch)."""
    B = next(iter(batch.values())).shape[0]
    if B % (microbatches * n_data):
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches over {n_data} data ranks")
    mb, r = B // microbatches, B // (microbatches * n_data)
    return {k: torch.cat([v[i * mb + index * r:i * mb + (index + 1) * r]
                          for i in range(microbatches)])
            for k, v in batch.items()}


def _norm_of_shards(grads: dict, placements: dict, mesh) -> torch.Tensor:
    """The global gradient norm from this rank's gradient shards: a leaf's
    square sum counts only on the ranks at coordinate 0 of each mesh
    dimension that replicates it, then the sum over every rank."""
    from torch.distributed.tensor import Replicate

    coord = mesh.get_coordinate()
    total = None
    for k, g in grads.items():
        if any(isinstance(p, Replicate) and c
               for p, c in zip(placements[k], coord)):
            continue
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=next(iter(grads.values())).device)
    if dist.get_world_size() > 1:
        dist.all_reduce(total)
    return torch.sqrt(total)


class _DTensorLeaves:
    """How the sharded step reads a leaf of its state: a ``DTensor``'s
    gather to the full value, its local shard and its placements."""

    @staticmethod
    def full(name: str, leaf):
        return leaf.full_tensor()

    @staticmethod
    def local(leaf):
        return leaf.to_local()

    @staticmethod
    def placements(name: str, leaf):
        return leaf.placements


class _LeafPlan:
    """How the tensor-parallel step hands one leaf to its layer: the mesh
    axes to gather its shard over (``(group, size, coordinate, dim)``,
    mesh order) and the groups to sum its gradient over."""

    def __init__(self, placements, use: str, ctx, mesh):
        from torch.distributed.tensor import Shard

        names = axis_names(mesh)
        coord = mesh.get_coordinate()
        self.gather = []
        model_split = False
        for i, p in enumerate(placements):
            if not isinstance(p, Shard) or mesh.size(i) == 1:
                continue
            if names[i] == "model" and use == "split":
                model_split = True
                continue
            self.gather.append((ctx.group(names[i]), mesh.size(i), coord[i],
                                p.dim))
        if use == "split" and not model_split:
            raise ValueError("a split leaf must rest sharded over 'model'")
        self.sums = []
        if use == "partial":
            self.sums.append(ctx.model_group())
        if ctx.dp_size > 1:
            self.sums.append(ctx.dp_group())

    @property
    def moves(self) -> bool:
        return bool(self.gather or self.sums)

    def gather_shard(self, shard):
        """The shard whole over ``gather``'s axes (the minor axis first)."""
        t = shard
        for group, n, _, dim in reversed(self.gather):
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=group)
            t = torch.cat(parts, dim)
        return t

    def reduce(self, g):
        """The gradient of the gathered copy to the shard's: summed over
        ``sums``, then this rank's slice (a copy: the whole goes)."""
        if self.sums:
            g = g.contiguous().clone()  # all_reduce writes in place
            for group in self.sums:
                dist.all_reduce(g, group=group)
        for _, n, index, dim in self.gather:
            g = g.chunk(n, dim)[index]
        return g.clone(memory_format=torch.contiguous_format) \
            if self.gather else g


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, plan):
        ctx.plan = plan
        return plan.gather_shard(shard) if plan.gather else \
            shard.view_as(shard)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.reduce(g), None


class _Regather(NamedTuple):
    shard: torch.Tensor
    plan: _LeafPlan
    size: tuple
    stride: tuple
    offset: int


class _LayerGathers:
    """The tensor-parallel step's parameter source (``ctx.params_source``):
    ``open`` hands a layer its leaves as ``uses`` asks and drops them when
    the layer's forward ends; a tensor the backward saves from a layer's
    gathered copy is kept as a note and gathered again when the backward
    reads it."""

    def __init__(self, ctx, mesh, params, placements: dict):
        self.ctx, self.mesh = ctx, mesh
        self.name = {id(p): k for k, p in params.named_parameters()}
        self.placements = placements
        self.plans: dict = {}
        self.live: dict = {}  # storage of an open layer's copy -> (shard, plan)

    def plan(self, name: str, use: str) -> _LeafPlan:
        key = (name, use)
        if key not in self.plans:
            self.plans[key] = _LeafPlan(self.placements[name], use,
                                        self.ctx, self.mesh)
        return self.plans[key]

    @contextlib.contextmanager
    def open(self, tree, uses: dict, keys=None):
        opened, mine = {}, []
        for rel, shard in tree.named_parameters():
            if keys is not None and rel.split(".", 1)[0] not in keys:
                continue
            plan = self.plan(self.name[id(shard)], uses.get(rel, "full"))
            t = _GatherLeaf.apply(shard, plan) if plan.moves else shard
            if plan.gather:
                key = t.untyped_storage()._cdata
                self.live[key] = (shard, plan)
                mine.append(key)
            *path, last = rel.split(".")
            node = opened
            for p in path:
                node = node.setdefault(p, {})
            node[last] = t
        try:
            yield opened
        finally:
            for key in mine:
                self.live.pop(key, None)
            opened.clear()

    def pack(self, t):
        hit = self.live.get(t.untyped_storage()._cdata)
        if hit is None:
            return t
        return _Regather(hit[0], hit[1], tuple(t.size()), tuple(t.stride()),
                         t.storage_offset())

    def unpack(self, obj):
        if not isinstance(obj, _Regather):
            return obj
        with torch.no_grad():
            full = obj.plan.gather_shard(obj.shard)
        return full.as_strided(obj.size, obj.stride, obj.offset)

    @contextlib.contextmanager
    def installed(self):
        self.ctx.params_source = self
        try:
            with torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                          self.unpack):
                yield
        finally:
            self.ctx.params_source = None
            self.live.clear()


def _split_grads(cfg, mesh, ctx, microbatches, leaves, gathers, state,
                 batch):
    """(loss, aux, {name: gradient of this rank's shard}, placements) of
    the tensor-parallel step (the module docstring)."""
    shards = dict(state.params.named_parameters())
    placements = {k: leaves.placements(k, p) for k, p in shards.items()}
    params = lm.params_from_leaves(
        cfg, {k: leaves.local(p).detach() for k, p in shards.items()}
    ).requires_grad_(True)
    source = gathers(ctx, mesh, params, placements)
    with source.installed():
        loss, aux, grads = _accumulate(cfg, params, batch, microbatches)
    return loss, aux, grads, placements


def sharded_grads(cfg: ModelConfig, state: TrainState, batch, mesh,
                  microbatches: int = 1):
    """(loss, aux, {name: gradient of this rank's shard}) of the sharded
    step over a mesh with several model ranks, without the update: what
    ``make_sharded_train_step`` hands AdamW (the tests and the card's
    check hold it to the one-device gradient)."""
    with use_sharding_ctx(mesh) as ctx:
        if ctx.tp_size == 1:
            raise ValueError("sharded_grads splits over 'model': the mesh "
                             "has one model rank")
        loss, aux, grads, _ = _split_grads(cfg, mesh, ctx, microbatches,
                                           _DTensorLeaves, _LayerGathers,
                                           state, batch)
    return loss, aux, grads


def _split_step(cfg, opt_cfg, mesh, ctx, microbatches, leaves, gathers,
                state, batch):
    """The step over several model ranks (the module docstring)."""
    shards = dict(state.params.named_parameters())
    loss, aux, grads, placements = _split_grads(cfg, mesh, ctx, microbatches,
                                                leaves, gathers, state, batch)
    gnorm = _norm_of_shards(grads, placements, mesh)
    with torch.no_grad():
        _, opt, stats = apply_updates(
            opt_cfg, {k: leaves.local(p) for k, p in shards.items()}, grads,
            {"mu": {k: leaves.local(v) for k, v in state.opt["mu"].items()},
             "nu": {k: leaves.local(v) for k, v in state.opt["nu"].items()},
             "step": state.opt["step"]}, grad_norm=gnorm)
    del grads
    opt = dict(state.opt, step=opt["step"])
    return _finish(cfg, state, opt, loss, aux, stats)


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                            microbatches: int = 1, _leaves=_DTensorLeaves,
                            _gathers=_LayerGathers):
    """f(state, batch) -> (state, metrics) over ``mesh`` (a ``DeviceMesh``
    over every rank of the group): ``state`` from ``shard_state``,
    ``batch`` this rank's rows (``local_rows``). The metrics are the
    global ones, the same on every rank. ``_leaves`` (the state's reader)
    and ``_gathers`` (the split step's parameter source) are seams for the
    cell estimator alone (``launch.dryrun`` passes meta shards and a
    source that notes what it gathers and saves); every other caller
    leaves them as they are."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with use_sharding_ctx(mesh) as ctx:
            if ctx.tp_size > 1:
                return _split_step(cfg, opt_cfg, mesh, ctx, microbatches,
                                   _leaves, _gathers, state, batch)
            shards = dict(state.params.named_parameters())
            with torch.no_grad():
                full = {k: _leaves.full(k, p) for k, p in shards.items()}
            params = lm.params_from_leaves(cfg, full).requires_grad_(True)
            del full
            loss, aux, grads = _accumulate(cfg, params, batch, microbatches)
            del params
            placements = {k: _leaves.placements(k, p)
                          for k, p in shards.items()}
            local = {}
            for k in shards:  # the data ranks' shares, then this shard
                g = grads.pop(k)
                if ctx.dp_size > 1:
                    dist.all_reduce(g, group=ctx.dp_group())
                local[k] = local_slice(g, placements[k], mesh)
            gnorm = _norm_of_shards(local, placements, mesh)
            with torch.no_grad():
                _, opt, stats = apply_updates(
                    opt_cfg, {k: _leaves.local(p) for k, p in shards.items()},
                    local, {"mu": {k: _leaves.local(v)
                                   for k, v in state.opt["mu"].items()},
                            "nu": {k: _leaves.local(v)
                                   for k, v in state.opt["nu"].items()},
                            "step": state.opt["step"]}, grad_norm=gnorm)
            del local
            opt = dict(state.opt, step=opt["step"])
            return _finish(cfg, state, opt, loss, aux, stats)

    return train_step


# ---------------------------------------------------------------------------
# sharded serving over a mesh
# ---------------------------------------------------------------------------

def param_placements(cfg: ModelConfig, mesh) -> dict:
    """The parameters' placements on ``mesh``, as the reference's serving
    cells place them: ``lm.param_specs`` (FSDP over "data", TP over
    "model") through ``sanitize_specs`` and ``to_named``."""
    ax = mesh_axes(mesh)
    return shardings.to_named(shardings.sanitize_specs(
        lm.param_specs(cfg, ax["fsdp"], ax["tp"]), lm.param_shapes(cfg),
        mesh), mesh)


@torch.no_grad()
def shard_params(cfg: ModelConfig, params, mesh):
    """Full parameters (the same on every rank) resting on ``mesh``: an
    ``LMParams`` of ``DTensor``s, each a copy of this rank's slice of its
    placements (``param_placements``), as ``shard_state`` places a train
    state's."""
    return lm.params_from_leaves(
        cfg, _shard_leaves(dict(params.named_parameters()),
                           param_placements(cfg, mesh), mesh))


@torch.no_grad()
def init_sharded_params(cfg: ModelConfig, mesh, generator=None):
    """``lm.init_params``' draw from ``generator`` (the same stream, leaf by
    leaf, on the generator's device; seeded 0 on this rank's device of the
    mesh when not given), keeping only this rank's shard of each leaf:
    ``shard_params`` of the drawn tree, with one whole leaf at a time on
    the rank."""
    from repro_torch.models.params import init_one

    if generator is None:
        generator = torch.Generator(device=_mesh_device(mesh)).manual_seed(0)
    placements = param_placements(cfg, mesh)
    leaves = {}
    for name, d in lm.draw_order(cfg):
        leaves[name] = _dtensor(init_one(d, generator, cfg.param_dtype,
                                         generator.device),
                                placements[name], mesh)
    return lm.params_from_leaves(cfg, leaves)


def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> list:
    """The decoder's per-layer caches as ``(shape, dtype)`` stand-ins."""
    dec, _ = lm.plans(cfg)
    return [layer_cache_spec(cfg, p, batch, seq) for p in dec.layers]


@torch.no_grad()
def shard_caches(cfg: ModelConfig, caches, mesh) -> list:
    """Per-layer caches resting on ``mesh`` as ``shardings.cache_shardings``
    places them (batch over "data" where it divides, else the sequence
    axis: context parallelism; KV heads, Mamba's and sLSTM's channels and
    mLSTM's heads over "model" where they divide). A leaf given as a
    tensor (the same on every rank, e.g. seeded) becomes a ``DTensor`` of
    a copy of this rank's slice; one given as a ``(shape, dtype)``
    stand-in (``cache_specs``), a ``DTensor`` over a zeroed local shard
    on this rank's device of the mesh."""
    from torch.distributed.tensor import DTensor

    placements = shardings.cache_shardings(caches, mesh)

    def leaf(x, pl, device):
        if isinstance(x, torch.Tensor):
            return _dtensor(x, pl, mesh)
        shape, dtype = x
        local = local_slice(torch.empty(shape, dtype=dtype, device="meta"),
                            pl, mesh).shape
        return DTensor.from_local(
            torch.zeros(local, dtype=dtype, device=device), mesh, pl,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    device = _mesh_device(mesh)
    return [{"mixer": {k: leaf(x, pl["mixer"][k], device)
                       for k, x in c["mixer"].items()}}
            for c, pl in zip(caches, placements)]


def _mesh_device(mesh) -> torch.device:
    """This rank's device of a ``DeviceMesh`` (its current card for CUDA)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _cache_leaf(leaf) -> tuple:
    """(this rank's tensor, placements) of a resting cache leaf: a
    ``DTensor``'s, or the estimator's ``(meta shard, placements)`` pair."""
    if isinstance(leaf, tuple):
        return leaf
    return leaf.to_local(), leaf.placements


def _cache_view(cache: dict, mesh) -> dict:
    """A layer's resting cache as the decode reads it: each leaf's local
    shard (written in place), and ``{"seq": (n, r)}`` where its sequence
    axis is split n ways over "data" and this rank holds block r."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = {"mixer": {}}
    for name, leaf in cache["mixer"].items():
        t, pl = _cache_leaf(leaf)
        out["mixer"][name] = t
        seq_ax = shardings.cache_seq_axis(name)
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == seq_ax and mesh.size(i) > 1:
                out["seq"] = (mesh.size(i), coord[i])
    return out


@contextlib.contextmanager
def _serving(cfg: ModelConfig, mesh, params, leaves, gathers):
    """The sharded serving steps' setting: no graph, the mesh's sharding
    context and the split's parameter source over ``params``' local
    shards (each layer gathered over "data" as it opens, as the split
    train step gathers it, and freed when it closes); yields the tree of
    local shards."""
    with torch.no_grad(), use_sharding_ctx(mesh) as ctx:
        shards = dict(params.named_parameters())
        placements = {k: leaves.placements(k, p) for k, p in shards.items()}
        local = lm.params_from_leaves(
            cfg, {k: leaves.local(p) for k, p in shards.items()})
        with gathers(ctx, mesh, local, placements).installed():
            yield local


def make_sharded_prefill_step(cfg: ModelConfig, mesh, _leaves=_DTensorLeaves,
                              _gathers=_LayerGathers):
    """f(params, batch) -> logits over ``mesh``: ``params`` from
    ``shard_params``, ``batch`` this rank's rows (``local_rows``). The
    forward of the split train step without its graph (this rank's heads
    or blocks of query rows, MLP columns, experts, mixer channels,
    vocabulary block); returns the whole vocabulary's logits, the same on
    every rank of a model row. ``_leaves``/``_gathers``: the estimator's
    seams, as ``make_sharded_train_step``'s."""

    def prefill_step(params, batch):
        with _serving(cfg, mesh, params, _leaves, _gathers) as local:
            logits, _ = lm.forward(cfg, local, batch)
            return whole_vocab(logits, cfg)

    return prefill_step


def make_sharded_serve_step(cfg: ModelConfig, mesh, _leaves=_DTensorLeaves,
                            _gathers=_LayerGathers):
    """f(params, caches, tokens, memory=None) -> (logits, caches) over
    ``mesh``: ``params`` from ``shard_params``; ``caches`` from
    ``shard_caches`` (written in place); ``tokens`` ``[B, 1]`` and
    ``memory`` this rank's rows where the batch divides the data ranks,
    else the whole batch (then the caches' sequence axis is split over
    "data" where it divides: context parallelism). One decode step on
    this rank's rows, heads, channels and sequence block; the logits
    ``[B, 1, V]`` are the whole vocabulary's on every rank of a model
    row."""

    def serve_step(params, caches, tokens, memory=None):
        with _serving(cfg, mesh, params, _leaves, _gathers) as local:
            views = [_cache_view(c, mesh) for c in caches]
            logits, _ = lm.serve_step(cfg, local, views, tokens,
                                      memory=memory)
        return logits, caches

    return serve_step


def sharded_encode_memory(cfg: ModelConfig, mesh, params, frame_emb):
    """The encoder-decoder's memory of ``frame_emb`` (this rank's rows)
    under the split, ``params`` from ``shard_params``."""
    with _serving(cfg, mesh, params, _DTensorLeaves, _LayerGathers) as local:
        return lm.encode_memory(cfg, local, frame_emb)


def make_prefill_step(cfg: ModelConfig):
    """Forward-only full-sequence step (the prefill_32k cell)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = lm.forward(cfg, params, batch)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, caches, tokens, memory=None):
        return lm.serve_step(cfg, params, caches, tokens, memory=memory)

    return serve_step
