"""train_step / prefill_step / serve_step factories (counterpart of
``repro.launch.step_fns``), on one device.

``make_train_step`` returns f(train_state, batch) -> (train_state,
metrics): forward, backward (autograd; every global GQA layer's
attention through the flash kernel's backward on the card) and AdamW,
with optional microbatch gradient accumulation in f32. The reference's
int8 compressed all-reduce (``optim.compressed_psum``) is not called by
the step, as in the reference; its expert-parallel MoE waits for the
sharding work.

A train state's trees are flat dicts keyed by the parameters' dotted
names (``dict(params.named_parameters())``, e.g. ``layers.3.attn.wq``);
``state_leaves``/``load_state_leaves`` flatten a state to the checkpoint's
``{key: tensor}`` and back. ``from_jax_train_state`` carries the JAX
package's train state across (the tests step both packages from one
state).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import TELEMETRY_BUCKETS
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state


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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """f(state, batch) -> (state, metrics): the loss's gradient (the mean
    over ``microbatches`` row blocks of the batch, summed in f32, with the
    loss their mean and aux the last block's, as the reference's scan),
    one AdamW step (parameters and moments updated in place), the MoE
    telemetry summed into ``state.telemetry``. Metrics: loss, lr,
    grad_norm (and lb_loss, dropped for a MoE config), 0-d tensors."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if microbatches > 1:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            mb = B // microbatches
            gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                           device=state.step.device)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i, aux, g = _grads(cfg, state.params, part)
                if gsum is None:
                    gsum = {k: v.float() for k, v in g.items()}
                else:
                    for k, v in g.items():
                        gsum[k] += v
                lsum = lsum + loss_i
                del g
            grads = {k: v / microbatches for k, v in gsum.items()}
            loss = lsum / microbatches
        else:
            loss, aux, grads = _grads(cfg, state.params, batch)
        _, opt, stats = apply_updates(
            opt_cfg, dict(state.params.named_parameters()), grads, state.opt)
        del grads
        tele = state.telemetry
        if cfg.n_experts:
            tele = tele + aux["telemetry"]
        metrics = {"loss": loss, **stats}
        if cfg.n_experts:
            metrics["lb_loss"] = aux["lb_loss"]
            metrics["dropped"] = aux["dropped"]
        return TrainState(params=state.params, opt=opt, telemetry=tele,
                          step=state.step + 1), metrics

    return train_step


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
