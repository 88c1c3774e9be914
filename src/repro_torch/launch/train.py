"""The trainer: train loop + LSketch router telemetry + checkpoints
(counterpart of ``repro.launch.train``), on one device or over a
``("data", "model")`` mesh of ranks.

Wiring per step, with the reference's cadence:
  1. a ``TokenPipeline`` batch (host, prefetched);
  2. the train step (forward, backward, AdamW; ``make_train_step``);
  3. every ``controller_every`` steps, the MoE telemetry count matrix
     summed since the last read goes to ``RouterTelemetry.ingest`` and
     ``CapacityController.update`` moves the capacity factor (logged; as
     in the reference, the step does not read it back);
  4. ``CheckpointManager.save`` (async) every ``ckpt_every`` steps and a
     blocking save at the end: the train state under its dotted leaf
     names (``step_fns.state_leaves``) and the pipeline cursor, so
     ``resume`` continues exactly. A checkpoint's step is the number of
     steps done (the reference labels its periodic saves one lower, so
     that a resume from one repeats a step), and a save still in flight
     commits before ``train`` returns or raises. The pipeline is built
     after the restore, as its worker captures its cursor when it
     starts.

Crash-only training wraps ``train(resume=True, ...)`` in
``distributed.fault_tolerance.RestartLoop`` (its docstring); a resize of
the mesh is ``distributed.elastic.remesh``.

Runs on the card unless the caller passes ``device="cpu"`` (CLI
``--device cpu``); the telemetry sketch lives on the same device.

With ``mesh=`` (a ``DeviceMesh`` over every rank of this process's group;
CLI ``--mesh DATA[xMODEL]`` spawns the ranks through
``distributed.ranks.spawn_ranks``: NCCL, one card a rank, or gloo on the
CPU) the state rests sharded and the step is ``make_sharded_train_step``
under the mesh's sharding context: with several model ranks it splits the
compute over "model" (``split_summary`` is the start line that says how
each layer splits). Every rank draws the same state from
the seed and reads the same pipeline; each data rank takes its rows of
the global batch (``local_rows``). Rank 0 alone logs, keeps the router
telemetry and writes the checkpoints (full leaves, gathered by every
rank); a resume under the same mesh reads them on every rank and
re-shards them.

Usage: python -m repro_torch.launch.train --arch smollm-135m --steps 200
       python -m repro_torch.launch.train --mesh 2x2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch.core.types import resolve_device
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.launch.mesh import make_smoke_mesh, mesh_size
from repro_torch.models import lm
from repro_torch.models.attention import attn_mode
from repro_torch.models.layers import mlp_split, vocab_split
from repro_torch.launch.step_fns import (full_state_leaves, init_train_state,
                                         load_state_leaves, local_rows,
                                         make_sharded_train_step,
                                         make_train_step, shard_state,
                                         state_leaves)
from repro_torch.optim import AdamWConfig
from repro_torch.telemetry import CapacityController, RouterTelemetry


def split_summary(cfg, tp: int, seq_len: int) -> str:
    """How the step splits each layer over ``tp`` model ranks at
    ``seq_len``: the attention layers by heads, by query rows ("sp") or
    whole, the recurrent mixers whole, the MLPs and the vocabulary."""
    dec, enc = lm.plans(cfg)
    plans = dec.layers + (enc.layers if enc else [])
    L = seq_len + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    attn = {"heads": 0, "sp": 0, "none": 0}
    for p in plans:
        if p.kind == "attn":
            attn[attn_mode(cfg.n_heads, L, tp)] += 1
    mixers = sum(p.kind != "attn" for p in plans)
    dense = sum(p.mlp == "dense" for p in plans)
    moe = sum(p.mlp == "moe" for p in plans)
    parts = [f"attention by heads {attn['heads']}, by rows (sp) "
             f"{attn['sp']}, whole {attn['none']}"]
    if mixers:
        parts.append(f"recurrent mixers whole {mixers}")
    if dense:
        parts.append(f"MLPs {'split' if mlp_split(cfg.d_ff, tp) else 'whole'}"
                     f" {dense}")
    if moe:
        parts.append(f"MoE experts "
                     f"{'by rank' if cfg.n_experts % tp == 0 else 'whole'} "
                     f"{moe}")
    parts.append(f"vocabulary {'split' if vocab_split(cfg, tp) else 'whole'}")
    return f"tensor parallel over {tp} model ranks: " + "; ".join(parts)


def train(arch: str = "smollm-135m", steps: int = 100, smoke: bool = True,
          batch_size: int = 8, seq_len: int = 128, ckpt_dir: str | None = None,
          ckpt_every: int = 50, controller_every: int = 10,
          microbatches: int = 1, resume: bool = False, log_every: int = 10,
          seed: int = 0, cfg=None, lr_peak: float = 3e-4,
          schedule_steps: int | None = None, device=None, stats=None,
          mesh=None):
    """Train ``steps`` steps (from a checkpoint's step with ``resume``);
    returns the per-step losses. ``stats``, a dict when given, receives
    the capacity factors after each controller update (``"cf"``), each
    step's metrics as floats (``"metrics"``) and seconds (``"step_s"``:
    batch to loss, synchronised by reading the loss), the telemetry
    handle (``"telemetry"``) and the final train state (``"state"``).
    ``mesh``: a ``DeviceMesh`` over every rank of the group (the module
    docstring)."""
    dev = resolve_device(device)
    if mesh is not None and mesh_size(mesh) != dist.get_world_size():
        raise ValueError(f"the mesh has {mesh_size(mesh)} ranks, the group "
                         f"{dist.get_world_size()}")
    lead = mesh is None or dist.get_rank() == 0
    cfg = cfg if cfg is not None else configs.get(arch, reduced=smoke)
    arch = cfg.name
    horizon = schedule_steps or steps  # fixed horizon => exact resume
    opt_cfg = AdamWConfig(lr_peak=lr_peak,
                          warmup_steps=max(2, horizon // 20),
                          decay_steps=horizon)
    pipe_cfg = TokenPipelineConfig(
        vocab_size=cfg.vocab_size, batch_size=batch_size, seq_len=seq_len,
        seed=seed)
    ckpt = CheckpointManager(ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"repro_torch_ckpt_{arch}"), keep=2)

    tele = RouterTelemetry(n_experts=max(cfg.n_experts, 1), device=dev) \
        if cfg.n_experts and lead else None
    controller = CapacityController(tele) if tele else None
    capacity_factor = cfg.capacity_factor
    if stats is not None:
        stats.update(cf=[], metrics=[], step_s=[], telemetry=tele)

    # drawn on the CPU: one seed gives the same weights on every device
    state = init_train_state(cfg, opt_cfg,
                             torch.Generator().manual_seed(seed), dev)
    if mesh is None:
        step_fn = make_train_step(cfg, opt_cfg, microbatches)
        leaves_of = state_leaves
    else:
        step_fn = make_sharded_train_step(cfg, opt_cfg, mesh, microbatches)
        leaves_of = full_state_leaves
        n_data = mesh.size(0)
        row = mesh.get_coordinate()[0]
        if lead and mesh.size(1) > 1:
            print(f"[train] {cfg.name} on a {n_data} x {mesh.size(1)} mesh, "
                  f"{split_summary(cfg, mesh.size(1), seq_len)}")

    start = 0
    cursor = 0
    if resume and ckpt.latest_step() is not None:
        arrays, extra = ckpt.restore(list(state_leaves(state)))
        state = load_state_leaves(state, arrays)
        start = extra["step"]
        cursor = extra["cursor"]
        if lead:
            print(f"[train] resumed at step {start}")
    if mesh is not None:  # the full leaves go once the shards are cut
        state = shard_state(cfg, opt_cfg, state, mesh)

    def save(step, blocking):
        leaves = leaves_of(state)
        if lead:
            ckpt.save(step, leaves, extra={"step": step,
                                           "cursor": pipe.cursor},
                      blocking=blocking)
    # the pipeline worker captures its cursor at thread start — it must
    # be constructed *after* restore for exact resume
    pipe = TokenPipeline(pipe_cfg, cursor=cursor)

    losses = []
    prev_tele = state.telemetry.cpu().numpy()
    try:
        for step in range(start, steps):
            t0 = time.time()
            batch = next(pipe)
            tbatch = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
                dev) for k in ("tokens", "labels")}
            if mesh is not None:
                tbatch = local_rows(tbatch, microbatches, n_data, row)
            state, metrics = step_fn(state, tbatch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if stats is not None:
                stats["step_s"].append(time.time() - t0)
                stats["metrics"].append({k: float(v)
                                         for k, v in metrics.items()})

            if tele is not None and step % controller_every == 0:
                cur = state.telemetry.cpu().numpy()
                tele.ingest(cur - prev_tele, step)
                prev_tele = cur
                capacity_factor = controller.update(capacity_factor)
                if stats is not None:
                    stats["cf"].append(capacity_factor)

            if ckpt_every and step and step % ckpt_every == 0:
                # labelled by the steps done, as the final save: a resume
                # from it continues with the next step, not this one again
                save(step + 1, blocking=False)
            if step % log_every == 0 and lead:
                dt = time.time() - t0
                extra = ""
                if tele is not None:
                    extra = (f" imb={tele.imbalance(last=2):.2f}"
                             f" cf={capacity_factor:.2f}")
                print(f"[train] step={step} loss={loss:.4f} "
                      f"dt={dt*1e3:.0f}ms{extra}")
        save(steps, blocking=True)
        if mesh is not None:  # no rank resumes before the commit
            dist.barrier()
        if stats is not None:
            stats["state"] = state
    except BaseException as fault:
        try:  # drain: a save in flight commits before the fault leaves
            ckpt.wait()
        except BaseException as drain:  # the fault, not the drain's, leaves
            fault.add_note(f"the checkpoint drain failed too: {drain!r}")
        raise
    finally:
        pipe.close()
    return losses


def parse_mesh(text: str) -> tuple:
    """``"DATA[xMODEL]"`` as ``(data, model)``."""
    parts = text.lower().split("x")
    if len(parts) > 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"--mesh {text!r}: expected DATA or DATAxMODEL")
    return int(parts[0]), int(parts[1]) if len(parts) == 2 else 1


def _train_rank(data: int, model: int, device_type: str, kw: dict):
    """One rank of ``--mesh``: its mesh over the whole group, then
    ``train``; returns the losses."""
    mesh = make_smoke_mesh(data, model, device_type)
    return train(**kw, mesh=mesh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh", default=None, metavar="DATA[xMODEL]",
                    help="train over DATA x MODEL ranks (spawned; NCCL "
                    "one card a rank, or gloo with --device cpu)")
    args = ap.parse_args(argv)
    kw = dict(arch=args.arch, steps=args.steps, smoke=args.smoke,
              batch_size=args.batch_size, seq_len=args.seq_len,
              microbatches=args.microbatches, resume=args.resume,
              ckpt_dir=args.ckpt_dir)
    dev = resolve_device(args.device)
    if args.mesh is None:
        losses = train(**kw, device=dev)
    else:
        data, model = parse_mesh(args.mesh)
        world = data * model
        if dev.type == "cuda" and world > torch.cuda.device_count():
            raise SystemExit(f"--mesh {args.mesh}: only "
                             f"{torch.cuda.device_count()} devices available")
        losses = spawn_ranks(_train_rank, world, device=dev, args=(
            data, model, dev.type, dict(kw, device=dev.type)))
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
