"""Sketch checkpoints (port of ``repro.sketch.checkpoint``: ``save``,
``saved_spec``, ``saved_extra``, ``restore``) on the reference's format
(``distributed.checkpoint.CheckpointManager``): the spec rides in the
manifest's ``extra`` under ``sketch_spec``, the leaves under the
reference's key paths (``.shards/.key``, ... for lsketch and gss,
``.shards/.C``, ... for lgs). A checkpoint either package wrote restores
in the other.

``restore`` returns the state on the requested device. Restoring into
another shard count re-partitions the saved contents by key space
(``reshard``) for ``lsketch`` and ``gss``; ``lgs`` (no keys) merges into
shard 0 when shrinking and appends empty shards when growing.

A mesh-resident handle saves its gathered stack (``fleet_shards``), written
by rank 0 alone, so the files are the same at every world size;
``restore(..., mesh=...)`` loads the stack and returns it ``place``d, so a
checkpoint saved at one world size restores at another.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.core.lgs import LGS_LEAVES
from repro_torch.core.types import LEAVES
from repro_torch.distributed.checkpoint import CheckpointManager

from .reshard import reshard
from .spec import SketchSpec
from .state import (ShardedState, _init, fleet_shards, from_numpy,
                    merge_all, mesh_context, place, stack_states,
                    unstack_state)

MANIFEST_KEY = "sketch_spec"


def _keys(spec: SketchSpec) -> list:
    names = LGS_LEAVES if spec.kind == "lgs" else LEAVES
    return [f".shards/.{n}" for n in names]


def save(spec: SketchSpec, state: ShardedState, directory, step: int = 0,
         keep: int = 3, blocking: bool = True,
         extra: dict | None = None) -> CheckpointManager:
    """Checkpoint a handle (atomic; written on a thread when
    ``blocking=False``, after the leaves are copied to host memory).
    ``extra`` entries ride in the manifest beside the spec; the
    ``sketch_spec`` key is reserved. Every rank of a mesh-resident
    handle's group calls it: the rows are gathered, rank 0 writes, and a
    blocking save returns on every rank once the files are committed."""
    mgr = CheckpointManager(directory, keep=keep)
    meta = dict(extra) if extra else {}
    if MANIFEST_KEY in meta:
        raise ValueError(f"extra key {MANIFEST_KEY!r} is reserved")
    meta[MANIFEST_KEY] = spec.to_json()
    ctx = mesh_context(state) if isinstance(state, ShardedState) else None
    if isinstance(state, ShardedState):
        state = fleet_shards(spec, state)
    if ctx is None or ctx.rank == 0:
        mgr.save(step, dict(zip(_keys(spec), state.leaves())), extra=meta,
                 blocking=blocking)
    if ctx is not None and blocking:
        dist.barrier(group=ctx.group)
    return mgr


def saved_spec(directory, step: int | None = None) -> SketchSpec:
    """The spec recorded in a sketch checkpoint's manifest."""
    meta = CheckpointManager(directory).manifest(step)
    return SketchSpec.from_json(meta["extra"][MANIFEST_KEY])


def saved_extra(directory, step: int | None = None) -> dict:
    """The caller's ``extra`` entries of a sketch checkpoint (the spec
    key stripped), e.g. the tenant id a ``TenantPool`` eviction wrote."""
    meta = dict(CheckpointManager(directory).manifest(step)["extra"])
    meta.pop(MANIFEST_KEY, None)
    return meta


def restore(spec: SketchSpec, directory, step: int | None = None,
            device=None, *, mesh=None, axis: str = "data") -> ShardedState:
    """The handle saved in ``directory`` for ``spec``, on ``device`` (the
    card unless the caller names the CPU). The saved spec must be
    compatible (same kind and config). A different ``n_shards`` reshards
    ``lsketch``/``gss`` under the requested spec's routing (else the
    saved one): vertex and label answers are conserved, edge answers stay
    one-sided. ``lgs`` shrinks by ``merge_all`` into shard 0 and grows by
    appending empty shards, both exact. With ``mesh`` (see ``place``) the
    handle comes back mesh-resident: this rank's block of the stack."""
    state = _restore(spec, directory, step, device)
    return state if mesh is None else place(spec, state, mesh, axis=axis)


def _restore(spec: SketchSpec, directory, step, device) -> ShardedState:
    mgr = CheckpointManager(directory)
    step = mgr.latest_step() if step is None else step
    saved = saved_spec(directory, step)
    if not spec.compatible(saved):
        raise ValueError(
            f"checkpoint holds an incompatible sketch: saved "
            f"{saved.kind}/{saved.config!r}, requested "
            f"{spec.kind}/{spec.config!r}")
    arrays, _ = mgr.restore(_keys(saved), step=step)
    state = from_numpy(saved, arrays, device)
    if saved.n_shards == spec.n_shards:
        return state
    if spec.kind != "lgs":
        routing = spec.routing if spec.routing is not None \
            else saved.routing
        return reshard(saved, state, spec.n_shards, routing=routing)
    base = _init(spec, (), state.device)
    if spec.n_shards > saved.n_shards:
        olds = [unstack_state(state, i) for i in range(saved.n_shards)]
        return stack_states(olds + [base] * (spec.n_shards - saved.n_shards))
    return stack_states([merge_all(saved, state)] +
                        [base] * (spec.n_shards - 1))
