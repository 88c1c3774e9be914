"""Sketch checkpoints (port of ``repro.sketch.checkpoint``: ``save``,
``saved_spec``, ``saved_extra``, ``restore``) on the reference's format
(``distributed.checkpoint.CheckpointManager``): the spec rides in the
manifest's ``extra`` under ``sketch_spec``, the leaves under the
reference's key paths (``.shards/.key``, ... for lsketch and gss,
``.shards/.C``, ... for lgs). A checkpoint either package wrote restores
in the other.

``restore`` at the saved shard count returns the state on the requested
device. Restoring into another shard count re-partitions the saved
records (the reference's ``reshard``), which the port does not have yet
(ROADMAP item 7): it raises.
"""

from __future__ import annotations

from repro_torch.core.lgs import LGS_LEAVES
from repro_torch.core.types import LEAVES
from repro_torch.distributed.checkpoint import CheckpointManager

from .spec import SketchSpec
from .state import ShardedState, from_numpy

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
    ``sketch_spec`` key is reserved."""
    mgr = CheckpointManager(directory, keep=keep)
    meta = dict(extra) if extra else {}
    if MANIFEST_KEY in meta:
        raise ValueError(f"extra key {MANIFEST_KEY!r} is reserved")
    meta[MANIFEST_KEY] = spec.to_json()
    leaves = state.live().leaves() if isinstance(state, ShardedState) \
        else state.leaves()
    mgr.save(step, dict(zip(_keys(spec), leaves)), extra=meta,
             blocking=blocking)
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
            device=None) -> ShardedState:
    """The handle saved in ``directory`` for ``spec``, on ``device`` (the
    card unless the caller names the CPU). The saved spec must be
    compatible (same kind and config) and have ``spec.n_shards``
    shards."""
    mgr = CheckpointManager(directory)
    step = mgr.latest_step() if step is None else step
    saved = saved_spec(directory, step)
    if not spec.compatible(saved):
        raise ValueError(
            f"checkpoint holds an incompatible sketch: saved "
            f"{saved.kind}/{saved.config!r}, requested "
            f"{spec.kind}/{spec.config!r}")
    if saved.n_shards != spec.n_shards:
        raise NotImplementedError(
            f"the checkpoint has {saved.n_shards} shards and the spec "
            f"{spec.n_shards}: restoring across shard counts needs "
            f"reshard, which the port does not have yet (ROADMAP item 7)")
    arrays, _ = mgr.restore(_keys(saved), step=step)
    return from_numpy(spec, arrays, device)
