"""ShardedState — the dynamic half of a sketch handle.

A ``ShardedState`` wraps one state (``LSketchState`` or ``LGSState``)
whose every leaf carries a leading ``[n_shards]`` axis. It is a handle
object: ingest updates the tensors in place and returns a *new* handle
over them, and marks the old
one spent (the port's counterpart of JAX buffer donation — a 4-shard
state at d=2048 is about 17 GiB and cannot be copied per flush). Any use
of a spent handle raises. Host-side caches (the query planes) hang off the
handle object, so a new handle starts cold and no stale planes survive an
ingest.

``from_numpy``/``to_numpy`` carry a state across the seam to the JAX
package: the arrays are the JAX state's leaves in ``jax.tree.leaves``
order, which is the field order of the state class — ``LSketchState``
(kinds lsketch and gss: key, C, P, pool_key, pool_C, pool_P, pool_lost,
slot_widx, cur_widx) or ``LGSState`` (C, P, slot_widx, cur_widx) — each
with the leading shard axis of a ``ShardedState``, or without it for a
plain single-shard state (``plain=True``; the objects' ``.state``).

``merge_all`` reduces a handle to one plain state and
``shards_compatible`` says when that is exact (``core.merge``).

``place`` makes a handle mesh-resident: rank ``r`` of a ``torch.distributed``
group of ``W`` keeps only its block of shard rows ``[r*S/W, (r+1)*S/W)``
(what ``P(axis)`` gives a device in the reference) and the handle carries
a ``MeshContext``. Every rank then runs the same program on the same
inputs, and every query answers the fleet on every rank
(``sketch/query.py``). When ``W`` does not divide the shard count the
stack is replicated instead: every rank holds and ingests every row.
``merge_all``, ``shards_compatible`` and ``to_numpy`` first gather a
split handle's rows (``fleet_shards``), so they answer as on the whole
stack.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import merge as _merge
from repro_torch.core.lgs import LGS_LEAVES, lgs_init_leaves
from repro_torch.core.types import LEAVES, init_leaves, \
    resolve_device

from .spec import SketchSpec


class ShardedState:
    """Per-shard sketch states stacked on a leading ``[n_shards]`` axis
    (an ``LSketchState`` for kinds lsketch and gss, an ``LGSState`` for
    lgs)."""

    def __init__(self, shards):
        self.shards = shards
        self.spent = False

    @classmethod
    def lift(cls, state) -> "ShardedState":
        """A 1-shard handle over ``[1, ...]`` views of a plain state's
        tensors (no copy: a contiguous tensor stays contiguous)."""
        return cls(state.map(lambda x: x.unsqueeze(0)))

    @property
    def device(self) -> torch.device:
        return self.shards.leaves()[0].device

    def live(self):
        """The shard stack, or raise if an ingest consumed this handle."""
        if self.spent:
            raise RuntimeError("this handle was consumed by ingest (its "
                               "tensors were updated in place); use the "
                               "handle ingest returned")
        return self.shards


def _init(spec: SketchSpec, lead, device):
    init = lgs_init_leaves if spec.kind == "lgs" else init_leaves
    return init(spec.config, lead, device)


def create(spec: SketchSpec, device=None) -> ShardedState:
    """Fresh all-empty state for every shard, allocated on ``device`` (the
    card unless the caller names the CPU)."""
    return ShardedState(_init(spec, (spec.n_shards,), resolve_device(device)))


def stack_states(states) -> ShardedState:
    """Wrap a list of plain per-shard states into a handle (copies)."""
    cls = type(states[0])
    return ShardedState(cls(*[
        torch.stack(xs) for xs in zip(*[s.leaves() for s in states])]))


def unstack_state(state: ShardedState, shard: int = 0):
    """Plain state of one shard (views of the handle's tensors)."""
    return state.live().map(lambda x: x[shard])


def from_numpy(spec: SketchSpec, arrays, device=None, *,
               plain: bool = False):
    """A handle over arrays given in ``jax.tree.leaves`` order of a JAX
    state (see the module docstring), checked against ``spec``. With
    ``plain=True`` the arrays are one plain state without the shard axis
    (a 1-shard spec) and the plain state is returned."""
    arrays = list(arrays)
    names = LGS_LEAVES if spec.kind == "lgs" else LEAVES
    if len(arrays) != len(names):
        raise ValueError(f"expected {len(names)} leaves, got {len(arrays)}")
    if plain and spec.n_shards != 1:
        raise ValueError("a plain state is one shard: n_shards must be 1")
    dev = resolve_device(device)
    want = _init(spec, () if plain else (spec.n_shards,), "meta")
    leaves = []
    for name, a, ref in zip(names, arrays, want.leaves()):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {name}: shape {a.shape} != "
                             f"{tuple(ref.shape)}")
        leaves.append(torch.from_numpy(np.array(a, np.int32)).to(dev))
    state = type(want)(*leaves)
    return state if plain else ShardedState(state)


def to_numpy(state, spec: SketchSpec | None = None):
    """The leaves of a handle (with the shard axis) or of a plain state
    (without it) as numpy arrays, in ``jax.tree.leaves`` order. A
    mesh-resident handle gives the whole stack (``fleet_shards``, which
    needs its ``spec``)."""
    if isinstance(state, ShardedState):
        if mesh_context(state) is not None:
            if spec is None:
                raise ValueError("to_numpy of a mesh-resident handle "
                                 "gathers its rows: pass its spec")
            state = fleet_shards(spec, state)
        else:
            state = state.live()
    return [x.cpu().numpy() for x in state.leaves()]


# --------------------------------------------------------------------------
# mesh residency
# --------------------------------------------------------------------------

# host-side handle attribute carrying the MeshContext; every producer of a
# new handle decides whether to carry it forward (ingest does, reshard
# does not)
_MESH_ATTR = "_mesh_ctx"

# (n_shards, n_devices, axis) triples already warned about: the
# replication warning fires once per distinct mismatch, not per call
_replication_warned: set = set()


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """Where a handle's shard axis lives: a ``torch.distributed`` process
    group (``None``: the default group of every rank) and the name of the
    axis the leading ``[n_shards]`` dimension is laid over. ``rank`` is
    this process's index in the group, ``n_devices`` the group's size."""

    group: Any = None
    axis: str = "data"

    def __post_init__(self):
        if not dist.is_initialized():
            raise RuntimeError("a MeshContext needs an initialized process "
                               "group (repro_torch.distributed.ranks."
                               "init_group)")
        if self.group is None:
            object.__setattr__(self, "group", dist.group.WORLD)

    @property
    def n_devices(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def divides(self, n_shards: int) -> bool:
        """True iff the shard axis shards over this group
        (``named_shardings`` replicates otherwise)."""
        return n_shards % self.n_devices == 0

    def block(self, n_shards: int) -> slice:
        """This rank's rows of an ``n_shards`` stack (every row when the
        group does not divide it)."""
        if not self.divides(n_shards):
            return slice(0, n_shards)
        per = n_shards // self.n_devices
        return slice(self.rank * per, (self.rank + 1) * per)


def _as_context(mesh, axis: str) -> MeshContext:
    return mesh if isinstance(mesh, MeshContext) else \
        MeshContext(group=mesh, axis=axis)


def mesh_context(state) -> MeshContext | None:
    """The ``MeshContext`` attached to a handle, or None (host-resident)."""
    return getattr(state, _MESH_ATTR, None)


def with_mesh(state: ShardedState, ctx: MeshContext | None) -> ShardedState:
    """Attach a ``MeshContext`` to a handle already laid out for it (returns
    the same object); ``place`` does this itself."""
    if ctx is not None:
        setattr(state, _MESH_ATTR, ctx)
    return state


def split_context(spec: SketchSpec, state) -> MeshContext | None:
    """The context of a handle whose rows are split over its group, or None
    when this rank holds every row (host-resident or replicated)."""
    ctx = mesh_context(state)
    return ctx if ctx is not None and ctx.divides(spec.n_shards) else None


def named_shardings(spec: SketchSpec, mesh=None, axis: str = "data"):
    """A ``ShardedState``-shaped tree of each leaf's layout over ``mesh``
    (a ``MeshContext``, a process group, or None for the default group):
    ``(axis, None, ...)``, one entry a dimension, with the leading shard
    axis over ``axis``, or ``(None, ...)`` when the group does not divide
    ``n_shards`` and the state is replicated. The mismatch warns once per
    ``(n_shards, n_devices, axis)``: replication is correct but forfeits
    the memory split and the collective query."""
    ctx = _as_context(mesh, axis)
    spec_axis = ctx.axis
    if not ctx.divides(spec.n_shards):
        key = (spec.n_shards, ctx.n_devices, ctx.axis)
        if key not in _replication_warned:
            _replication_warned.add(key)
            warnings.warn(
                f"mesh axis {ctx.axis!r} has {ctx.n_devices} devices, which "
                f"does not divide n_shards={spec.n_shards}: the sketch state "
                "will be fully replicated on every device (correct, but no "
                "memory scaling and no collective query). Pick n_shards as "
                f"a multiple of {ctx.n_devices} to shard.", UserWarning,
                stacklevel=2)
        spec_axis = None
    target = _init(spec, (spec.n_shards,), "meta")
    return ShardedState(target.map(
        lambda leaf: (spec_axis,) + (None,) * (leaf.dim() - 1)))


def place(spec: SketchSpec, state: ShardedState, mesh=None,
          axis: str = "data") -> ShardedState:
    """Lay the handle's shard axis over ``mesh`` (a ``MeshContext``, a
    process group, or None for the default group) and attach the
    ``MeshContext`` that makes it mesh-resident: this rank keeps its block
    of rows (every row when the group does not divide ``n_shards``,
    after ``named_shardings``' warning). Where the block is the whole
    stack the placed handle is a view of the input's tensors (a world of
    one does not copy an 18 GB state): ingest into one of the two then
    changes both, so keep using one. A CUDA state needs a NCCL group and
    a CPU state a gloo one; there is no host staging."""
    ctx = _as_context(mesh, axis)
    named_shardings(spec, ctx)  # the replication warning
    dev = state.device
    if (ctx.backend == "nccl") != (dev.type == "cuda"):
        raise ValueError(
            f"a {dev.type} state cannot be placed over a {ctx.backend} "
            "group: CUDA tensors need NCCL, CPU tensors gloo")
    shards = state.live()
    sl = ctx.block(spec.n_shards)
    if sl.stop - sl.start != spec.n_shards:
        shards = shards.map(lambda x: x[sl].clone())
    return with_mesh(ShardedState(shards), ctx)


def fleet_shards(spec: SketchSpec, state: ShardedState):
    """The whole ``[n_shards, ...]`` stack on this rank: the handle's own
    rows, or for a split handle every rank's block gathered in rank order
    (one ``all_gather`` a leaf; every rank of the group must call it)."""
    shards = state.live()
    ctx = split_context(spec, state)
    if ctx is None or ctx.n_devices == 1:
        return shards

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(ctx.n_devices)]
        dist.all_gather(parts, x.contiguous(), group=ctx.group)
        return torch.cat(parts)

    return shards.map(gather)


def merge_all(spec: SketchSpec, state: ShardedState):
    """Reduce the handle to one plain sketch state (counter addition with
    per-slot window reconciliation, ``core.merge``). Bit-identical to
    single-sketch ingest of the same stream iff ``shards_compatible``; on
    a contended partition conflicting cells keep one key (prefer the
    sharded ``query`` there)."""
    shards = fleet_shards(spec, state)
    if spec.kind == "lgs":
        return _merge.lgs_merge_all(spec.config, shards)
    return _merge.merge_all(spec.config, shards)


def shards_compatible(spec: SketchSpec, state: ShardedState) -> torch.Tensor:
    """0-dim bool tensor: the shards are exactly mergeable (no cross-shard
    cell or pool-slot contention). Always True for LGS: it has no keys."""
    if spec.kind == "lgs":
        return torch.tensor(True, device=state.device)
    return _merge.shard_keys_compatible(fleet_shards(spec, state))
