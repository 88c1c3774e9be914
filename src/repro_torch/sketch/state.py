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
"""

from __future__ import annotations

import numpy as np
import torch

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


def to_numpy(state):
    """The leaves of a handle (with the shard axis) or of a plain state
    (without it) as numpy arrays, in ``jax.tree.leaves`` order."""
    if isinstance(state, ShardedState):
        state = state.live()
    return [x.cpu().numpy() for x in state.leaves()]


def merge_all(spec: SketchSpec, state: ShardedState):
    """Reduce the handle to one plain sketch state (counter addition with
    per-slot window reconciliation, ``core.merge``). Bit-identical to
    single-sketch ingest of the same stream iff ``shards_compatible``; on
    a contended partition conflicting cells keep one key (prefer the
    sharded ``query`` there)."""
    if spec.kind == "lgs":
        return _merge.lgs_merge_all(spec.config, state.live())
    return _merge.merge_all(spec.config, state.live())


def shards_compatible(spec: SketchSpec, state: ShardedState) -> torch.Tensor:
    """0-dim bool tensor: the shards are exactly mergeable (no cross-shard
    cell or pool-slot contention). Always True for LGS: it has no keys."""
    if spec.kind == "lgs":
        return torch.tensor(True, device=state.device)
    return _merge.shard_keys_compatible(state.live())
