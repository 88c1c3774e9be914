"""ShardedState — the dynamic half of a sketch handle.

A ``ShardedState`` wraps one ``LSketchState`` whose every leaf carries a
leading ``[n_shards]`` axis. It is a handle object: ingest updates the
tensors in place and returns a *new* handle over them, and marks the old
one spent (the port's counterpart of JAX buffer donation — a 4-shard
state at d=2048 is about 17 GiB and cannot be copied per flush). Any use
of a spent handle raises. Host-side caches (the query planes) hang off the
handle object, so a new handle starts cold and no stale planes survive an
ingest.

``from_numpy``/``to_numpy`` carry a state across the seam to the JAX
package: the arrays are the JAX ``ShardedState``'s leaves in
``jax.tree.leaves`` order, which is the field order of ``LSketchState``:
key, C, P, pool_key, pool_C, pool_P, pool_lost, slot_widx, cur_widx —
each with the leading shard axis.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import LEAVES, LSketchState, init_leaves, \
    resolve_device

from .spec import SketchSpec


class ShardedState:
    """Per-shard sketch states stacked on a leading ``[n_shards]`` axis."""

    def __init__(self, shards: LSketchState):
        self.shards = shards
        self.spent = False

    @property
    def device(self) -> torch.device:
        return self.shards.key.device

    def live(self) -> LSketchState:
        """The shard stack, or raise if an ingest consumed this handle."""
        if self.spent:
            raise RuntimeError("this handle was consumed by ingest (its "
                               "tensors were updated in place); use the "
                               "handle ingest returned")
        return self.shards


def create(spec: SketchSpec, device=None) -> ShardedState:
    """Fresh all-empty state for every shard, allocated on ``device`` (the
    card unless the caller names the CPU)."""
    dev = resolve_device(device)
    return ShardedState(init_leaves(spec.config, (spec.n_shards,), dev))


def stack_states(states) -> ShardedState:
    """Wrap a list of plain per-shard states into a handle (copies)."""
    return ShardedState(LSketchState(*[
        torch.stack(xs) for xs in zip(*[s.leaves() for s in states])]))


def unstack_state(state: ShardedState, shard: int = 0) -> LSketchState:
    """Plain state of one shard (views of the handle's tensors)."""
    return state.live().map(lambda x: x[shard])


def from_numpy(spec: SketchSpec, arrays, device=None) -> ShardedState:
    """A handle over arrays given in ``jax.tree.leaves`` order of a JAX
    ``ShardedState`` (see the module docstring), checked against ``spec``."""
    arrays = list(arrays)
    if len(arrays) != len(LEAVES):
        raise ValueError(f"expected {len(LEAVES)} leaves, got {len(arrays)}")
    dev = resolve_device(device)
    want = init_leaves(spec.config, (spec.n_shards,), "meta")
    leaves = []
    for name, a, ref in zip(LEAVES, arrays, want.leaves()):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {name}: shape {a.shape} != "
                             f"{tuple(ref.shape)}")
        leaves.append(torch.from_numpy(np.array(a, np.int32)).to(dev))
    return ShardedState(LSketchState(*leaves))


def to_numpy(state: ShardedState):
    """The handle's leaves as numpy arrays, in ``jax.tree.leaves`` order."""
    return [x.cpu().numpy() for x in state.live().leaves()]
