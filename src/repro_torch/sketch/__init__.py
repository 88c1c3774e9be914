"""repro_torch.sketch — sharded sketch handles on PyTorch.

    spec  = make_spec("lsketch", n_shards=4, d=128, n_blocks=4, ...)
    state = create(spec)                       # on the card by default
    state = ingest(spec, state, edge_batch)    # in place; old handle spent
    w     = query(spec, state, QueryBatch.edges(src, la, dst, lb))
"""

from __future__ import annotations

from .spec import KINDS, SketchSpec, make_spec, shard_assignment
from .state import (ShardedState, create, from_numpy, stack_states,
                    to_numpy, unstack_state)
from .ingest import ingest
from .query import QueryBatch, query, query_planes, resolve_query_path

__all__ = [
    "KINDS", "SketchSpec", "make_spec", "shard_assignment", "ShardedState",
    "create", "from_numpy", "stack_states", "to_numpy", "unstack_state",
    "ingest", "QueryBatch", "query", "query_planes", "resolve_query_path",
]
