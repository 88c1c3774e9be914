"""repro_torch.sketch — sharded sketch handles on PyTorch.

    spec  = make_spec("lsketch", n_shards=4, d=128, n_blocks=4, ...)
    state = create(spec)                       # on the card by default
    state = ingest(spec, state, edge_batch)    # in place; old handle spent
    w     = query(spec, state, QueryBatch.edges(src, la, dst, lb))
    W     = query(spec, state, QueryBatch.vertices(v, lv, last=[None, 1]))
    vids, weights = heavy_vertices(spec, state, k=16, last=1)
"""

from __future__ import annotations

from .spec import KINDS, SketchSpec, make_spec, shard_assignment
from .state import (ShardedState, create, from_numpy, stack_states,
                    to_numpy, unstack_state)
from .ingest import ingest, ingest_single
from .query import (PLANES_BUILD_COUNTS, QueryBatch, clear_plane_cache,
                    query, query_planes, query_planes_multi,
                    resolve_query_path)
from .analytics import (heavy_edges, heavy_vertices, reachable_many,
                        top_labels)

__all__ = [
    "KINDS", "SketchSpec", "make_spec", "shard_assignment", "ShardedState",
    "create", "from_numpy", "stack_states", "to_numpy", "unstack_state",
    "ingest", "ingest_single", "QueryBatch", "PLANES_BUILD_COUNTS", "query", "query_planes", "query_planes_multi",
    "clear_plane_cache", "resolve_query_path", "heavy_vertices",
    "heavy_edges", "top_labels", "reachable_many",
]
