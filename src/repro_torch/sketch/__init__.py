"""repro_torch.sketch — sharded sketch handles on PyTorch.

    spec  = make_spec("lsketch", n_shards=4, d=128, n_blocks=4, ...)
    state = create(spec)                       # on the card by default
    state = ingest(spec, state, edge_batch)    # in place; old handle spent
    ing   = AsyncIngestor(spec, heat_threshold=0.02); ing.submit(b)
    w     = query(spec, state, QueryBatch.edges(src, la, dst, lb))
    W     = query(spec, state, QueryBatch.vertices(v, lv, last=[None, 1]))
    ws    = query_many(spec, state, [q_edges, q_vertices, q_labels])
    vids, weights = heavy_vertices(spec, state, k=16, last=1)
    save(spec, state, ckpt_dir); state = restore(spec, ckpt_dir)
    state8 = reshard(spec, state, 8)           # balanced across 8 shards
    plain = merge_all(spec, state)             # one plain state
    pool  = TenantPool(spec, n_slots=8); pool.submit({"a": b1, "b": b2})
    st    = place(spec, create(spec), MeshContext())  # on each rank
    w     = query(spec, st, q, path="collective")     # the fleet answer
"""

from __future__ import annotations

from .spec import (KINDS, SketchSpec, make_spec, shard_assignment,
                   shard_assignment_vids)
from .routing import (BudgetReport, HeavyKeyDetector, RoutingTable,
                      prune_routing, recommend_budget, routed_assignment,
                      routed_assignment_vids)
from .state import (MeshContext, ShardedState, create, fleet_shards,
                    from_numpy, merge_all, mesh_context, named_shardings,
                    place, shards_compatible, stack_states, to_numpy,
                    unstack_state, with_mesh)
from .ingest import AsyncIngestor, ingest, ingest_single
from .query import (MAX_DELTA_CHAIN, PLANES_BUILD_COUNTS, QueryBatch,
                    clear_plane_cache, default_query_path, query,
                    query_many, query_planes, query_planes_multi,
                    resolve_query_path)
from .analytics import (heavy_edges, heavy_vertices, reachable_many,
                        top_labels)
from .reshard import reshard
from .checkpoint import restore, save, saved_extra, saved_spec
from .tenant import PoolFullError, TenantPool

__all__ = [
    "KINDS", "SketchSpec", "make_spec", "shard_assignment",
    "shard_assignment_vids",
    "BudgetReport", "HeavyKeyDetector", "RoutingTable", "prune_routing",
    "recommend_budget", "routed_assignment", "routed_assignment_vids",
    "ShardedState", "create", "from_numpy", "merge_all", "shards_compatible",
    "stack_states", "to_numpy", "unstack_state", "reshard",
    "MeshContext", "fleet_shards", "mesh_context", "named_shardings",
    "place", "with_mesh",
    "AsyncIngestor", "ingest", "ingest_single", "QueryBatch",
    "MAX_DELTA_CHAIN", "PLANES_BUILD_COUNTS", "query", "query_many",
    "query_planes",
    "query_planes_multi", "clear_plane_cache", "default_query_path",
    "resolve_query_path",
    "heavy_vertices", "heavy_edges", "top_labels", "reachable_many",
    "restore", "save", "saved_extra", "saved_spec",
    "PoolFullError", "TenantPool",
]
