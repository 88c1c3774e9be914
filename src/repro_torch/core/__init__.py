"""Sketch configuration, state, hashing, addressing, dense queries, and the
object API (port of ``repro.core``):

  LSketchConfig / LSketchState / init_state / state_bytes / EdgeBatch
  LSketch (object API), insert_batch / insert_window_batch (functional)
  edge_query / vertex_query / vertex_label_aggregate / successor_scan /
  path_reachability / subgraph_query (queries)
  GSS / gss_config, LGS / LGSConfig / LGSState / lgs_init_state (baselines)
  heavy_hitter_edges / heavy_hitter_vertices / triangle_estimate
"""

from .types import (EMPTY, EdgeBatch, LSketchConfig, LSketchState, init_state,
                    state_bytes)
from .lsketch import (LSketch, edge_probes, insert_batch, insert_window_batch,
                      precompute, valid_slot_mask, window_index)
from .queries import (edge_query, path_reachability, subgraph_query,
                      successor_scan, vertex_label_aggregate, vertex_query)
from .gss import GSS, gss_config
from .lgs import LGS, LGSConfig, LGSState, lgs_init_state
from . import hashing
from .analytics import (heavy_hitter_edges, heavy_hitter_vertices,
                        triangle_estimate)

__all__ = [
    "EMPTY", "EdgeBatch", "LSketchConfig", "LSketchState", "init_state",
    "state_bytes", "LSketch", "edge_probes", "insert_batch",
    "insert_window_batch", "precompute", "valid_slot_mask", "window_index",
    "edge_query", "path_reachability", "subgraph_query", "successor_scan",
    "vertex_label_aggregate", "vertex_query", "GSS", "gss_config", "LGS",
    "LGSConfig", "LGSState", "lgs_init_state", "hashing",
    "heavy_hitter_edges", "heavy_hitter_vertices", "triangle_estimate",
]
