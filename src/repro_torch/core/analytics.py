"""Host-side analytics reference (port of ``repro.core.analytics``; paper
§1: top-k items, heavy hitters, triangle counting).

The fixed host twin of the handle-layer portfolio
(``repro_torch.sketch.analytics``): one plain (unstacked) state, numpy
dict aggregation, deliberately simple. It fixes the semantics under
collisions and pool overflow:

  * heavy_hitter_vertices — top-k vertices by windowed out/in weight: every
    occupied cell aggregated by its decoded owner (``decode_line_vid``),
    merged with the pool; ties break by ascending packed vid.
  * heavy_hitter_edges — top-k (src_vid, dst_vid) pairs, matrix cells and
    pool entries together; ties break by ascending (src_vid, dst_vid).
  * top_label_blocks — top-k label blocks (the decoded vid's block id).
  * triangle_estimate — approximate directed-triangle count over the
    heaviest edges, by batched edge-existence checks on the sketch.

``LSketch.heavy_hitters``/``heavy_edges``/``triangle_count`` are these on
the object's plain state.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import hashing as hsh
from .lsketch import LSketch, valid_slot_mask
from .queries import _edge_exists_by_vid, _successors_by_vid, _sum32
from .types import EMPTY, LSketchConfig, LSketchState


def _cell_weights_by_vertex(cfg: LSketchConfig, state: LSketchState,
                            direction: str = "out", last: int | None = None):
    """[d*d*2] packed owner vertex-ids + windowed weights of every cell."""
    mask = valid_slot_mask(cfg, state, last)
    w = _sum32(torch.where(mask, state.C, 0), -1)  # [d, d, 2]
    keys = state.key
    ia, ib, fa, fb = hsh.unpack_key(keys, cfg.F)
    starts, widths = cfg.block_start_width(keys.device)
    rows = torch.arange(cfg.d, dtype=torch.int32, device=keys.device)
    if direction == "out":  # owner = source: row line, index ia, print fa
        vid = hsh.decode_line_vid(rows[:, None, None], ia, fa, starts,
                                  widths, cfg.r, cfg.F)
    else:
        vid = hsh.decode_line_vid(rows[None, :, None], ib, fb, starts,
                                  widths, cfg.r, cfg.F)
    vid = torch.where((keys != EMPTY) & (w > 0), vid, -1)
    return vid.reshape(-1).cpu().numpy(), w.reshape(-1).cpu().numpy()


def _pool_weights(cfg, state, last):
    mask = valid_slot_mask(cfg, state, last).cpu().numpy().astype(np.int64)
    return (state.pool_C.cpu().numpy() * mask).sum(-1)


def _ranked(agg: dict, k: int):
    return sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def _owner_rows(cfg, state, direction, last):
    vid, w = _cell_weights_by_vertex(cfg, state, direction, last)
    pw = _pool_weights(cfg, state, last)
    col = 0 if direction == "out" else 1
    pvid = state.pool_key[:, col].cpu().numpy()
    return (np.concatenate([vid, np.where(pw > 0, pvid, -1)]),
            np.concatenate([w, pw]))


def heavy_hitter_vertices(cfg: LSketchConfig, state: LSketchState,
                          k: int = 10, direction: str = "out",
                          last: int | None = None) -> List[Tuple[int, int]]:
    """Top-k (packed vertex id, weight) by windowed out/in weight."""
    vid, w = _owner_rows(cfg, state, direction, last)
    live = vid >= 0
    agg: dict = {}
    for v, ww in zip(vid[live].tolist(), w[live].tolist()):
        agg[v] = agg.get(v, 0) + ww
    return _ranked(agg, k)


def heavy_hitter_edges(cfg: LSketchConfig, state: LSketchState, k: int = 10,
                       last: int | None = None):
    """Top-k (src_vid, dst_vid) pairs by windowed weight: [(src, dst, w)].
    Every occupied matrix cell and every pool entry aggregates (an edge
    that overflowed to the pool ranks with its full weight)."""
    mask = valid_slot_mask(cfg, state, last).cpu().numpy().astype(np.int64)
    w = (state.C.cpu().numpy() * mask).sum(-1).reshape(-1)
    src_vid, _ = _cell_weights_by_vertex(cfg, state, "out", last)
    dst_vid, _ = _cell_weights_by_vertex(cfg, state, "in", last)
    pw = _pool_weights(cfg, state, last)
    pk = state.pool_key.cpu().numpy()
    plive = (pk[:, 0] != EMPTY) & (pw > 0)
    src_vid = np.concatenate([src_vid, np.where(plive, pk[:, 0], -1)])
    dst_vid = np.concatenate([dst_vid, np.where(plive, pk[:, 1], -1)])
    w = np.concatenate([w, pw])
    live = (src_vid >= 0) & (w > 0)
    agg: dict = {}
    for a, b, ww in zip(src_vid[live].tolist(), dst_vid[live].tolist(),
                        w[live].tolist()):
        agg[(a, b)] = agg.get((a, b), 0) + ww
    return [(a, b, ww) for (a, b), ww in _ranked(agg, k)]


def top_label_blocks(cfg: LSketchConfig, state: LSketchState, k: int = 10,
                     direction: str = "out", last: int | None = None
                     ) -> List[Tuple[int, int]]:
    """Top-k (vertex-label block, weight) by windowed out/in weight; ties
    break by ascending block id."""
    vid, w = _owner_rows(cfg, state, direction, last)
    live = (vid >= 0) & (w > 0)
    agg: dict = {}
    for m, ww in zip((vid[live] // (2048 * cfg.F)).tolist(),
                     w[live].tolist()):
        agg[m] = agg.get(m, 0) + ww
    return _ranked(agg, k)


def triangle_estimate(cfg: LSketchConfig, state: LSketchState,
                      max_seed_edges: int = 64) -> int:
    """Approximate directed triangle count u->v->w->u over the heaviest
    edges: wedge closure checked with batched sketch edge-existence."""
    dev = state.key.device
    total = 0
    for u, v, _w in heavy_hitter_edges(cfg, state, k=max_seed_edges):
        succ, valid = _successors_by_vid(
            cfg, state, torch.tensor([v], dtype=torch.int32, device=dev))
        ws = np.unique(succ[valid].cpu().numpy())
        ws = ws[ws >= 0][:256]
        if len(ws) == 0:
            continue
        pairs = torch.stack([torch.from_numpy(ws.astype(np.int32)),
                             torch.full((len(ws),), u, dtype=torch.int32)],
                            dim=1).to(dev)
        total += int(_edge_exists_by_vid(cfg, state, pairs).sum())
    return total


def _sketch_heavy_hitters(self: LSketch, k=10, direction="out", last=None):
    return heavy_hitter_vertices(self.cfg, self.state, k, direction, last)


def _sketch_heavy_edges(self: LSketch, k=10, last=None):
    return heavy_hitter_edges(self.cfg, self.state, k, last)


def _sketch_triangles(self: LSketch, max_seed_edges=64):
    return triangle_estimate(self.cfg, self.state, max_seed_edges)


LSketch.heavy_hitters = _sketch_heavy_hitters
LSketch.heavy_edges = _sketch_heavy_edges
LSketch.triangle_count = _sketch_triangles
