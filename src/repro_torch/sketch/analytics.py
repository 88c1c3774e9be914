"""Handle-layer analytics portfolio (port of ``repro.sketch.analytics``):
windowed heavy vertices, heavy edges and top label blocks, and batched
reachability, on a ``(SketchSpec, ShardedState)`` handle.

Paths (the names of ``query``):

  * ``"scan"`` — re-reduce the window planes per call (no cache) and decode
    the cell owners with the plain version;
  * ``"cuda"`` — the ``query_planes`` / ``query_planes_multi`` cache and
    the cell-decode CUDA kernel (its plain version on a CPU state).

Both are bit-identical to each other and to the JAX package: per-identity
totals are order-free integer sums and the ranking is (descending weight,
ascending identity). Every top-k takes ``last=`` (the most recent ``last``
subwindows) or ``horizons=[...]`` (a sweep: ``[H, k]`` rows, row ``i``
equal to ``last=horizons[i]``), not both. ``reachable_many`` is a batched
host BFS over the by-identity edge check and successor scan.

An ``lgs`` sketch raises ``NotImplementedError`` (its cells store no keys
to decode); a ``gss`` sketch has no window, so ``last=`` is dropped and a
``horizons=`` sweep repeats its one answer. A plain single-shard state is
lifted to a 1-shard handle over views of its tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import queries as _cq
from repro_torch.core.lsketch import precompute
from repro_torch.kernels.heavy_hitters.ops import (
    heavy_edges_planes, heavy_vertices_planes, top_labels_planes)

from .query import (_normalize_horizons, _with_global_window, query_planes,
                    query_planes_multi, resolve_query_path)
from .spec import SketchSpec
from .state import ShardedState

# frontier vertices per successor scan: its [U, r, d, 2, k] gather stays
# near 256 MiB at any width
_SCAN_BYTES = 1 << 28


def _planes_topk(cfg, planes, kind: str, k: int, direction: str, *,
                 kernel: bool):
    if kind == "vertex":
        return heavy_vertices_planes(cfg, planes, k, direction=direction,
                                     kernel=kernel)
    if kind == "edge":
        return heavy_edges_planes(cfg, planes, k, kernel=kernel)
    return top_labels_planes(cfg, planes, k, direction=direction,
                             kernel=kernel)


def _handle(state) -> ShardedState:
    """A handle over ``state``: itself, or a 1-shard view of a plain
    state."""
    return state if isinstance(state, ShardedState) else \
        ShardedState.lift(state)


def _analytics(spec: SketchSpec, state, kind: str, k: int,
               direction: str, last, path: str, horizons=None):
    if spec.kind == "lgs":
        raise NotImplementedError(
            "LGS cells store no keys — the reversible cell-owner decode "
            "needs LSketch/GSS")
    if horizons is not None and last is not None:
        raise ValueError("pass either last= (one horizon) or horizons= "
                         "(a sweep), not both")
    state = _handle(state)
    if spec.kind == "gss":
        if horizons is not None:  # no window ring: one ranking fits all
            out = _analytics(spec, state, kind, k, direction, None, path)
            return tuple(x[None].expand((len(horizons),) + x.shape)
                         for x in out)
        last = None  # no window ring to restrict
    cfg = spec.config
    path = resolve_query_path(path, state.device)
    if horizons is not None:
        horizons = list(horizons)
        if not horizons:
            raise ValueError("horizons= needs at least one horizon")
        if path == "scan":
            outs = [_analytics(spec, state, kind, k, direction,
                               None if h is None else int(h), path)
                    for h in horizons]
        else:
            _, sel = _normalize_horizons(spec, horizons)
            planes, uniq = query_planes_multi(spec, state, horizons)
            rows = [_planes_topk(cfg, _cq.slice_horizon(planes, i), kind, k,
                                 direction, kernel=True)
                    for i in range(len(uniq))]
            outs = [rows[i] for i in sel]
        return tuple(torch.stack(xs) for xs in zip(*outs))
    if path == "cuda":
        planes = query_planes(spec, state, last)
        return _planes_topk(cfg, planes, kind, k, direction, kernel=True)
    planes = _cq.build_query_planes(
        cfg, _with_global_window(state.live()), last)
    return _planes_topk(cfg, planes, kind, k, direction, kernel=False)


def heavy_vertices(spec: SketchSpec, state: ShardedState, k: int = 10, *,
                   direction: str = "out", last=None, horizons=None,
                   path: str = "auto"):
    """Top-k vertices by windowed out/in weight across all shards:
    (vids [k], weights [k]) int32 — packed (block, address, fingerprint)
    identities recovered by key reversibility, descending weight, ties
    ascending vid, (-1, 0) padding. One-sided (over-)estimates.
    ``horizons=`` gives ``([H, k], [H, k])``."""
    return _analytics(spec, state, "vertex", k, direction, last, path,
                      horizons=horizons)


def heavy_edges(spec: SketchSpec, state: ShardedState, k: int = 10, *,
                last=None, horizons=None, path: str = "auto"):
    """Top-k edges by windowed weight: (src [k], dst [k], weights [k]).
    Matrix cells and pool entries rank together; ties break by ascending
    (src_vid, dst_vid). ``horizons=`` gives ``[H, k]`` rows."""
    return _analytics(spec, state, "edge", k, "out", last, path,
                      horizons=horizons)


def top_labels(spec: SketchSpec, state: ShardedState, k: int = 10, *,
               direction: str = "out", last=None, horizons=None,
               path: str = "auto"):
    """Top-k vertex-label blocks by windowed out/in weight: (blocks [k],
    weights [k]). ``horizons=`` gives ``[H, k]`` rows."""
    return _analytics(spec, state, "label", k, direction, last, path,
                      horizons=horizons)


# --------------------------------------------------------------------------
# batched reachability
# --------------------------------------------------------------------------

def _exists_any_shard(cfg, shards, pairs, last) -> np.ndarray:
    """bool [B]: the edge of each packed-identity pair holds weight in the
    window on some shard."""
    hit = torch.zeros(pairs.shape[0], dtype=torch.bool, device=pairs.device)
    for s in range(shards.key.shape[0]):
        hit |= _cq._edge_exists_by_vid(cfg, shards.map(lambda x: x[s]),
                                       pairs, last)
    return hit.cpu().numpy()


def _successor_sets(cfg, shards, uniq, last) -> dict:
    """{vid: set of successor vids} over all shards, the frontier scanned
    in chunks."""
    dev = shards.key.device
    out = {v: set() for v in uniq}
    k = shards.C.shape[-1]
    chunk = max(1, _SCAN_BYTES // (cfg.r * cfg.d * 2 * k * 4))
    for a in range(0, len(uniq), chunk):
        part = uniq[a:a + chunk]
        vids = torch.tensor(part, dtype=torch.int32, device=dev)
        for s in range(shards.key.shape[0]):
            succ, valid = _cq._successors_by_vid(
                cfg, shards.map(lambda x: x[s]), vids, last)
            valid &= succ >= 0
            u, j = torch.nonzero(valid, as_tuple=True)
            for ui, v in zip(u.tolist(), succ[u, j].tolist()):
                out[part[ui]].add(v)
    return out


def reachable_many(spec: SketchSpec, state: ShardedState, src, src_label,
                   dst, dst_label, *, max_hops: int = 8, last=None,
                   horizons=None) -> np.ndarray:
    """Batched multi-hop reachability: bool [B], True where a path of 1..
    ``max_hops`` edges connects (src, src_label) to (dst, dst_label).

    One host frontier loop for the whole batch: per hop one direct-edge
    check over every (frontier vertex, target) pair and one successor scan
    over the union of the active frontiers, unioned across shards.
    ``last=h`` restricts every edge to the h most recent subwindows.
    ``horizons=[...]`` (exclusive with ``last=``) returns bool ``[H, B]``,
    row ``i`` equal to ``last=horizons[i]``: validity masks nest, so the
    loosest horizon runs on the full batch and each tighter one re-walks
    only the pairs still reachable."""
    if spec.kind == "lgs":
        raise NotImplementedError(
            "LGS cells store no keys — successor recovery needs LSketch/GSS")
    if horizons is not None and last is not None:
        raise ValueError("pass either last= (one horizon) or horizons= "
                         "(a sweep), not both")
    state = _handle(state)
    if spec.kind == "gss":
        last = None  # no window ring to restrict
        if horizons is not None:
            out = reachable_many(spec, state, src, src_label, dst, dst_label,
                                 max_hops=max_hops)
            return np.broadcast_to(out[None],
                                   (len(horizons),) + out.shape).copy()
    cfg = spec.config
    if horizons is not None:
        horizons = list(horizons)
        if not horizons:
            raise ValueError("horizons= needs at least one horizon")
        k = cfg.effective_k
        clamp = [k if h is None else min(int(h), k) for h in horizons]
        src_b = np.atleast_1d(np.asarray(src, np.int64))
        B = src_b.shape[0]
        sl_b = np.broadcast_to(np.asarray(src_label, np.int64), (B,))
        dst_b = np.broadcast_to(np.asarray(dst, np.int64), (B,))
        dl_b = np.broadcast_to(np.asarray(dst_label, np.int64), (B,))
        by_h: dict = {}
        alive = None  # still reachable at the looser horizon
        for h in sorted(set(clamp), reverse=True):
            row = np.zeros(B, bool)
            idx = np.arange(B) if alive is None else alive
            if idx.size:
                row[idx] = reachable_many(
                    spec, state, src_b[idx], sl_b[idx], dst_b[idx],
                    dl_b[idx], max_hops=max_hops, last=h)
            by_h[h] = row
            alive = np.nonzero(row)[0]
        return np.stack([by_h[h] for h in clamp])
    if last is not None:
        last = min(int(last), cfg.effective_k)
    shards = _with_global_window(state.live())
    dev = state.device
    src = np.atleast_1d(np.asarray(src))
    B = src.shape[0]

    def col(x):
        return torch.from_numpy(np.array(np.broadcast_to(
            np.asarray(x), (B,)), np.int32)).to(dev)

    targets = precompute(cfg, col(dst), col(dst_label)).vid.tolist()
    frontiers = [{v} for v in precompute(cfg, col(src),
                                         col(src_label)).vid.tolist()]
    visited = [set(f) for f in frontiers]
    done = np.zeros(B, bool)
    for _ in range(max_hops):
        active = [i for i in range(B) if not done[i] and frontiers[i]]
        if not active:
            break
        owners = [i for i in active for _ in frontiers[i]]
        pairs = torch.tensor([[v, targets[i]] for i in active
                              for v in frontiers[i]], dtype=torch.int32,
                             device=dev)
        hit = _exists_any_shard(cfg, shards, pairs, last)
        done[[i for j, i in enumerate(owners) if hit[j]]] = True
        uniq = sorted({v for i in active if not done[i] for v in frontiers[i]})
        if not uniq:
            continue
        succ_of = _successor_sets(cfg, shards, uniq, last)
        for i in active:
            if done[i]:
                continue
            nf = set().union(*(succ_of[v] for v in frontiers[i]))
            frontiers[i] = nf - visited[i]
            visited[i] |= nf
    return done
