"""Heavy-hitter / top-k analytics over window-reduced planes (port of
``repro/kernels/heavy_hitters/ops.py``).

``heavy_vertices_planes`` / ``heavy_edges_planes`` / ``top_labels_planes``
decode every cell's owners (``decode_cell_owners``: the CUDA kernel, or
its plain version with ``kernel=False``), flatten each shard's matrix
cells then pool entries into (identity, weight) rows, and rank them in
plain PyTorch (``segment_topk``; the reference's epilogue is XLA, not
Pallas).

Semantics, bit for bit with the reference: every occupied cell and every
pool entry aggregates by decoded identity; totals follow the reference's
int32 arithmetic before the ``total > 0`` test; the ranking is descending
total, then ascending identity (edges lexicographic on ``(src, dst)``, as
one int64 key); outputs are ``[k]`` padded with ``(-1, 0)``. The ranking
uses stable sorts only — neither ``torch.topk`` nor ``argmax`` documents
its tie order on the card.

With ``groups=G`` (a pooled stack of tenants, ``sketch.tenant``) the
owners of every row are decoded in one launch and each block of
``S // G`` rows is ranked on its own: the outputs gain a leading [G] axis,
row g equal to the ranking of group g's rows alone.

With ``group=`` (a ``torch.distributed`` process group, the counterpart of
the reference's ``axis_name``) the planes are this rank's block of shard
rows: the local decode's flattened (identity, weight) rows are gathered
from every rank in rank order, which is shard order, and ranked on every
rank, so each rank returns the fleet's top-k with the reference's tie
order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core.hashing import _wrap32
from repro_torch.core.queries import QueryPlanes
from repro_torch.core.types import EMPTY, LSketchConfig

from .kernel import cell_decode_kernel_sharded, cell_decode_plain


def _static_blocks(cfg: LSketchConfig
                   ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The block partition ``(starts, widths)`` as Python int tuples."""
    if cfg.block_bounds is not None:
        return (tuple(s for s, _ in cfg.block_bounds),
                tuple(w for _, w in cfg.block_bounds))
    return (tuple(i * cfg.b for i in range(cfg.n_blocks)),
            (cfg.b,) * cfg.n_blocks)


def decode_cell_owners(cfg: LSketchConfig, planes: QueryPlanes, *,
                       kernel: bool = True):
    """(vid_src, vid_dst) [S, 2, d, d]: decoded owners of every cell of the
    planes, EMPTY (-1) where unoccupied. ``kernel=False`` takes the plain
    version on any device (the scan path)."""
    starts, widths = _static_blocks(cfg)
    fn = cell_decode_kernel_sharded if kernel else cell_decode_plain
    return fn(planes.key, starts=starts, widths=widths, r=cfg.r, F=cfg.F)


def _rank(ident, tot, k: int):
    """Top-k of candidate (identity, total) rows given in ascending identity
    order, dead ones with total <= 0: a stable sort on -total leaves ties
    ascending. Returns ([k] int64 identities, -1 padded; [k] int32
    totals, 0 padded)."""
    keep = tot > 0
    ident, tot = ident[keep], tot[keep].to(torch.int64)
    order = torch.sort(-tot, stable=True).indices[:k]
    n = order.shape[0]
    out_i = torch.full((k,), EMPTY, dtype=torch.int64, device=tot.device)
    out_w = torch.zeros(k, dtype=torch.int32, device=tot.device)
    out_i[:n] = ident[order]
    out_w[:n] = tot[order].to(torch.int32)
    return out_i, out_w


def segment_topk(cols, w, k: int):
    """Aggregate rows by identity and take the top-k totals.

    cols: tuple of one or two int32 [N] identity columns (most significant
    first); dead rows carry negatives in every column. w: [N] int32.
    Returns (tuple of [k] int32 identity columns, [k] int32 totals):
    descending total, ties ascending identity, (-1, 0) padding.

    Dead rows weigh nothing in the reference, so they are dropped before
    any sort (most cells of a plane are empty). Totals are the reference's
    int32 arithmetic: one identity column sums its rows with wrap (its
    scatter-add); two columns sort the rows by (src, dst) and take each
    run's total as the wrapping running sum minus the running max of run
    bases (its cumsum / cummax: the plain run sum while the running sum
    neither wraps nor falls)."""
    live = cols[0] >= 0
    if len(cols) == 2 and bool((live != (cols[1] >= 0)).any()):
        raise ValueError("edge rows must be live or dead in both columns")
    cols = [c[live].to(torch.int64) for c in cols]
    w = w[live].to(torch.int64)
    if len(cols) == 1:
        uniq, inv = torch.unique(cols[0], sorted=True, return_inverse=True)
        tot = _wrap32(torch.zeros_like(uniq).index_add_(0, inv, w))
        ids, out_w = _rank(uniq, tot, k)
        return (ids.to(torch.int32),), out_w
    ident, order = torch.sort((cols[0] << 32) | cols[1], stable=True)
    sw = w[order]
    cs = _wrap32(torch.cumsum(sw, 0))
    neq = ident[1:] != ident[:-1]
    one = torch.ones(1, dtype=torch.bool, device=w.device)
    start, end = torch.cat([one, neq]), torch.cat([neq, one])
    base = torch.where(start, _wrap32(cs - sw), 0)
    total = _wrap32(cs - torch.cummax(base, 0).values)
    ids, out_w = _rank(ident, torch.where(end, total, 0), k)
    src = torch.where(ids >= 0, ids >> 32, EMPTY)
    dst = torch.where(ids >= 0, ids & 0xFFFFFFFF, EMPTY)
    return (src.to(torch.int32), dst.to(torch.int32)), out_w


def _flatten_rows(vids, planes: QueryPlanes, col: int):
    """(identity, weight) rows over all shards: each shard's matrix cells
    then its pool entries; a pool entry is live where its total is > 0."""
    S = planes.cw.shape[0]
    pid = torch.where(planes.pool_cw > 0, planes.pool_key[:, :, col], EMPTY)
    ident = torch.cat([vids.reshape(S, -1), pid], dim=1).reshape(-1)
    w = torch.cat([planes.cw.reshape(S, -1), planes.pool_cw],
                  dim=1).reshape(-1)
    return ident, w


def _gathered(arrs, group):
    """Each of ``arrs`` concatenated over the ranks of ``group`` in rank
    order (one ``all_gather`` each), or as they are when ``group`` is
    None."""
    if group is None:
        return arrs
    n = dist.get_world_size(group)
    out = []
    for a in arrs:
        parts = [torch.empty_like(a) for _ in range(n)]
        dist.all_gather(parts, a.contiguous(), group=group)
        out.append(torch.cat(parts))
    return out


def _rows(planes: QueryPlanes, sl: slice) -> QueryPlanes:
    return QueryPlanes(*(getattr(planes, f)[sl] for f in (
        "key", "cw", "pw", "pool_key", "pool_cw", "pool_pw")))


def _by_group(planes: QueryPlanes, owners, groups, rank, group=None):
    """``rank(planes, *owners)`` over all rows, or with ``groups`` over
    each block of rows alone, stacked on a leading [G] axis. ``rank``
    gathers its rows over ``group``, which a pooled stack never has."""
    if groups is None:
        return rank(planes, *owners)
    if group is not None:
        raise ValueError("a pooled (grouped) stack is host-resident: "
                         "group= does not apply")
    per = planes.cw.shape[0] // groups
    outs = []
    for g in range(groups):
        sl = slice(g * per, (g + 1) * per)
        outs.append(rank(_rows(planes, sl), *(o[sl] for o in owners)))
    return tuple(torch.stack(xs) for xs in zip(*outs))


def heavy_vertices_planes(cfg: LSketchConfig, planes: QueryPlanes, k: int,
                          *, direction: str = "out", kernel: bool = True,
                          groups: int | None = None, owners=None,
                          group=None):
    """Top-k (packed vid [k], weight [k]) by windowed out/in weight.
    ``owners`` (``decode_cell_owners`` of the same key plane) skips the
    decode."""
    col = 0 if direction == "out" else 1

    def rank(pl, vids):
        ident, w = _gathered(_flatten_rows(vids, pl, col), group)
        (ids,), ws = segment_topk((ident,), w, k)
        return ids, ws

    if owners is None:
        owners = decode_cell_owners(cfg, planes, kernel=kernel)
    return _by_group(planes, (owners[col],), groups, rank, group)


def heavy_edges_planes(cfg: LSketchConfig, planes: QueryPlanes, k: int, *,
                       kernel: bool = True, groups: int | None = None,
                       owners=None, group=None):
    """Top-k edges by windowed weight: (src [k], dst [k], weight [k])."""
    def rank(pl, vs, vd):
        src, w = _flatten_rows(vs, pl, 0)
        dst, _ = _flatten_rows(vd, pl, 1)
        src, dst, w = _gathered([src, dst, w], group)
        (s, t), ws = segment_topk((src, dst), w, k)
        return s, t, ws

    if owners is None:
        owners = decode_cell_owners(cfg, planes, kernel=kernel)
    return _by_group(planes, owners, groups, rank, group)


def top_labels_planes(cfg: LSketchConfig, planes: QueryPlanes, k: int, *,
                      direction: str = "out", kernel: bool = True,
                      groups: int | None = None, owners=None, group=None):
    """Top-k (vertex-label block [k], weight [k]) by windowed out/in weight
    — the decoded vid's block id is its label block."""
    col = 0 if direction == "out" else 1

    def rank(pl, vids):
        vid, w = _flatten_rows(vids, pl, col)
        # floor division keeps dead rows negative (-1 // span == -1)
        blk = torch.div(vid, 2048 * cfg.F, rounding_mode="floor")
        blk, w = _gathered([blk, w], group)
        (blocks,), ws = segment_topk((blk,), w, k)
        return blocks, ws

    if owners is None:
        owners = decode_cell_owners(cfg, planes, kernel=kernel)
    return _by_group(planes, (owners[col],), groups, rank, group)
