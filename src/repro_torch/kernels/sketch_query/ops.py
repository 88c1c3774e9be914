"""Batched edge queries on window-reduced planes (port of
``repro/kernels/sketch_query/ops.py``: ``edge_query_planes`` and the
single-sketch drop-in ``edge_query_pallas``): the addressing, the probe
walk and the pool lookup, in one launch of the fused kernel on the card
(``kernel.py::edge_query_kernel``) or its plain version on the CPU."""

from __future__ import annotations

import torch

from repro_torch.core.queries import build_query_planes
from repro_torch.core.types import LSketchConfig, LSketchState

from .kernel import edge_query_kernel


def edge_query_planes(cfg: LSketchConfig, planes, src, dst, labels,
                      with_le: bool = True):
    """src/dst: int32 [B]; labels: (lA, lB, le) int32 [B] each (``le`` is
    ignored without ``with_le``). On ``QueryPlanes`` returns (w, w_label),
    each [S, B] per-shard partials; the caller sums over the shard axis.
    On horizon-stacked ``MultiPlanes`` (5-dim ``cw``, as the reference
    accepts) every horizon is answered by the same launch and the outputs
    come back [H, B], already summed over the shards (int32 wrap)."""
    la, lb, le = labels
    w, wl = edge_query_kernel(cfg, planes, src, la, dst, lb,
                              le if with_le else None)  # [H, S, B]
    if planes.cw.dim() == 4:
        return w[0], wl[0]
    return tuple(x.sum(1, dtype=torch.int64).to(torch.int32)
                 for x in (w, wl))


def _as_i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32).to(device).contiguous()


def edge_query_pallas(cfg: LSketchConfig, state: LSketchState, src, dst,
                      labels, last: int | None = None):
    """Kernel-backed equivalent of ``core.queries.edge_query`` with the
    edge label (both outputs, int32 [B]) on one plain state: the window
    planes of a ``[1, ...]`` view, then the edge-probe kernel at S = 1.
    The name is the reference's."""
    dev = state.key.device
    planes = build_query_planes(cfg, state.map(lambda x: x.unsqueeze(0)),
                                last)
    w, wl = edge_query_planes(cfg, planes, _as_i32(src, dev),
                              _as_i32(dst, dev),
                              tuple(_as_i32(x, dev) for x in labels),
                              with_le=True)
    return w[0], wl[0]
