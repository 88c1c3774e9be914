"""GSS baseline (port of ``repro.core.gss``): the homogeneous competitor as
the degenerate LSketch — one storage block, one edge-label bucket, no
sliding window. It rides the LSketch engine and kernels unchanged: every
GSS batch is one subwindow (its times are normalized to 0), so on the
card it always takes the kernel route, in a single bin of the one block.
"""

from __future__ import annotations

import numpy as np

from .lsketch import LSketch
from .types import LSketchConfig


def gss_config(d: int = 256, F: int = 1024, r: int = 8, s: int = 8,
               pool_capacity: int = 4096, seed: int = 1234) -> LSketchConfig:
    return LSketchConfig(d=d, F=F, r=r, s=s, c=1, k=1, window_size=0,
                         pool_capacity=pool_capacity, n_blocks=1, seed=seed)


class GSS(LSketch):
    """Homogeneous graph-stream sketch: labels and timestamps are ignored."""

    kind = "gss"

    def __init__(self, cfg: LSketchConfig | None = None, state=None,
                 device=None, **kw):
        super().__init__(cfg if cfg is not None else gss_config(**kw),
                         state=state, device=device)

    def insert(self, src, dst, src_label=None, dst_label=None,
               edge_label=None, weight=None, time=None):
        zero = np.zeros(len(np.asarray(src)), np.int32)
        return super().insert(src, dst, zero, zero, zero, weight, zero)

    def edge_weight(self, a, la, b, lb, le=None, last=None):
        return super().edge_weight(a, 0, b, 0, le=None, last=None)

    def vertex_weight(self, v, lv, le=None, direction="out", last=None):
        return super().vertex_weight(v, 0, le=None, direction=direction,
                                     last=None)

    def reachable(self, a, la, b, lb, max_hops=64):
        return super().reachable(a, 0, b, 0, max_hops)
