"""LSketch addressing, window index, the sequential reference insert and
the object API (port of ``repro.core.lsketch``).

``precompute`` and ``edge_probes`` are vectorized over any batch shape
(``[B]`` or a shard-stacked ``[S, B]``). ``advance_window``,
``_insert_loop`` and ``insert_window_batch`` are the one-subwindow
sequential reference; they update the state in place, like every write
path of the port. ``insert_batch`` delegates to the engine's single-shard
entry. ``OneShardObject`` is what the objects share (a live 1-shard
handle); ``LSketch`` is the stateful object, its query methods attached in
``queries.py`` and ``analytics.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.engine.window import WindowRing

from . import hashing as hsh
from .types import EdgeBatch, LSketchConfig, LSketchState, init_state


class VertexAddressing(NamedTuple):
    """Everything Algorithm 1 (Precompute) derives for one endpoint."""

    m: torch.Tensor  # block index
    start: torch.Tensor  # block start row/col
    width: torch.Tensor  # block width
    s: torch.Tensor  # initial address s(v) in [0, width)
    f: torch.Tensor  # fingerprint f(v) in [0, F)
    offs: torch.Tensor  # candidate offsets l_1..l_r  [..., r]
    vid: torch.Tensor  # packed (m, s, f) sketch-side vertex identity


def precompute(cfg: LSketchConfig, v, label) -> VertexAddressing:
    """Paper Algorithm 1, vectorized over any batch shape."""
    v = torch.as_tensor(v).to(torch.int32)
    label = torch.as_tensor(label).to(torch.int32)
    starts, widths = cfg.block_start_width(v.device)
    m = hsh.vertex_label_block(label, cfg.n_blocks, cfg.seed)
    start, width = starts[m.long()], widths[m.long()]
    h = hsh.hash31(v, cfg.seed)
    s, f = hsh.fingerprint_split(h, cfg.F, width)
    offs = hsh.candidate_offsets(f, cfg.r)
    vid = hsh.pack_vertex_id(m, s, f, cfg.F)
    return VertexAddressing(m, start, width, s, f, offs, vid)


class EdgeProbes(NamedTuple):
    rows: torch.Tensor  # [..., s] absolute matrix rows
    cols: torch.Tensor  # [..., s] absolute matrix cols
    keys: torch.Tensor  # [..., s] packed candidate keys
    pid_src: torch.Tensor  # packed pool id of the source
    pid_dst: torch.Tensor  # packed pool id of the destination


def edge_probes(cfg: LSketchConfig, pa: VertexAddressing,
                pb: VertexAddressing) -> EdgeProbes:
    """The s sampled probe cells + keys for an edge (paper Eq. 3/4)."""
    ai, bi = hsh.sample_pairs(pa.f, pb.f, cfg.r, cfg.s)  # [..., s]
    off_a = torch.gather(pa.offs, -1, ai.long())
    off_b = torch.gather(pb.offs, -1, bi.long())
    p1 = torch.remainder(pa.s[..., None] + off_a, pa.width[..., None])
    p2 = torch.remainder(pb.s[..., None] + off_b, pb.width[..., None])
    rows = (pa.start[..., None] + p1).to(torch.int32)
    cols = (pb.start[..., None] + p2).to(torch.int32)
    keys = hsh.pack_key(ai, bi, pa.f[..., None], pb.f[..., None], cfg.F)
    return EdgeProbes(rows, cols, keys, pa.vid, pb.vid)


def window_index(cfg: LSketchConfig, t) -> torch.Tensor:
    t = torch.as_tensor(t).to(torch.int32)
    return torch.div(t, cfg.subwindow_size,
                     rounding_mode="floor").to(torch.int32)


def valid_slot_mask(cfg: LSketchConfig, state: LSketchState,
                    last: int | None = None):
    """Boolean [..., k]: ring slots inside the window (optionally only the
    most recent ``last`` subwindows)."""
    return WindowRing.for_config(cfg).valid_mask(
        state.slot_widx, state.cur_widx, last)


def advance_window(cfg: LSketchConfig, state: LSketchState, widx):
    """Claim the ring slot for scalar subwindow ``widx`` of one (unstacked)
    state and zero its counter planes on reuse, in place.
    Returns (state, slot, live)."""
    ring = WindowRing.for_config(cfg)
    claim = ring.claim(state.slot_widx, state.cur_widx, widx)
    if bool(claim.reset):
        j = int(claim.slot)
        for arr, axis in ((state.C, 3), (state.P, 3), (state.pool_C, 1),
                          (state.pool_P, 1)):
            arr.select(axis, j).zero_()
    state.slot_widx.copy_(claim.slot_widx)
    state.cur_widx.copy_(claim.cur_widx)
    return state, claim.slot, claim.live


def _insert_loop(cfg: LSketchConfig, state: LSketchState, slot, live,
                 probes: EdgeProbes, le_idx, weight) -> LSketchState:
    """Sequential first-fit insertion of a pre-addressed one-subwindow batch
    into one (unstacked) state, in place. The stream-order walk itself is
    ``engine.insert._scan_insert`` (this is its one-ring-slot case)."""
    from repro_torch.engine.insert import _scan_insert

    w = weight.to(state.C.dtype) * live.to(state.C.dtype)
    stacked = state.map(lambda x: x[None])
    one = lambda x: x[None]
    _scan_insert(cfg, stacked, EdgeProbes(*[one(p) for p in probes]),
                 one(le_idx), torch.full_like(one(le_idx), int(slot)),
                 one(w), one(w), torch.ones_like(one(w), dtype=torch.bool))
    return state


def insert_window_batch(cfg: LSketchConfig, state: LSketchState,
                        batch: EdgeBatch, widx) -> LSketchState:
    """Insert a batch of items that all belong to subwindow ``widx`` into
    one plain state, in place: the sequential stream-order reference."""
    dev = state.key.device
    col = lambda f: torch.from_numpy(  # noqa: E731
        np.asarray(getattr(batch, f), np.int32)).to(dev)
    pa = precompute(cfg, col("src"), col("src_label"))
    pb = precompute(cfg, col("dst"), col("dst_label"))
    probes = edge_probes(cfg, pa, pb)
    le_idx = hsh.edge_label_bucket(col("edge_label"), cfg.c, cfg.seed)
    state, slot, live = advance_window(cfg, state, int(widx))
    return _insert_loop(cfg, state, slot, live, probes, le_idx,
                        col("weight").to(state.C.dtype))


def insert_batch(cfg: LSketchConfig, state: LSketchState, batch: EdgeBatch,
                 path: str = "auto") -> LSketchState:
    """Insert a time-ordered batch into one plain state (any number of
    subwindows), in place: ``engine.insert.insert_batch``."""
    from repro_torch.engine.insert import insert_batch as _engine_insert
    return _engine_insert(cfg, state, batch, path=path)


# --------------------------------------------------------------------------
# object API
# --------------------------------------------------------------------------

class OneShardObject:
    """What the objects (``LSketch``, ``GSS``, ``LGS``) share: a live
    1-shard handle of the ``repro_torch.sketch`` layer. ``.state`` reads as
    the plain state (views of shard 0) and can be assigned; ``insert``
    goes through ``ingest_single`` in place and starts a new handle (the
    old one is spent), so the window planes that scalar queries read are
    built once per horizon between inserts."""

    kind: str

    @classmethod
    def _spec(cls, cfg):
        from repro_torch.sketch.spec import SketchSpec
        return SketchSpec(kind=cls.kind, config=cfg, n_shards=1)

    @property
    def spec(self):
        return self._spec(self.cfg)

    @property
    def handle(self):
        """The live 1-shard ``ShardedState`` (its plane cache is the
        object's)."""
        return self._handle

    @property
    def state(self):
        return self._handle.live().map(lambda x: x[0])

    @state.setter
    def state(self, state) -> None:
        from repro_torch.sketch.state import ShardedState
        self._handle = ShardedState.lift(state)

    @property
    def device(self) -> torch.device:
        return self._handle.device

    @classmethod
    def from_numpy(cls, cfg, arrays, device=None, **kw):
        """An object over a plain state given as arrays in
        ``jax.tree.leaves`` order of the reference's state."""
        from repro_torch.sketch.state import from_numpy
        return cls(cfg, state=from_numpy(cls._spec(cfg), arrays, device,
                                         plain=True), **kw)

    def insert(self, src, dst, src_label=None, dst_label=None,
               edge_label=None, weight=None, time=None):
        if len(np.asarray(src)) == 0:  # an empty batch is a no-op
            return self
        from repro_torch.sketch.ingest import ingest_single
        batch = EdgeBatch.from_arrays(src, dst, src_label, dst_label,
                                      edge_label, weight, time)
        old = self._handle
        self.state = ingest_single(self.spec, self.state, batch,
                                   path=getattr(self, "insert_path", "auto"))
        old.spent = True
        return self


class LSketch(OneShardObject):
    """The LSketch object (its query methods are attached in
    ``queries.py`` and ``analytics.py``).

    >>> sk = LSketch(LSketchConfig(d=64, n_blocks=2), device="cpu")
    >>> sk.insert(src, dst, src_label, dst_label, edge_label, weight, time)
    >>> sk.edge_weight(a, la, b, lb)
    """

    kind = "lsketch"

    def __init__(self, cfg: LSketchConfig, state: LSketchState | None = None,
                 insert_path: str = "auto", query_path: str = "auto",
                 device=None):
        self.cfg = cfg
        self.insert_path = insert_path
        self.query_path = query_path
        self.state = state if state is not None else init_state(cfg, device)
