"""Sketch configuration, sketch state and the device rule of the port.

The state is a plain dataclass of int32 tensors with the reference's leaf
names and shapes (``repro.core.types``). Unlike the JAX pytree it is
mutable: ingest updates its tensors in place (the port's counterpart of
buffer donation), so a full-width state is never copied per flush.

Layout (one shard; the handle layer stacks a leading ``[S]`` axis):
  key      [d, d, 2]        packed (i_r, i_c, f(A), f(B)) or EMPTY
  C        [d, d, 2, k]     per-subwindow total weights
  P        [d, d, 2, k, c]  per-subwindow per-edge-label weights
  pool_key [Q, 2]           overflow-table keys (packed endpoint ids)
  pool_C   [Q, k]
  pool_P   [Q, k, c]
  pool_lost []              weight lost to pool saturation
  slot_widx [k]             logical subwindow index held by each ring slot
  cur_widx  []              most recent subwindow index seen
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

EMPTY = -1  # sentinel for unoccupied key slots (matrix and pool)
IDX_RADIX = 16  # fixed radix for packing the (i_r, i_c) candidate-index pair
NEVER = -(2**30)  # sentinel "this ring slot has never been filled"

LEAVES = ("key", "C", "P", "pool_key", "pool_C", "pool_P", "pool_lost",
          "slot_widx", "cur_widx")


def resolve_device(device=None) -> torch.device:
    """The port's device rule: the card unless the caller names the CPU.

    ``None`` means ``"cuda"``; asking for CUDA without a card raises — an
    entry point never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclass(frozen=True)
class LSketchConfig:
    """Static configuration of an LSketch (same fields, defaults and checks
    as ``repro.core.types.LSketchConfig``; see there for the meaning of
    each parameter)."""

    d: int = 256
    F: int = 1024
    r: int = 8
    s: int = 8
    c: int = 8
    k: int = 4
    window_size: int = 0
    pool_capacity: int = 4096
    pool_probes: int = 16
    n_blocks: int = 4
    block_bounds: Tuple[Tuple[int, int], ...] | None = None
    seed: int = 1234
    count_dtype: Any = torch.int32

    def __post_init__(self):
        if self.F > 2048:
            raise ValueError("F must be <= 2048 for int32 key packing")
        if self.r > IDX_RADIX:
            raise ValueError(f"r must be <= {IDX_RADIX}")
        if self.s > self.r * self.r:
            raise ValueError("s must be <= r*r")
        if self.block_bounds is None and self.d % self.n_blocks != 0:
            raise ValueError("uniform blocking requires n_blocks | d")
        if self.block_bounds is not None:
            for start, width in self.block_bounds:
                if start < 0 or width <= 0 or start + width > self.d:
                    raise ValueError(f"bad block bound {(start, width)}")

    @property
    def b(self) -> int:
        return self.d // self.n_blocks

    @property
    def subwindow_size(self) -> int:
        if self.window_size == 0:
            return 2**30  # effectively eternal
        return max(1, self.window_size // self.k)

    @property
    def effective_k(self) -> int:
        return 1 if self.window_size == 0 else self.k

    def block_start_width(self, device="cpu"):
        """(starts, widths) int32 tensors of length n_blocks."""
        if self.block_bounds is not None:
            starts = [s for s, _ in self.block_bounds]
            widths = [w for _, w in self.block_bounds]
        else:
            starts = [i * self.b for i in range(self.n_blocks)]
            widths = [self.b] * self.n_blocks
        return (torch.tensor(starts, dtype=torch.int32, device=device),
                torch.tensor(widths, dtype=torch.int32, device=device))

    def replace(self, **kw) -> "LSketchConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class LSketchState:
    """Sketch state: int32 tensors, updated in place by ingest."""

    key: torch.Tensor
    C: torch.Tensor
    P: torch.Tensor
    pool_key: torch.Tensor
    pool_C: torch.Tensor
    pool_P: torch.Tensor
    pool_lost: torch.Tensor
    slot_widx: torch.Tensor
    cur_widx: torch.Tensor

    def leaves(self):
        return [getattr(self, f) for f in LEAVES]

    def map(self, fn) -> "LSketchState":
        return LSketchState(*[fn(x) for x in self.leaves()])


def init_leaves(cfg: LSketchConfig, lead: Tuple[int, ...], device
                ) -> LSketchState:
    """Fresh all-empty state with extra leading dims ``lead`` on every leaf
    (``()`` for one shard, ``(S,)`` for a stack) allocated directly on
    ``device``."""
    d, k, c, q = cfg.d, cfg.effective_k, cfg.c, cfg.pool_capacity
    ct = cfg.count_dtype
    dev = torch.device(device)

    def full(shape, value, dtype=torch.int32):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)

    return LSketchState(
        key=full((d, d, 2), EMPTY),
        C=full((d, d, 2, k), 0, ct),
        P=full((d, d, 2, k, c), 0, ct),
        pool_key=full((q, 2), EMPTY),
        pool_C=full((q, k), 0, ct),
        pool_P=full((q, k, c), 0, ct),
        pool_lost=full((), 0, ct),
        slot_widx=full((k,), NEVER),
        cur_widx=full((), NEVER),
    )


def init_state(cfg: LSketchConfig, device=None) -> LSketchState:
    return init_leaves(cfg, (), resolve_device(device))


def state_bytes(cfg: LSketchConfig) -> int:
    """Configured storage budget of one shard in bytes (the sub-linear
    knob): every leaf's elements times its item size, allocated nowhere."""
    return sum(x.numel() * x.element_size()
               for x in init_leaves(cfg, (), "meta").leaves())


@dataclass
class EdgeBatch:
    """A time-ordered batch of stream items e = (A,B; lA,lB,le; w; t) as
    host int32 numpy arrays (the ingest partition runs on the host)."""

    src: np.ndarray
    dst: np.ndarray
    src_label: np.ndarray
    dst_label: np.ndarray
    edge_label: np.ndarray
    weight: np.ndarray
    time: np.ndarray

    def __len__(self):
        return int(self.src.shape[0])

    @classmethod
    def from_arrays(cls, src, dst, src_label=None, dst_label=None,
                    edge_label=None, weight=None, time=None) -> "EdgeBatch":
        """Absent labels and times default to 0, absent weights to 1."""
        src = np.asarray(src, np.int32)
        n = src.shape[0]
        z = np.zeros(n, np.int32)

        def col(x, default):
            return default if x is None else np.asarray(x, np.int32)

        return cls(src=src, dst=np.asarray(dst, np.int32),
                   src_label=col(src_label, z), dst_label=col(dst_label, z),
                   edge_label=col(edge_label, z),
                   weight=col(weight, np.ones(n, np.int32)),
                   time=col(time, z))

    def slice(self, a: int, b: int) -> "EdgeBatch":
        return EdgeBatch(*[getattr(self, f.name)[a:b]
                           for f in dataclasses.fields(self)])
