"""SketchSpec — the static identity of a (possibly sharded) sketch, and the
host hash partition (port of ``repro.sketch.spec`` without routing).

Kinds: ``"lsketch"`` and ``"gss"`` (the degenerate LSketch of
``core.gss.gss_config``) take an ``LSketchConfig``, ``"lgs"`` an
``LGSConfig``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.core.gss import gss_config
from repro_torch.core.lgs import LGSConfig
from repro_torch.core.types import LSketchConfig

KINDS = ("lsketch", "lgs", "gss")

# seed perturbation for the shard-routing hash
_SHARD_SALT = 0x51AD


@dataclass(frozen=True)
class SketchSpec:
    """kind, config and shard count of a sketch (frozen, hashable)."""

    kind: str
    config: Any
    n_shards: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        want = LGSConfig if self.kind == "lgs" else LSketchConfig
        if not isinstance(self.config, want):
            raise TypeError(f"{self.kind} spec requires a {want.__name__}, "
                            f"got {type(self.config).__name__}")

    @property
    def seed(self) -> int:
        return self.config.seed

    def replace(self, **kw) -> "SketchSpec":
        return dataclasses.replace(self, **kw)


def make_spec(kind: str, n_shards: int = 1, config: Any = None,
              **config_kw) -> SketchSpec:
    """Build a spec from a kind plus either a ready config or config kwargs."""
    if config is None:
        if kind == "lgs":
            config = LGSConfig(**config_kw)
        elif kind == "gss":
            config = gss_config(**config_kw)
        else:
            config = LSketchConfig(**config_kw)
    elif config_kw:
        raise ValueError("pass either config= or config kwargs, not both")
    return SketchSpec(kind=kind, config=config, n_shards=n_shards)


def _hash31_np(x: np.ndarray, seed: int) -> np.ndarray:
    """Host twin of ``core.hashing.hash31`` (murmur3 finalizer, uint32)."""
    h = x.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return (h & np.uint32(0x7FFFFFFF)).astype(np.int32)


def shard_assignment(spec: SketchSpec, src, src_label=None) -> np.ndarray:
    """Shard id of every edge: ``hash31(mix(src, src_label)) % n_shards``,
    routed by the source endpoint entity (pure numpy)."""
    src = np.asarray(src, np.int64)
    lab = np.zeros_like(src) if src_label is None else np.asarray(src_label,
                                                                  np.int64)
    if spec.n_shards == 1:
        return np.zeros(src.shape, np.int32)
    mixed = (src.astype(np.uint32) * np.uint32(2654435761)) ^ \
        (lab.astype(np.uint32) << np.uint32(9))
    h = _hash31_np(mixed, spec.seed ^ _SHARD_SALT)
    return (h % np.int32(spec.n_shards)).astype(np.int32)
