"""SketchSpec — the static identity of a (possibly sharded) sketch, and the
host hash partition (port of ``repro.sketch.spec``).

Kinds: ``"lsketch"`` and ``"gss"`` (the degenerate LSketch of
``core.gss.gss_config``) take an ``LSketchConfig``, ``"lgs"`` an
``LGSConfig``. A spec may carry a ``routing.RoutingTable`` of hot-key
splits: host-only state, left out of equality and hash, carried in
``to_json`` (the JSON is the reference's, key for key, so a spec written
by either package reads back in the other).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core.gss import gss_config
from repro_torch.core.lgs import LGSConfig
from repro_torch.core.types import LSketchConfig

KINDS = ("lsketch", "lgs", "gss")

# seed perturbation for the shard-routing hash
_SHARD_SALT = 0x51AD


@dataclass(frozen=True)
class SketchSpec:
    """kind, config and shard count of a sketch (frozen, hashable).

    ``routing`` is an optional ``routing.RoutingTable``: it changes which
    shard an edge lands on, never what the card computes, so two specs
    that differ only in routing compare and hash equal (plane caches and
    pooled dispatches keep serving after a split)."""

    kind: str
    config: Any
    n_shards: int = 1
    routing: Any = field(default=None, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        want = LGSConfig if self.kind == "lgs" else LSketchConfig
        if not isinstance(self.config, want):
            raise TypeError(f"{self.kind} spec requires a {want.__name__}, "
                            f"got {type(self.config).__name__}")
        if self.routing is not None and not hasattr(self.routing, "splits"):
            raise TypeError(f"routing must be a RoutingTable or None, "
                            f"got {type(self.routing).__name__}")

    @property
    def seed(self) -> int:
        return self.config.seed

    def replace(self, **kw) -> "SketchSpec":
        return dataclasses.replace(self, **kw)

    def with_splits(self, entries) -> "SketchSpec":
        """The spec with ``(src, src_label, n_replicas)`` split entries
        merged into its routing table; equal to this one (routing is
        not part of the identity)."""
        from .routing import RoutingTable
        base = self.routing if self.routing is not None else RoutingTable()
        return self.replace(routing=base.merged(entries))

    def compatible(self, other: "SketchSpec") -> bool:
        """Same sketch identity up to the shard count."""
        return self.kind == other.kind and self.config == other.config

    def to_json(self) -> dict:
        """The checkpoint manifest's spec entry (the reference's keys)."""
        if self.kind == "lgs":
            cfg = {"d": self.config.d, "copies": self.config.copies,
                   "c": self.config.c, "k": self.config.k,
                   "window_size": self.config.window_size,
                   "seed": self.config.seed}
        else:
            cfg = dataclasses.asdict(self.config)
            cfg["count_dtype"] = str(self.config.count_dtype).split(".")[-1]
            if cfg["block_bounds"] is not None:
                cfg["block_bounds"] = [list(b) for b in cfg["block_bounds"]]
        out = {"kind": self.kind, "n_shards": self.n_shards, "config": cfg}
        if self.routing:
            out["routing"] = self.routing.to_json()
        return out

    @classmethod
    def from_json(cls, d: dict) -> "SketchSpec":
        cfg = dict(d["config"])
        routing = None
        if d.get("routing") is not None:
            from .routing import RoutingTable
            routing = RoutingTable.from_json(d["routing"])
        if d["kind"] == "lgs":
            config = LGSConfig(**cfg)
        else:
            cfg["count_dtype"] = getattr(torch, cfg["count_dtype"])
            if cfg.get("block_bounds") is not None:
                cfg["block_bounds"] = tuple(tuple(b)
                                            for b in cfg["block_bounds"])
            config = LSketchConfig(**cfg)
        return cls(kind=d["kind"], config=config, n_shards=int(d["n_shards"]),
                   routing=routing)


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


def shard_assignment_vids(spec: SketchSpec, vids) -> np.ndarray:
    """Shard of every packed source vertex identity (the key-space routing
    of the reference's ``reshard``), salted apart from the ingest hash."""
    vids = np.asarray(vids, np.int64)
    if spec.n_shards == 1:
        return np.zeros(vids.shape, np.int32)
    mixed = vids.astype(np.uint32) * np.uint32(2654435761)
    h = _hash31_np(mixed, spec.seed ^ _SHARD_SALT ^ 0x7E5)
    return (h % np.int32(spec.n_shards)).astype(np.int32)


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
