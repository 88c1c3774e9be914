"""Mesh construction (counterpart of ``repro.launch.mesh``).

A mesh here is anything with axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and
``size(i)``), or an ``AbstractMesh`` of names and sizes alone, which the
sharding rules read as the reference reads ``jax.sharding.AbstractMesh``:
one box cannot build a 256-rank ``DeviceMesh``, and the rules need none.

Mesh shapes:
  single pod : (16, 16)     axes ("data", "model")   — 256 chips
  multi pod  : (2, 16, 16)  axes ("pod", "data", "model") — 512 chips

Batch shards over ("pod", "data"); params FSDP over "data" (+"pod" when
``fsdp_over_pod``) composed with TP/EP over "model".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names, with no devices behind them."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.axis_sizes} for axes "
                             f"{self.axis_names}")


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(mesh.axis_names if names is None else names)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` in mesh order, of either kind of mesh."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    return {n: mesh.size(i) for i, n in enumerate(axis_names(mesh))}


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def mesh_axes(mesh) -> dict:
    multi = "pod" in axis_names(mesh)
    return {
        "dp": ("pod", "data") if multi else ("data",),
        "fsdp": ("data",),
        "fsdp_pod": ("pod", "data") if multi else ("data",),
        "tp": "model",
        "multi_pod": multi,
    }


def smoke_shape(data: int, model: int, world: int) -> Tuple[int, int]:
    """``(data, model)`` clamped to ``world`` ranks as the reference clamps
    to ``jax.devices()``."""
    data = min(data, world)
    model = max(1, min(model, world // max(1, data)))
    return data, model


def make_smoke_mesh(data: int = 1, model: int = 1, device_type=None):
    """A ``("data", "model")`` mesh over the ranks of this process's group
    (a ``DeviceMesh`` of the first ``data x model`` ranks, rank-major, on
    ``device_type``: "cuda" unless the caller names the CPU), the shape
    clamped to the world; with no group up, an ``AbstractMesh`` clamped to
    one rank."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    data, model = smoke_shape(data, model, world)
    if not dist.is_initialized():
        return AbstractMesh((data, model), ("data", "model"))
    return DeviceMesh(device_type or "cuda",
                      torch.arange(data * model).view(data, model),
                      mesh_dim_names=("data", "model"))
