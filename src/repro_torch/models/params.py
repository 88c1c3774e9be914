"""Parameter definitions and initialisation (counterpart of
``repro.models.params``).

Every module declares its parameters as a nested dict of
``ParamDef(shape, axes, init, scale)``; ``init_tree`` draws them from a
``torch.Generator`` directly on the target device, in the dict's order.
``ParamTree`` holds a drawn (or carried-over) tree as an ``nn.Module``
whose leaves are ``nn.Parameter``s, read by name as the JAX package
reads its dicts (``params["attn"]["wq"]``). They are frozen, as serving
wants them; ``tree.requires_grad_(True)`` (what
``launch.step_fns.init_train_state`` does) makes them trainable. Weights are stored
``[in, out]`` and applied as ``x @ w``, the JAX layout.

``axes`` are the reference's *logical* sharding axes, one a dimension,
resolved against a mesh by ``spec_tree``:

  TP    -> the tensor-parallel mesh axis ("model")
  FSDP  -> the fully-sharded-data-parallel axes (("data",) single-pod,
           ("pod", "data") multi-pod when fsdp_over_pod)
  None  -> replicated

A spec is the port's ``PartitionSpec``: a tuple with one entry a tensor
dimension, each None, a mesh axis name or a tuple of axis names (major to
minor). ``launch.shardings.to_named`` turns specs into placements on a
mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
from torch import nn

TP = "__tp__"
FSDP = "__fsdp__"


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Any, ...]  # logical axes, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} for shape {self.shape}")


def init_one(d: ParamDef, generator: torch.Generator, dtype, device):
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    if d.init == "scaled":  # fan-in scaled normal
        fan_in = d.shape[0] if len(d.shape) > 1 else 1
        x.div_(max(1.0, fan_in ** 0.5))
    else:
        x.mul_(d.scale)
    return x.to(dtype)


def init_tree(defs: dict, generator: torch.Generator, dtype, device) -> dict:
    return {name: init_tree(d, generator, dtype, device)
            if isinstance(d, dict) else init_one(d, generator, dtype, device)
            for name, d in defs.items()}


def spec_tree(defs: dict, fsdp_axes=("data",), tp_axis="model") -> dict:
    """The specs of a def tree, in its shape: TP -> ``tp_axis``, FSDP ->
    ``fsdp_axes`` (one name alone, None when empty: serving replicates the
    weights over data). The port unstacks the reference's scanned body, so
    there is no leading layer axis to prepend."""
    def resolve(ax):
        if ax == TP:
            return tp_axis
        if ax == FSDP:
            if not fsdp_axes:
                return None
            return tuple(fsdp_axes) if len(fsdp_axes) > 1 else fsdp_axes[0]
        return ax

    return {name: spec_tree(d, fsdp_axes, tp_axis) if isinstance(d, dict)
            else tuple(resolve(a) for a in d.axes)
            for name, d in defs.items()}


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dicts become child
    ``ParamTree``s, tensors frozen parameters (``requires_grad_(True)``
    thaws them); ``tree[name]`` reads either."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)
