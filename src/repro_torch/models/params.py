"""Parameter definitions and initialisation (counterpart of
``repro.models.params``).

Every module declares its parameters as a nested dict of
``ParamDef(shape, init, scale)``; ``init_tree`` draws them from a
``torch.Generator`` directly on the target device, in the dict's order.
``ParamTree`` holds a drawn (or carried-over) tree as an ``nn.Module``
whose leaves are ``nn.Parameter``s, read by name as the JAX package
reads its dicts (``params["attn"]["wq"]``). They are frozen, as serving
wants them; ``tree.requires_grad_(True)`` (what
``launch.step_fns.init_train_state`` does) makes them trainable. Weights are stored
``[in, out]`` and applied as ``x @ w``, the JAX layout. The logical
sharding axes of the JAX ``ParamDef`` wait for the sharding slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: float = 0.02


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
