"""Sharding assignment for inputs, caches, and train state (counterpart of
``repro.launch.shardings``).

Rules:
  * token batches shard over dp = ("pod","data");
  * params/opt-state: FSDP over "data" (+"pod" for >=100B when
    fsdp_over_pod) x TP over "model" — built from the ParamDef logical axes;
  * decode caches: batch over dp when divisible; otherwise *context
    parallelism* — the cache sequence axis shards over "data" (the
    long_500k cell: one sequence spread over the pod); head/feature axes
    take "model" when divisible.

Specs are tuples (``distributed.sharding_ctx``); trees are dicts and lists
with spec tuples, ``(shape, dtype)`` stand-ins or tensors at the leaves.
``to_named`` turns a spec tree into placements on a mesh, as the
reference's makes ``NamedSharding``s; ``cache_shardings`` and
``decode_input_shardings`` give placements.
"""

from __future__ import annotations

import math

from repro_torch.configs.shapes import ShapeCell
from repro_torch.distributed.sharding_ctx import spec_axes, to_placements
from repro_torch.models.config import ModelConfig

from .mesh import mesh_axes, mesh_shape


def _axis_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in spec_axes(axes))


def batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh) -> dict:
    dp = mesh_axes(mesh)["dp"]
    dp_ok = cell.global_batch % _axis_size(mesh, dp) == 0
    bspec = dp if dp_ok else None
    spec = {"tokens": (bspec, None), "labels": (bspec, None)}
    if cfg.frontend == "vision":
        spec["prefix_emb"] = (bspec, None, None)
    if cfg.is_encdec:
        spec["frame_emb"] = (bspec, None, None)
    return spec


# per-leaf cache sharding templates keyed by cache-dict field name:
# which axis may take "model" (head/state axes only — NEVER a contraction
# axis like MLA's kv_lora rank or an attention feature dim: sharding those
# turns every decode step into per-layer cache all-gathers), and which
# axis is the sequence (context-parallel fallback for batch=1).
_CACHE_RULES = {
    # name: (seq_axis | None, model_axis | None)
    "k": (1, 2), "v": (1, 2),          # [B, S, KV, dh]
    "ckv": (1, None), "krope": (1, None),  # [B, S, r] — replicate over model
    "conv": (None, 2),                 # [B, kc-1, di]
    "ssm": (None, 1),                  # [B, di, ds]
    "C": (None, 1), "n": (None, 1),    # mLSTM [B, H, dh(, dh)]
    "c": (None, 1), "h": (None, 1),    # sLSTM [B, di]
    "pos": (None, None),
}


def cache_seq_axis(name: str):
    """The sequence axis of a cache leaf by its name, or None."""
    return _CACHE_RULES.get(name, (None, None))[0]


def _cache_leaf_spec(name, shape, mesh) -> tuple:
    ax = mesh_axes(mesh)
    dp, tp = ax["dp"], ax["tp"]
    dp_n = _axis_size(mesh, dp)
    tp_n = _axis_size(mesh, tp)
    data_n = _axis_size(mesh, ("data",))
    if len(shape) == 0:
        return ()
    seq_ax, model_ax = _CACHE_RULES.get(name, (None, None))
    spec = [None] * len(shape)
    if shape[0] % dp_n == 0 and shape[0] >= dp_n:
        spec[0] = dp
    elif seq_ax is not None and shape[seq_ax] % data_n == 0:
        # batch unshardable (long_500k): context-parallel over the sequence
        spec[seq_ax] = "data"
    if model_ax is not None and model_ax < len(shape) and \
            shape[model_ax] % tp_n == 0 and shape[model_ax] >= tp_n and \
            spec[model_ax] is None:
        spec[model_ax] = tp
    return tuple(spec)


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's, or a ``(shape, dtype)`` stand-in's."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(leaf[0])


def cache_shardings(cache_specs, mesh):
    """Placements of every leaf of per-layer caches (``[{"mixer": {name:
    leaf}}]``), by the leaf's name."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return to_placements(_cache_leaf_spec(name, _shape(tree), mesh),
                             mesh)

    return walk(cache_specs)


def decode_input_shardings(cfg: ModelConfig, cell: ShapeCell, specs,
                           mesh) -> dict:
    dp = mesh_axes(mesh)["dp"]
    dp_ok = cell.global_batch % _axis_size(mesh, dp) == 0
    out = {
        "tokens": to_placements((dp if dp_ok else None, None), mesh),
        "caches": cache_shardings(specs["caches"], mesh),
    }
    if "memory" in specs:
        out["memory"] = to_placements((dp if dp_ok else None, None, None),
                                      mesh)
    return out


def to_named(tree, mesh):
    """Every spec of ``tree`` as its placements on ``mesh``."""
    if isinstance(tree, dict):
        return {k: to_named(v, mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_named(v, mesh) for v in tree]
    if hasattr(tree, "_fields"):  # a NamedTuple of trees (TrainState)
        return type(tree)(*[to_named(v, mesh) for v in tree])
    return to_placements(tree, mesh)


def sanitize_specs(spec_tree, shape_tree, mesh):
    """Drop sharding on any tensor axis whose size doesn't divide its mesh
    extent (e.g. seamless-m4t's 256206-token vocab on a 16-way model axis).
    ``shape_tree``: the same structure, tensors or ``(shape, dtype)``
    stand-ins at the leaves."""
    if isinstance(spec_tree, dict):
        return {k: sanitize_specs(v, shape_tree[k], mesh)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list) or hasattr(spec_tree, "_fields"):
        out = [sanitize_specs(s, t, mesh)
               for s, t in zip(spec_tree, shape_tree)]
        return out if isinstance(spec_tree, list) else type(spec_tree)(*out)
    shape = _shape(shape_tree)
    out = []
    for i, ax in enumerate(spec_tree):
        if ax is None or i >= len(shape):
            out.append(None if i >= len(shape) else ax)
            continue
        n = _axis_size(mesh, ax)
        out.append(ax if (shape[i] % n == 0 and shape[i] >= n) else None)
    return tuple(out)
