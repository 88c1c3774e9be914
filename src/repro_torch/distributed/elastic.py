"""Elastic scaling: re-derive the mesh and reshard state across resizes
(counterpart of ``repro.distributed.elastic``).

A checkpoint saved under mesh A restores under mesh B because the trainer
stores full leaves (``launch/train.py`` gathers them on every rank and
rank 0 writes them) and cuts them for the mesh it restores under
(``launch.step_fns.shard_state``). This module supplies the pieces around
that:

  * ``plan_mesh(n_chips)`` — factor an arbitrary healthy-chip count into
    the (data, model) grid closest to the configured aspect ratio (the
    reference's rule, copied);
  * ``make_elastic_mesh`` — the ``("data", "model")`` ``DeviceMesh`` of
    ``plan_mesh(n_chips)`` over the ranks of this process's group;
  * ``resharding_specs`` — the train state's placements on a new mesh
    (``launch.step_fns.state_placements``; the reference returns
    ``NamedSharding``s);
  * ``ElasticController`` — decides shrink/grow from the health sweep;
  * ``remesh`` — the sequence drain -> checkpoint -> remesh -> restore.
    A ``torch.distributed`` group cannot change its size in place, so a
    segment of training runs in a group of its own: ``train`` ends it
    with a blocking save of the full leaves and a barrier, its ranks
    leave and destroy the group (``distributed.ranks.spawn_ranks``), and
    ``remesh`` starts the next segment in a new group at the event's
    world and mesh with ``train(resume=True, mesh=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


def plan_mesh(n_chips: int, model_max: int = 16,
              prefer_model: int = 16) -> Tuple[int, int]:
    """(data, model) factorization of n_chips; model <= model_max and
    divides n_chips; prefer the largest model extent <= prefer_model."""
    best = (n_chips, 1)
    for m in range(min(model_max, prefer_model), 0, -1):
        if n_chips % m == 0:
            best = (n_chips // m, m)
            break
    return best


def make_elastic_mesh(n_chips: int, device_type=None):
    """The ``("data", "model")`` mesh of ``plan_mesh(n_chips)`` over the
    first ``n_chips`` ranks of this process's group (``device_type``:
    "cuda" unless the caller names the CPU)."""
    from repro_torch.launch.mesh import make_smoke_mesh

    data, model = plan_mesh(n_chips)
    return make_smoke_mesh(data, model, device_type)


def resharding_specs(cfg, opt_cfg, mesh):
    """The train state's placements on ``mesh`` (a ``DeviceMesh`` or an
    ``AbstractMesh``)."""
    # imported lazily: launch.step_fns pulls the model stack
    from repro_torch.launch.step_fns import state_placements

    return state_placements(cfg, opt_cfg, mesh)


@dataclasses.dataclass
class ElasticEvent:
    kind: str  # "shrink" | "grow" | "steady"
    n_chips: int
    mesh_shape: Tuple[int, int]


class ElasticController:
    """Chooses the mesh for the current healthy-host set."""

    def __init__(self, chips_per_host: int = 4, min_chips: int = 2):
        self.chips_per_host = chips_per_host
        self.min_chips = min_chips
        self.current: Tuple[int, int] | None = None

    def evaluate(self, healthy_hosts: List[str]) -> ElasticEvent:
        n = max(self.min_chips, len(healthy_hosts) * self.chips_per_host)
        shape = plan_mesh(n)
        if self.current is None or shape == self.current:
            kind = "steady"
        elif shape[0] * shape[1] < self.current[0] * self.current[1]:
            kind = "shrink"
        else:
            kind = "grow"
        self.current = shape
        return ElasticEvent(kind=kind, n_chips=n, mesh_shape=shape)


def _segment_rank(shape: Tuple[int, int], device_type: str, kw: dict):
    """One rank of a segment: its mesh over the new group, then ``train``
    resumed from the newest checkpoint; returns the segment's losses."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import train

    return train(**kw, resume=True,
                 mesh=make_smoke_mesh(*shape, device_type=device_type))


def remesh(event: ElasticEvent, ckpt_dir, steps: int, device=None,
           **train_kw) -> list:
    """Run the next training segment, up to ``steps``, at ``event``'s mesh:
    ``event.n_chips`` new ranks (NCCL one card a rank unless the caller
    passes ``device="cpu"``, then gloo) resume from the newest checkpoint in ``ckpt_dir`` (saved at any
    mesh, or unsharded) and end with a blocking save there; returns the
    segment's losses. ``train_kw`` are ``launch.train.train``'s other
    arguments, the same for every segment of a run (the seed, the
    batch, ``schedule_steps`` fixed across segments for an exact
    resume)."""
    from repro_torch.core.types import resolve_device
    from repro_torch.distributed.ranks import spawn_ranks

    data, model = event.mesh_shape
    if data * model != event.n_chips:
        raise ValueError(f"mesh {event.mesh_shape} for {event.n_chips} "
                         f"chips")
    dev = resolve_device(device)
    kw = dict(train_kw, steps=steps, ckpt_dir=str(ckpt_dir),
              device=dev.type)
    return spawn_ranks(_segment_rank, event.n_chips, device=dev,
                       args=((data, model), dev.type, kw))
