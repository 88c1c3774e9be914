"""Logical activation-sharding context (counterpart of
``repro.distributed.sharding_ctx``).

Model code calls ``constrain(x, "dp", None, "tp", ...)`` with *logical*
axis names; the launcher installs the mesh resolution once
(``use_sharding_ctx(mesh)``). Outside a context the calls are no-ops.

Logical axes:
  "dp"   -> the data-parallel axes (("pod","data") multi-pod, ("data",))
  "tp"   -> "model"
  "fsdp" -> ("data",)  (weight-sharding axis for manual constraints)
  "sp"   -> "model"    (sequence-parallel option)
  "ep"   -> "model"    (the MoE's experts)
  "dpx"  -> every mesh axis (batch over the whole mesh)
  None   -> unsharded

Divisibility guard: any axis whose size doesn't divide the corresponding
mesh extent degrades to None rather than erroring — the same constraint
code serves every (arch x shape x mesh) cell.

A resolved spec is a tuple with one entry a tensor dimension: None, a mesh
axis name, or a tuple of names (major to minor). In torch terms it is one
placement a mesh dimension (``to_placements``): ``Shard(d)`` where tensor
dimension d names that axis, else ``Replicate()``; a dimension over
("pod", "data") takes ``Shard(d)`` on both, in mesh order, which DTensor
splits major to minor as JAX does. ``from_placements`` is the inverse.

The port runs SPMD, one process a rank: every activation is a plain local
tensor, and ``constrain`` returns a plain tensor unchanged. Only a
``DTensor`` is redistributed, to the placements its logical axes resolve
to. The collectives that the reference's global-array semantics hide are
explicit here: ``dp_sum`` (a global sum of per-rank partials), the MoE's
expert exchange and the tensor-parallel pairs below.

Tensor parallelism over "model" (Megatron's layout without sequence
parallelism). A data rank holds its rows of the batch; the residual
stream between layers is the same on every rank of a model row. Inside a
layer the ranks split the work where the sharded train step hands them
the layer's parameters by model shard (``ctx.params_source``, which
``launch.step_fns.make_sharded_train_step`` installs; ``tp_split`` is
then the model size, else 1 and every layer computes whole): a column-parallel
block starts with ``tp_copy`` (identity forward, the gradient summed over
the model ranks backward) and a row-parallel one ends with ``tp_sum``
(the ranks' partial outputs summed forward, identity backward);
``tp_gather`` joins the ranks' blocks of rows of the sequence-parallel
fallback (all-gather forward, this rank's block backward). All three are
identities outside a context or at one model rank. A contraction over
channels split over "model" whose sum every rank then uses in its own
way (the recurrent mixers' projections out of their channel blocks) is
``tp_copy(tp_sum(x))``, so that its gradient is summed over the ranks in
turn.

Serving installs the same parameter source (``launch.step_fns``'s
sharded prefill and serve steps, forward only). Its caches rest sharded
as the reference's cache rules place them; where the batch does not
divide the data ranks (``long_500k``: one sequence) a cache's sequence
axis splits over "data" instead (context parallelism), and attention over
it combines the ranks' softmax parts with ``cp_attend``.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_names, mesh_shape

_STATE = threading.local()


def current():
    """The installed ``ShardingCtx``, or None."""
    return getattr(_STATE, "ctx", None)


class ShardingCtx:
    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        # the sharded train step's per-layer parameters (``open_params``)
        self.params_source = None
        multi = "pod" in self.shape
        self.logical = {
            "dp": ("pod", "data") if multi else ("data",),
            "fsdp": ("data",),
            "tp": ("model",),
            "sp": ("model",),
            "ep": ("model",),
            # full flattening: batch over every mesh axis (attention
            # fallback when heads don't divide the model axis)
            "dpx": (("pod", "data", "model") if multi
                    else ("data", "model")),
        }

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def resolve(self, logical, shape) -> tuple:
        """Left-to-right greedy: each logical name claims its mesh axes only
        if the dim divides; claimed axes can't be reused. "sp" placed after
        "tp" therefore acts as an automatic fallback — e.g. attention score
        [B, H, Lq, Lk] with constrain(s, "dp", "tp", "sp", None): when H
        divides the model axis it takes it (head parallelism); when it
        doesn't (smollm's 9 heads on a 16-way axis), Lq takes it instead
        (sequence parallelism) rather than replicating the quadratic."""
        spec = []
        used = set()
        for dim, name in zip(shape, logical):
            if name is None:
                spec.append(None)
                continue
            axes = tuple(a for a in self.logical[name] if a not in used)
            if not axes:
                spec.append(None)
                continue
            n = self.axis_size(axes)
            if dim % n == 0 and dim >= n:
                spec.append(axes if len(axes) > 1 else axes[0])
                used.update(axes)
            else:
                spec.append(None)
        return tuple(spec)

    # ---- the ranks behind a DeviceMesh ------------------------------------

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.logical["dp"])

    def group(self, axis: str):
        """The process group of this rank's line along mesh ``axis``."""
        return self.mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along mesh ``axis``."""
        return self.mesh.get_coordinate()[axis_names(self.mesh).index(axis)]

    @property
    def tp_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def tp_rank(self) -> int:
        return self.coordinate("model") if self.tp_size > 1 else 0

    def model_group(self):
        """The process group of this rank's model row."""
        return self.group("model")

    def dp_group(self):
        axes = self.logical["dp"]
        if len(axes) != 1:
            raise NotImplementedError(f"a collective over {axes}: the "
                                      f"trainer's meshes have one data axis")
        return self.group(axes[0])


@contextlib.contextmanager
def use_sharding_ctx(mesh):
    prev = current()
    _STATE.ctx = ShardingCtx(mesh)
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def constrain(x, *logical):
    """Apply a logical sharding constraint: a no-op outside a context and
    on a plain (local) tensor; a ``DTensor`` is redistributed to the
    resolved placements."""
    ctx = current()
    if ctx is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"{len(logical)} logical axes for shape "
                         f"{tuple(x.shape)}")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = ctx.resolve(logical, x.shape)
    return x.redistribute(x.device_mesh, to_placements(spec, ctx.mesh))


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec, mesh) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` a mesh dimension for ``spec``.
    Raises ``ValueError`` for an axis named twice or a tuple out of mesh
    order (DTensor splits in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    dim_of = {}
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"{spec}: axes {axes} out of mesh order "
                             f"{names}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"{spec}: axis {a!r} named twice")
            dim_of[a] = d
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in names)


def from_placements(placements, mesh, ndim: int) -> tuple:
    """The spec that ``placements`` on ``mesh`` realise for an ``ndim``-dim
    tensor (the inverse of ``to_placements``)."""
    from torch.distributed.tensor import Shard

    axes = [[] for _ in range(ndim)]
    for name, p in zip(axis_names(mesh), placements):
        if isinstance(p, Shard):
            axes[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in axes)


def local_slice(full: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` (DTensor's
    ``torch.chunk`` split, mesh dimensions in order, major to minor)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out = torch.chunk(out, mesh.size(i), dim=p.dim)[coord[i]]
    return out


class _DpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the data-parallel ranks of each rank's partial ``x``
    (identity outside a context or at one data rank). Its gradient goes to
    this rank's partial unchanged: every rank computes the same global
    loss from the sum, so the ranks' gradients, summed over ``dp`` by the
    train step, are the global loss's."""
    ctx = current()
    if ctx is None or ctx.dp_size == 1:
        return x
    return _DpSum.apply(x, ctx.dp_group())


# ---------------------------------------------------------------------------
# tensor parallelism over "model"
# ---------------------------------------------------------------------------

def tp_split() -> int:
    """The number of model ranks a layer splits its compute over: the
    context's model size when the sharded train step hands the layers
    their parameters by model shard, else 1."""
    ctx = current()
    if ctx is None or ctx.params_source is None:
        return 1
    return ctx.tp_size


def tp_rank() -> int:
    """This rank's index in its model row (0 when ``tp_split`` is 1)."""
    return current().tp_rank if tp_split() > 1 else 0


@contextlib.contextmanager
def open_params(tree, uses=None, keys=None):
    """A layer's parameters for the length of its forward: ``tree`` itself
    outside the sharded train step; under it, a nested dict of the
    tensors the step hands over (``uses``: ``{dotted name: "split" |
    "partial"}`` relative to ``tree``, the rest "full"; ``keys``: the
    top-level names to open, all when None)."""
    ctx = current()
    if ctx is None or ctx.params_source is None:
        yield tree
        return
    with ctx.params_source.open(tree, uses or {}, keys) as opened:
        yield opened


class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _TpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, index, group):
        ctx.dim, ctx.n, ctx.index = dim, n, index
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.n, ctx.dim)[ctx.index].contiguous(), None, None,
                None, None)


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """Enter a split block (Megatron's f): ``x`` as it is; its gradient is
    summed over the model ranks, each of which computed a part."""
    if tp_split() == 1:
        return x
    return _TpCopy.apply(x, current().model_group())


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """Leave a split block (Megatron's g): the sum of the model ranks'
    partial ``x``; the gradient goes to each rank's part unchanged."""
    if tp_split() == 1:
        return x
    return _TpSum.apply(x, current().model_group())


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' blocks of ``x`` joined along ``dim`` in rank order;
    each rank's gradient is its own block of the joined gradient."""
    n = tp_split()
    if n == 1:
        return x
    ctx = current()
    return _TpGather.apply(x, dim, n, ctx.tp_rank, ctx.model_group())


# ---------------------------------------------------------------------------
# context parallelism over "data" (serving only)
# ---------------------------------------------------------------------------

def cp_attend(s: torch.Tensor, attend):
    """Softmax attention over a sequence split over the data ranks, forward
    only: ``s`` this rank's masked scores ``[..., S_local]``, ``attend(e)``
    the weighted sum of this rank's values by weights ``e [..., S_local]``
    (a tensor ``[..., E]``). The ranks' largest score (all-reduce max),
    then their weight sums and weighted sums (one all-reduce) give the
    softmax-weighted sum over the whole sequence. The slot just written
    is live on its rank, so the largest score is a real one and a rank
    with no live slot adds zeros."""
    group = current().group("data")
    m = s.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(s - m)
    o = attend(e)
    lead = o.shape[:-1]
    packed = torch.cat([o.reshape(-1), e.sum(dim=-1).reshape(-1)])
    dist.all_reduce(packed, group=group)
    o = packed[:o.numel()].view(o.shape)
    return o / packed[o.numel():].view(*lead, 1)
