"""The cell estimator (counterpart of ``repro.launch.dryrun``): one record
a (arch x shape cell x mesh) without running the step on a device.

The reference lowers and compiles each cell on 256 or 512 fake XLA
devices and reads XLA's memory analysis, the HLO's dot FLOPs and its
collective bytes. Torch has no HLO, so the port runs its own step once
on ``meta`` tensors (shapes and dtypes, no storage, no arithmetic) as
rank 0 of the mesh sees it, and counts as it goes:

  * memory: every storage an op creates is live from that op until its
    last tensor dies (weak references); ``peak_bytes`` is the state that
    rests on the device (the local shards of the parameters and AdamW's
    moments by ``step_fns.state_placements``, the batch rows; serving:
    the parameters' and caches' shards) plus the peak of the live bytes
    over the step — the counterpart of ``memory_analysis()``. It is split
    into parameters, gradients, moments, the gathered copies (a train
    step over one model rank: every sharded parameter whole; over several,
    and in a serving cell: the most bytes of layers' copies live at once,
    measured), the gradients before their slice (one model
    rank: the whole tree; several: the largest layer's gathered copies, as
    the backward reduces and slices a layer's gradients as it goes), the
    saved activations of a microbatch
    (``torch.autograd.graph.saved_tensors_hooks``) and the logits;
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the whole
    step (every microbatch's forward and backward). The flash kernels
    launch nothing on meta (stand-ins take the wrappers' place in
    ``kernels/flash_attention/ops.py`` and note the call) and count by
    formula: 4 dh a kept (query, key) pair forward (causal: L (L + 1) / 2
    pairs a head, as ``chip_smoke.flash_flops``), 2.5 times that backward
    (the kernel recomputes the scores). ``attn_impl="plain"`` counts the
    plain attention's matmuls instead: the dense masked product the
    reference differentiates, the same dots as its HLO. No remat: the
    port does not rematerialise (the reference's dry run uses
    ``dots+moe``), so nothing is counted twice but the flash backward's
    scores;
  * bytes accessed: each non-view aten op reads its tensor inputs and
    writes its outputs once (eager PyTorch fuses nothing), plus the flash
    kernels' q, k, v, out and lse (backward: and dout, dq, dk, dv);
  * collective bytes, by kind: the step's ``torch.distributed`` calls
    (the gradient sums over the data and model groups, the per-layer
    parameter gathers and their repeats in the backward, the model
    group's ``tp_copy``/``tp_sum``/``tp_gather`` and vocab-parallel loss,
    the norm's scalar, ``dp_sum``'s scalars, the MoE's all-gather over
    "model") are recorded instead of run, with this rank at coordinate 0
    of every mesh axis, at their result bytes (the reference's
    convention); a sharded parameter's ``full_tensor`` counts one
    all-gather a sharded mesh axis, the last axis first.

Per device, a train cell's step is the port's: at one rank,
``make_train_step``; over several, ``make_sharded_train_step`` with meta
shards, which over several model ranks splits the compute over "model"
(Megatron's layout: heads, MLP columns and rows, vocabulary; the "sp"
fallback; the recurrent mixers' channels). A prefill or decode cell
runs ``make_sharded_prefill_step``/``make_sharded_serve_step`` (over one
rank, ``make_prefill_step``/``make_serve_step``) on this rank's batch
rows: each layer gathered over "data" as it opens and split over
"model", the caches as their shards (context parallelism where the
batch does not divide). Whole-mesh totals (``hlo_flops``, ``hlo_bytes``,
``collective_bytes``) are the rank's times the chips, as the reference
multiplies its per-device HLO; ``useful_flops_ratio`` shows the share of
them the model needs (what a train cell's split leaves redundant, a
serving cell's whole compute).

The three-term roofline divides by the H100's rates, kept here for the
whole port. Records go to
``experiments/torch_dryrun/<arch>__<shape>__<mesh>.json``; ``--table``
writes the roofline table (the reference's ``benchmarks/roofline.py``)
as ``experiments/torch_dryrun/roofline.csv``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh pod [--skip-existing]
  python -m repro_torch.launch.dryrun --table
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import functools
import json
import math
import sys
import time
import traceback
import weakref
from collections import defaultdict
from pathlib import Path

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as configs
from repro_torch.configs.shapes import SHAPES_BY_NAME, ShapeCell, skip_reason
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import shardings as shd
from repro_torch.launch import step_fns
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import (axis_names, make_production_mesh,
                                     mesh_axes, mesh_shape, mesh_size)
from repro_torch.models import lm
from repro_torch.models.layers import vocab_split
from repro_torch.models.moe import TELEMETRY_BUCKETS
from repro_torch.optim import AdamWConfig

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "torch_dryrun"

# NVIDIA H100 SXM5, published peaks (chip_smoke.py reads these)
HBM_BYTES_PER_S = 3.35e12  # HBM3
BF16_FLOPS_PER_S = 989e12  # dense tensor-core bf16
TF32_FLOPS_PER_S = 495e12  # dense tensor-core TF32
F32_FLOPS_PER_S = 67e12  # f32 outside the tensor cores (SIMT FMAs)
# NVLink 4: 900 GB/s a GPU, both directions together (H100 SXM5
# datasheet); one direction's 450 GB/s carries a collective's result.
# A 16 x 16 mesh spans 32 eight-GPU hosts, whose links are slower: the
# collective term is a lower bound there.
NVLINK_BYTES_PER_S = 450e9
# the flash kernels' f32 variant splits each operand into two TF32 terms
# and runs three MMAs a product
SPLIT_TF32_PASSES = 3
FLASH_BACKWARD_RATIO = 2.5

_PKG = str(Path(__file__).resolve().parents[1])  # src/repro_torch
_HERE = str(Path(__file__).resolve())
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}  # allocate, write nothing


def _dryrun_model_cfg(arch: str):
    """A full config for estimating: bf16 parameters and compute, as the
    reference's; no remat (the port has none)."""
    cfg = configs.get(arch)
    return cfg.replace(param_dtype=torch.bfloat16,
                       compute_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# where a cost comes from
# ---------------------------------------------------------------------------

_SOURCES: dict = {}


def _source() -> str:
    """``module:function`` of the innermost frame of the port (not this
    module) on the Python stack; "launch.dryrun:gather" for what the
    estimator's own gathers of a serving cell make."""
    f = sys._getframe(1)
    here = False
    while f is not None:
        code = f.f_code
        key = _SOURCES.get(code)
        if key is None:
            name = code.co_filename
            key = "" if (not name.startswith(_PKG) or name == _HERE) else \
                f"{name[len(_PKG) + 1:-3].replace('/', '.')}:{code.co_name}"
            _SOURCES[code] = key
        if key:
            return key
        here = here or code.co_filename == _HERE
        f = f.f_back
    return "launch.dryrun:gather" if here else "other"


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tagger(TorchFunctionMode):
    """Names each autograd node by the port's function that made it (the
    output's node and the untagged nodes behind it: a call such as
    ``matmul`` makes several), so that the backward's ops count where
    their forward was written."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            todo = [t.grad_fn for t in _tensors(out)]
            key = None
            while todo:
                fn = todo.pop()
                if fn is None or "source" in fn.metadata:
                    continue
                key = key or _source()
                fn.metadata["source"] = key
                todo.extend(f for f, _ in fn.next_functions)
        return out


class _Tally(TorchDispatchMode):
    """Live bytes (storages by their last tensor; at the peak, by the
    source that made them), FLOPs (through the enclosing
    ``FlopCounterMode``'s running total), bytes accessed and their
    sources, for every aten op of the step."""

    def __init__(self, flops: FlopCounterMode, static: set):
        super().__init__()
        self.flops = flops
        self.static = static  # storages of the resting state
        self.live: dict = {}  # storage -> (bytes, source)
        self.refs: dict = {}
        self.cur = self.peak = 0
        self.live_by = defaultdict(int)
        self.peak_by: dict = {}
        self.flops_by_dtype = defaultdict(int)
        self.by_source = defaultdict(lambda: defaultdict(int))
        self.bytes_accessed = 0
        self.gathered_keys: set = set()  # the train step's gathered copies
        self.gathered_cur = self.gathered_peak = 0

    def mark_gathered(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage (live) as a gathered parameter copy."""
        key = t.untyped_storage()._cdata
        if key in self.live and key not in self.gathered_keys:
            self.gathered_keys.add(key)
            self.gathered_cur += self.live[key][0]
            self.gathered_peak = max(self.gathered_peak, self.gathered_cur)

    def _release(self, key) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            n, src = self.live.pop(key)
            self.cur -= n
            self.live_by[src] -= n
            if key in self.gathered_keys:
                self.gathered_keys.discard(key)
                self.gathered_cur -= n

    def track(self, t: torch.Tensor, src: str) -> None:
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.static:
            return
        if key not in self.live:
            self.live[key] = (st.nbytes(), src)
            self.refs[key] = 0
            self.cur += st.nbytes()
            self.live_by[src] += st.nbytes()
            if self.cur > self.peak:
                self.peak = self.cur
                self.peak_by = {k: v for k, v in self.live_by.items() if v}
        self.refs[key] += 1
        weakref.finalize(t, self._release, key)

    def source(self) -> str:
        node = torch._C._current_autograd_node()
        if node is not None:
            return node.metadata.get("source", "other") + " (backward)"
        return _source()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        src = self.source()
        if name == "bincount" and args[0].device.type == "meta":
            out = self._meta_bincount(*args, **kwargs)
        else:
            before = self.flops.get_total_flops()
            out = func(*args, **kwargs)
            n = self.flops.get_total_flops() - before
            if n:
                self.flops_by_dtype[next(_tensors(args)).dtype] += n
                self.by_source[src]["flops"] += n
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if not func.is_view and name not in _NO_TRAFFIC:
            moved = sum(_nbytes(t) for t in ins + outs)
            self.bytes_accessed += moved
            self.by_source[src]["bytes_accessed"] += moved
        in_ids = {id(t) for t in ins}
        for t in outs:
            if id(t) not in in_ids:  # an in-place op hands back its input
                self.track(t, src)
        return out

    @staticmethod
    def _meta_bincount(x, weights=None, minlength=0):
        # data-dependent length: the callers pass values below minlength
        dtype = torch.int64 if weights is None else weights.dtype
        return torch.empty((minlength,), dtype=dtype, device="meta")


class _MetaMesh:
    """Rank 0's view of an ``AbstractMesh`` for the step code: its axis
    names and sizes, coordinate 0 on every axis, an axis name as its
    group."""

    def __init__(self, mesh):
        self.mesh_dim_names = axis_names(mesh)
        self._sizes = tuple(mesh_shape(mesh).values())
        self.ndim = len(self._sizes)

    def size(self, i: int) -> int:
        return self._sizes[i]

    def get_coordinate(self):
        return [0] * self.ndim

    def get_group(self, axis):
        return axis


class _Collectives:
    """Records the step's collectives (kind, result bytes, source) in
    place of running them."""

    def __init__(self):
        self.calls = []

    def record(self, kind: str, nbytes: int, source: str | None = None):
        self.calls.append((kind, nbytes, source or _source()))

    def all_reduce(self, tensor, op=None, group=None, async_op=False):
        self.record("all-reduce", _nbytes(tensor))

    def all_gather(self, tensor_list, tensor, group=None, async_op=False):
        self.record("all-gather", sum(_nbytes(t) for t in tensor_list))

    def by_kind(self) -> dict:
        out = defaultdict(int)
        for kind, n, _ in self.calls:
            out[kind] += n
        out["total"] = sum(n for _, n, _ in self.calls)
        return dict(out)

    @contextlib.contextmanager
    def patched(self, world: int):
        """``torch.distributed``'s calls of the step recorded instead of
        run, in a world of ``world`` ranks."""
        saved = {n: getattr(dist, n) for n in ("all_reduce", "all_gather",
                                              "get_world_size")}
        dist.all_reduce, dist.all_gather = self.all_reduce, self.all_gather
        dist.get_world_size = lambda group=None: world
        try:
            yield self
        finally:
            for n, fn in saved.items():
                setattr(dist, n, fn)


def _shard_shape(shape, placements, mesh) -> tuple:
    """A tensor's local shape under ``placements``."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def _sharded_axes(placements, mesh, keep_dim=None) -> list:
    """The mesh axes, last first, over which a gather moves data: those
    that shard a dimension other than ``keep_dim`` over more than one
    rank."""
    from torch.distributed.tensor import Shard

    return [i for i in reversed(range(len(placements)))
            if isinstance(placements[i], Shard)
            and placements[i].dim != keep_dim and mesh.size(i) > 1]


def _gather(t, full_shape, placements, mesh, log: _Collectives, source: str,
            keep_dim=None):
    """``t`` (a local shard) whole over every sharded mesh axis but
    ``keep_dim``'s: one all-gather a sharded axis, the last axis first,
    each at its result bytes; a new meta tensor, or ``t`` when nothing is
    sharded."""
    axes = _sharded_axes(placements, mesh, keep_dim)
    if not axes:
        return t
    shape = list(t.shape)
    for i in axes:
        shape[placements[i].dim] *= mesh.size(i)
        log.record("all-gather", math.prod(shape) * t.element_size(), source)
    want = list(full_shape)
    if keep_dim is not None:
        want[keep_dim] = t.shape[keep_dim]
    assert shape == want, (shape, want)
    return torch.empty(shape, dtype=t.dtype, device="meta")


class _MetaLeaves:
    """``make_sharded_train_step``'s leaves on meta: local shards, whole
    again through ``_gather`` (their storages noted in ``gathered``)."""

    def __init__(self, placements: dict, shapes: dict, mesh, log,
                 gathered: set):
        self.pl, self.shapes, self.mesh, self.log = placements, shapes, \
            mesh, log
        self.gathered_set = gathered

    def full(self, name, leaf):
        out = _gather(leaf, self.shapes[name][0], self.pl[name], self.mesh,
                      self.log, "parameter gather")
        if out is not leaf:
            self.gathered_set.add(out.untyped_storage()._cdata)
        return out

    @staticmethod
    def local(leaf):
        return leaf

    def placements(self, name, leaf):
        return self.pl[name]


class _MetaGathers(step_fns._LayerGathers):
    """The split step's parameter source on meta (``_gathers``): each
    layer's gathered copies, and those the backward gathers again, go to
    the tally and to ``notes["largest_open"]`` (the most bytes one layer
    opened); a tensor saved for the backward that is no gathered copy goes
    on to the estimator's own pack hook, which this source's hooks replace
    while the step runs. ``notes`` holds ``tally`` and ``pack``, filled by
    ``estimate``."""

    def __init__(self, notes: dict, *args):
        super().__init__(*args)
        self.notes = notes
        notes.setdefault("largest_open", 0)

    def _note(self, ts) -> None:
        self.notes["largest_open"] = max(self.notes["largest_open"],
                                         sum(_nbytes(t) for t in ts))
        for t in ts:
            self.notes["tally"].mark_gathered(t)

    @contextlib.contextmanager
    def open(self, tree, uses: dict, keys=None):
        with super().open(tree, uses, keys) as opened:
            self._note([t for t in _tensors(opened)
                        if t.untyped_storage()._cdata in self.live])
            yield opened

    def pack(self, t):
        out = super().pack(t)
        return out if isinstance(out, step_fns._Regather) else \
            self.notes["pack"](t)

    def unpack(self, obj):
        out = super().unpack(obj)
        if isinstance(obj, step_fns._Regather):
            self._note([out])
        return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _spec_tensors(spec, rows=None):
    """Meta tensors for a tree of ``(shape, dtype)`` stand-ins (``rows``:
    the leading dimension cut to this rank's rows)."""
    if isinstance(spec, dict):
        return {k: _spec_tensors(v, rows) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_spec_tensors(v, rows) for v in spec]
    shape, dtype = spec
    if rows is not None and len(shape):
        shape = (rows,) + tuple(shape[1:])
    return _meta(shape, dtype)


def _local_rows(cell, mesh) -> int:
    """The batch rows of one rank: the global batch over the data axes
    when it divides them (``shardings.batch_specs``), else all of it."""
    dp = math.prod(mesh_shape(mesh)[a] for a in mesh_axes(mesh)["dp"])
    return cell.global_batch // dp if cell.global_batch % dp == 0 \
        else cell.global_batch


@contextlib.contextmanager
def _flash_stand_ins():
    """The flash wrappers that ``kernels/flash_attention/ops.py`` calls,
    swapped for meta stand-ins: each allocates its outputs, launches
    nothing and notes the call as ("forward" | "backward", q's shape, k's
    shape, causal, dtype, q_offset) in the list it yields."""
    calls = []

    def forward(q, k, v, causal=True, lse=False, q_offset=0):
        calls.append(("forward", tuple(q.shape), tuple(k.shape),
                      bool(causal), q.dtype, q_offset))
        out = torch.empty_like(q)
        if not lse:
            return out
        return out, _meta(q.shape[:3], torch.float32)

    def backward(q, k, v, out, lse, dout, causal=True, q_offset=0):
        calls.append(("backward", tuple(q.shape), tuple(k.shape),
                      bool(causal), q.dtype, q_offset))
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = _meta(q.shape[:3], torch.float32)  # noqa: F841 the
        return grads  # kernel's scratch, live until it returns

    saved = (flash_ops.flash_attention_kernel,
             flash_ops.flash_attention_backward_kernel)
    flash_ops.flash_attention_kernel = forward
    flash_ops.flash_attention_backward_kernel = backward
    try:
        yield calls
    finally:
        (flash_ops.flash_attention_kernel,
         flash_ops.flash_attention_backward_kernel) = saved


def causal_pairs(Lq: int, Lk: int, q_offset: int = 0) -> int:
    """The (query, key) pairs a causal call keeps: row i (at absolute
    position ``q_offset + i``) keeps keys 0 .. min(q_offset + i, Lk - 1)."""
    full = max(0, min(Lq, Lk - q_offset))  # rows short of the last key
    pairs = full * q_offset + full * (full + 1) // 2
    return pairs + (Lq - full) * Lk


def _flash_costs(calls) -> tuple:
    """(flops by dtype, forward flops, bytes) of the flash calls noted on
    meta."""
    flops, forward, moved = defaultdict(int), 0, 0
    for kind, (B, Hq, Lq, dh), (_, Hkv, Lk, _), causal, dtype, off in calls:
        pairs = causal_pairs(Lq, Lk, off) if causal else Lq * Lk
        f = 4 * dh * B * Hq * pairs
        q = B * Hq * Lq * dh * dtype.itemsize
        kv = B * Hkv * Lk * dh * dtype.itemsize
        rows = B * Hq * Lq * 4  # lse, D: f32 a query row
        if kind == "forward":  # q, k, v in; out, lse out
            flops[dtype] += f
            forward += f
            moved += 2 * q + 2 * kv + rows
        else:  # q, k, v, out, dout, lse in; dq, dk, dv, D out and D in
            flops[dtype] += int(FLASH_BACKWARD_RATIO * f)
            moved += 4 * q + 4 * kv + 3 * rows
    return dict(flops), forward, moved


def _flop_rate(dtype, flash: bool) -> float:
    """The card's rate for a product in ``dtype``: bf16 on the tensor
    cores; f32 in the flash kernels as split-TF32, elsewhere on the SIMT
    cores (the port's f32 runs keep TF32 off)."""
    if dtype in (torch.bfloat16, torch.float16):
        return BF16_FLOPS_PER_S
    return TF32_FLOPS_PER_S / SPLIT_TF32_PASSES if flash else \
        F32_FLOPS_PER_S


# ---------------------------------------------------------------------------
# the estimate
# ---------------------------------------------------------------------------

def _tree_bytes(shapes: dict, numel=None) -> int:
    """Bytes of ``{name: (shape, dtype)}`` (``numel``: other element
    counts by name)."""
    return sum((numel[k] if numel else math.prod(s)) * d.itemsize
               for k, (s, d) in shapes.items())


def _train_cell(cfg, cell, mesh, microbatches, opt_cfg, log, gathered,
                notes):
    """(step thunk, resting tensors, split, rows, whether the step splits
    over "model") of a train cell on rank 0 of ``mesh``; the split step's
    notes go to ``notes`` (``_MetaGathers``)."""
    shapes = lm.param_shapes(cfg)
    rows = _local_rows(cell, mesh)
    batch = _spec_tensors(input_specs(cfg, cell), rows)
    split_step = False
    if mesh_size(mesh) == 1:
        params = lm.params_from_leaves(
            cfg, {k: _meta(s, d) for k, (s, d) in shapes.items()})
        state = step_fns._zero_state(cfg, opt_cfg, params)
        step = step_fns.make_train_step(cfg, opt_cfg, microbatches)
        local = {k: s for k, (s, _) in shapes.items()}
    else:
        pl = step_fns.state_placements(cfg, opt_cfg, mesh)
        mm = _MetaMesh(mesh)
        local = {k: _shard_shape(s, pl.params[k], mm)
                 for k, (s, _) in shapes.items()}
        mdt = opt_cfg.moment_dtype
        state = step_fns.TrainState(
            params=lm.params_from_leaves(
                cfg, {k: _meta(local[k], d) for k, (_, d) in shapes.items()}),
            opt={"mu": {k: _meta(s, mdt) for k, s in local.items()},
                 "nu": {k: _meta(s, mdt) for k, s in local.items()},
                 "step": _meta((), torch.int32)},
            telemetry=_meta((TELEMETRY_BUCKETS, max(cfg.n_experts, 1)),
                            torch.int32),
            step=_meta((), torch.int32))
        step = step_fns.make_sharded_train_step(
            cfg, opt_cfg, mm, microbatches,
            _leaves=_MetaLeaves(pl.params, shapes, mm, log, gathered),
            _gathers=functools.partial(_MetaGathers, notes))
        # over one model rank the gathered step: the whole tree's copy
        split_step = mesh_shape(mesh).get("model", 1) > 1
    tp = mesh_shape(mesh).get("model", 1)
    n_local = {k: math.prod(s) for k, s in local.items()}
    n_full = sum(math.prod(s) for s, _ in shapes.values())
    g_size = 4 if microbatches > 1 else cfg.param_dtype.itemsize
    split = dict(
        params=_tree_bytes(shapes, n_local),
        moments=2 * sum(n_local.values()) * opt_cfg.moment_dtype.itemsize,
        grads=sum(n_local.values()) * g_size, full_grads=n_full * g_size,
        gathered_params=sum(math.prod(s) * d.itemsize
                            for k, (s, d) in shapes.items()
                            if tuple(local[k]) != tuple(s)),
        # this rank's vocabulary block where the split step splits it
        logits=rows // microbatches * cell.seq_len * (
            cfg.vocab_size // tp if vocab_split(cfg, tp) else cfg.vocab_size)
        * cfg.compute_dtype.itemsize)
    resting = list(step_fns.state_leaves(state).values()) + \
        list(_tensors(batch))
    return (lambda: step(state, batch)), resting, split, rows, split_step


def _serve_cell(cfg, cell, mesh, log, gathered, notes):
    """(step thunk, resting tensors, split, rows) of a prefill or decode
    cell on rank 0 of ``mesh``: the parameters' and caches' shards rest.
    Over one rank the unsharded step; over several the sharded prefill or
    serve step (``step_fns.make_sharded_prefill_step``/
    ``make_sharded_serve_step``) on meta shards, each layer's parameters
    gathered as it opens (``_MetaGathers``: the copies measured) and the
    caches read and written as their shards, on this rank's rows."""
    mm = _MetaMesh(mesh)
    pshapes = lm.param_shapes(cfg)
    ppl = step_fns.param_placements(cfg, mesh)
    shards = {k: _meta(_shard_shape(s, ppl[k], mm), d)
              for k, (s, d) in pshapes.items()}
    rows = _local_rows(cell, mesh)
    specs = input_specs(cfg, cell)
    split = dict(params=sum(_nbytes(t) for t in shards.values()),
                 moments=0, grads=0, full_grads=0, caches=0,
                 gathered_params=0,
                 logits=rows * (cell.seq_len if cell.mode == "prefill"
                                else 1) * cfg.vocab_size
                 * cfg.compute_dtype.itemsize)
    one = mesh_size(mesh) == 1
    if cell.mode == "decode":
        cpl = shd.cache_shardings(specs["caches"], mesh)

        def shard_caches(spec, pl):  # leaves: (local shard, placements)
            if isinstance(spec, dict):
                return {k: shard_caches(spec[k], pl[k]) for k in spec}
            if isinstance(spec, list):
                return [shard_caches(a, b) for a, b in zip(spec, pl)]
            shape, dtype = spec
            return (_meta(_shard_shape(shape, pl, mm), dtype), pl)

        caches = shard_caches(specs["caches"], cpl)
        inputs = {"tokens": _meta((rows, 1), torch.int32)}
        if "memory" in specs:
            inputs["memory"] = _spec_tensors(specs["memory"], rows)
        cache_leaves = [t for t, _ in _cache_leaves(caches)]
        split["caches"] = sum(_nbytes(t) for t in cache_leaves)
        resting = cache_leaves + list(inputs.values())
    else:
        inputs = _spec_tensors(specs, rows)
        resting = list(_tensors(inputs))
    resting += list(shards.values())
    params = lm.params_from_leaves(cfg, shards)
    seams = dict(_leaves=_MetaLeaves(ppl, pshapes, mm, log, gathered),
                 _gathers=functools.partial(_MetaGathers, notes))

    def run():
        if cell.mode == "prefill":
            step = step_fns.make_prefill_step(cfg) if one else \
                step_fns.make_sharded_prefill_step(cfg, mm, **seams)
            return step(params, inputs)
        if one:
            local = [{"mixer": {k: t for k, (t, _) in c["mixer"].items()}}
                     for c in caches]
            return step_fns.make_serve_step(cfg)(
                params, local, inputs["tokens"], inputs.get("memory"))
        return step_fns.make_sharded_serve_step(cfg, mm, **seams)(
            params, caches, inputs["tokens"], inputs.get("memory"))

    return run, resting, split, rows


def _cache_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _cache_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _cache_leaves(v)]
    return [tree]


def estimate(cfg, cell: ShapeCell, mesh, microbatches: int = 1,
             opt_cfg: AdamWConfig | None = None) -> dict:
    """The record of one cell: ``cfg`` at ``cell`` on ``mesh`` (an
    ``AbstractMesh``; the step of its rank 0), ``microbatches`` a train
    step's gradient-accumulation blocks. See the module docstring for
    what is counted and how."""
    opt_cfg = opt_cfg or AdamWConfig()
    t0 = time.time()
    log, gathered, notes = _Collectives(), set(), {}
    split_step = False
    if cell.mode == "train":
        run, resting, split, rows, split_step = _train_cell(
            cfg, cell, mesh, microbatches, opt_cfg, log, gathered, notes)
    else:
        microbatches = 1
        run, resting, split, rows = _serve_cell(cfg, cell, mesh, log,
                                                gathered, notes)
    storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in resting}
    static = set(storages)
    saved: dict = {}
    saved_by = defaultdict(int)

    def pack(t):  # a saved tensor: its storage counts once while alive
        key = t.untyped_storage()._cdata
        if t.device.type == "meta" and key not in static \
                and key not in gathered:
            old = saved.get(key)
            if old is None or old() is None:
                saved[key] = weakref.ref(t)
                saved_by[_source()] += t.untyped_storage().nbytes()
        return t

    counter = FlopCounterMode(display=False)
    tally = _Tally(counter, static)
    notes.update(tally=tally, pack=pack)
    with log.patched(mesh_size(mesh)), _flash_stand_ins() as calls, \
            counter, tally, _Tagger(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        run()
    flash_flops, flash_forward, flash_bytes = _flash_costs(calls)
    if calls:
        flash = tally.by_source["kernels.flash_attention (formula)"]
        flash["flops"] += sum(flash_flops.values())
        flash["bytes_accessed"] += flash_bytes
    for src, n in saved_by.items():
        tally.by_source[src]["activation_bytes"] += n
    for kind, n, src in log.calls:
        tally.by_source[src]["collective_bytes"] += n

    n_chips = mesh_size(mesh)
    mm_flops = sum(tally.flops_by_dtype.values())
    dev_flops = mm_flops + sum(flash_flops.values())
    dev_bytes = tally.bytes_accessed + flash_bytes
    coll = log.by_kind()
    compute_s = sum(n / _flop_rate(dt, False)
                    for dt, n in tally.flops_by_dtype.items()) + \
        sum(n / _flop_rate(dt, True) for dt, n in flash_flops.items())
    memory_s = dev_bytes / HBM_BYTES_PER_S
    collective_s = coll["total"] / NVLINK_BYTES_PER_S
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    n_active = cfg.active_param_count()
    tokens = cell.global_batch * (cell.seq_len if cell.mode != "decode"
                                  else 1)
    model_flops = (6 if cell.mode == "train" else 2) * n_active * tokens
    flops = dev_flops * n_chips
    argument_bytes = sum(storages.values())
    peak = argument_bytes + tally.peak
    split.update(activations=sum(saved_by.values()) // microbatches,
                 peak=peak)
    if split_step:  # what the split step held, measured
        split.update(gathered_params=tally.gathered_peak,
                     full_grads=notes["largest_open"])
    elif cell.mode != "train":
        split["gathered_params"] = tally.gathered_peak
    return {
        "arch": cfg.name, "shape": cell.name,
        "mesh": "x".join(str(v) for v in mesh_shape(mesh).values()),
        "mode": cell.mode, "chips": n_chips,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "rows_per_device": rows, "microbatches": microbatches,
        "estimate_s": round(time.time() - t0, 2),
        "hlo_flops": flops, "hlo_bytes": dev_bytes * n_chips,
        "flops_per_device": {
            "matmul": mm_flops, "flash_forward": flash_forward,
            "flash_backward": sum(flash_flops.values()) - flash_forward,
            "total": dev_flops},
        "bytes_accessed_per_device": dev_bytes,
        "flash_calls": len(calls),
        "collective_bytes": {k: v * n_chips for k, v in coll.items()},
        "collective_bytes_per_device": coll,
        "memory": {"argument_bytes": argument_bytes, "output_bytes": 0,
                   "temp_bytes": tally.peak, "peak_bytes": peak},
        "memory_split": split,
        # the step's live bytes at its peak by the function that made
        # them (the resting state is argument_bytes)
        "peak_by_source": dict(sorted(tally.peak_by.items(),
                                      key=lambda kv: -kv[1])),
        "roofline": {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "model_flops": model_flops,
            "useful_flops_ratio": model_flops / flops if flops else 0.0,
        },
        "params_total": cfg.param_count(),
        "params_active": n_active,
        "dtypes": {"param": str(cfg.param_dtype),
                   "compute": str(cfg.compute_dtype)},
        "attention": ("the plain attention's matmuls" if cfg.attn_impl ==
                      "plain" else "flash kernels by formula"),
        "remat": "none: the port has none; nothing is recomputed but the "
                 "flash backward's scores",
        "sources": {k: dict(v) for k, v in tally.by_source.items()},
    }


# ---------------------------------------------------------------------------
# the reference's surface
# ---------------------------------------------------------------------------

def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None):
    """Estimate one cell on the production mesh (the reference lowers and
    compiles it); returns the record."""
    cfg = _dryrun_model_cfg(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    rec = estimate(cfg, SHAPES_BY_NAME[shape_name],
                   make_production_mesh(multi_pod=multi_pod))
    rec["arch"] = arch
    rec["overrides"] = {k: str(v) for k, v in (overrides or {}).items()}
    return rec


def run_cell(arch, shape_name, multi_pod, skip_existing=False, tag=""):
    name = f"{arch}__{shape_name}__{_mesh_name(multi_pod)}"
    if tag:
        name += f"__{tag}"
    out_path = OUT_DIR / f"{name}.json"
    if skip_existing and out_path.exists():
        print(f"[skip] {name}")
        return json.loads(out_path.read_text())
    cfg = configs.get(arch)
    cell = SHAPES_BY_NAME[shape_name]
    reason = skip_reason(cfg, cell)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    if reason:
        rec = {"arch": arch, "shape": shape_name,
               "mesh": _mesh_name(multi_pod), "skipped": reason}
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[SKIP] {name}: {reason}")
        return rec
    try:
        rec = lower_cell(arch, shape_name, multi_pod)
        out_path.write_text(json.dumps(rec, indent=1))
        r = rec["roofline"]
        print(f"[ok] {name}: estimate={rec['estimate_s']}s "
              f"dom={r['dominant']} comp={r['compute_s']:.4f}s "
              f"mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
              f"useful={r['useful_flops_ratio']:.3f} "
              f"peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB")
        return rec
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec = {"arch": arch, "shape": shape_name,
               "mesh": _mesh_name(multi_pod),
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[FAIL] {name}: {type(e).__name__}: {str(e)[:200]}")
        return rec


TABLE_COLUMNS = ["arch", "shape", "mesh", "mode", "compute_s", "memory_s",
                 "collective_s", "dominant", "useful_ratio",
                 "peak_GiB_per_dev", "note"]
NOTES = {
    "compute": "train: the split's redundant part (mixers, KV heads "
               "shared, sp's keys); serving: sharded serving (16.2c)",
    "memory": "fuse the elementwise chains eager runs one op at a time",
    "collective": "keep parameters and caches sharded through the step, "
                  "not gathered whole",
}


def roofline_table(out_dir: Path | None = None) -> list:
    """The roofline table of every record in ``out_dir`` (``OUT_DIR``; the
    columns of the reference's ``benchmarks/roofline.py``), written to
    ``out_dir/roofline.csv``; returns the rows."""
    out_dir = OUT_DIR if out_dir is None else out_dir
    rows = []
    for p in sorted(out_dir.glob("*.json")):
        r = json.loads(p.read_text())
        key = [r["arch"], r["shape"], r["mesh"]]
        if "skipped" in r or "error" in r:
            word = "SKIP" if "skipped" in r else "ERROR"
            rows.append(key + [word, "-", "-", "-", "-", "-", "-",
                               (r.get("skipped") or r["error"])[:60]])
            continue
        rl = r["roofline"]
        rows.append(key + [
            r["mode"], f"{rl['compute_s']:.4f}", f"{rl['memory_s']:.4f}",
            f"{rl['collective_s']:.4f}", rl["dominant"],
            f"{rl['useful_flops_ratio']:.3f}",
            f"{r['memory']['peak_bytes'] / 2**30:.2f}",
            NOTES[rl["dominant"]][:70]])
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "roofline.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(TABLE_COLUMNS)
        w.writerows(rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="write the roofline table of the records and exit")
    args = ap.parse_args(argv)
    if args.table:
        rows = roofline_table()
        print(f"wrote {OUT_DIR / 'roofline.csv'} ({len(rows)} rows)")
        return
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    archs = configs.ARCHS if args.all or not args.arch else \
        [configs.ALIASES.get(args.arch, args.arch)]
    shapes = list(SHAPES_BY_NAME) if args.all or not args.shape \
        else [args.shape]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp,
                               skip_existing=args.skip_existing)
                n_fail += 1 if "error" in rec else 0
    print(f"done; failures={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
