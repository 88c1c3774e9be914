"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``repro_torch``'s sketch path — create -> ingest -> query of the
``lsketch`` kind — at the repo's paper-table deployment
(``benchmarks/paper_tables.py`` ``_lsk_cfg(COMFS, d=2048, k=8,
window=True)``: d=2048, 4 label blocks, F=1024, r=s=8, c=16, k=8, window
1440, pool 16384 x 16 probes), 4 shards stacked on one card, over the
com-Friendster analog stream cut to 2,000,000 edges for the time limit;
then the LM substrate's serving path — prefill forward and the decode
server — at Qwen3-8B's full width (36 layers, d_model 4096, 32 query heads
on 8 KV heads, d_head 128, vocab 151,936; f32 weights from a seed).

Phases (any failure raises, so the exit code is non-zero):
  1. card name and power limit;
  2. build every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
     source, in parallel) and print each ``-Xptxas -v`` report; the flash
     kernel's instances must each hold tensor-core MMAs (``cuobjdump
     -sass``), their registers and spills are logged;
  3. after a tiny warm-up launch of the insert and pool kernels (the
     first launch in a process loads the module), the insert kernel
     against its plain version, exactly, on the stream's first flush into
     fresh states and its second flush into the same, loaded states;
     each timed over INSERT_REPS launches from its pre-flush key plane
     (median, spread, the largest bin fill and the time per step of the
     longest bin);
  3b. (after phase 5, on what phase 4 captured) the pool kernel against
     its plain version on the rejects of the last kernel-route flush,
     from copies of the pool leaves as that flush found them: pool_key,
     pool_C, pool_P and pool_lost exactly; CUDA-event median over
     POOL_REPS launches, each on a fresh copy, and the byte bound;
  4. ingest in flushes cut at subwindow boundaries (<= 65,536 edges) plus
     one ~512-edge flush spanning a boundary (the scan route); the first
     two flushes and the last kernel-route flush (the pool loaded) are
     replayed on a CPU clone of shard 0 through the plain versions and
     must match leaf for leaf; edges/s in all and on the kernel route;
  5. edge, vertex (out, in) and label batches of 1,024 queries, with and
     without the edge label, at last in {None, 1, 8} on the kernel path;
     sampled answers must equal the dense scan path's;
  6. the query kernels against their plain versions at the main path's
     shapes, exactly: the edge probe's contract entry (probe cells and
     keys in; w, wl, go_pool out) and its fused entry (raw queries in;
     addressing, walk and pool lookup in one launch) on the planes of
     ``last=None`` and on the horizon-stacked planes of HORIZONS, with
     and without the edge label; the vertex scan both ways. Timings by
     CUDA events beside each kernel's profiler device time and byte
     bound; an edge and a vertex query's split by stage (the edge split
     by ``tools/edge_query_split.py``: host addressing, walk kernel, pool
     lookup, the fused entry, the whole ``skt.query``, and the
     ``cudaLaunchKernel`` calls of one edge query);
  6b. the analytics path on the same handle: heavy vertices (k=16, out
     and in), heavy edges (k=16) and top labels (k=4, out and in) at last
     in {None, 1} and one horizons=[None, 1, 8] sweep on the "cuda" path,
     each equal to the "scan" path; list-``last`` queries of every kind,
     row for row equal to phase 5's answers (an edge sweep in one
     edge-probe launch); reachability of 64 pairs
     sampled from the newest subwindow's positive edge answers, all True;
     then the cell-decode kernel against its plain version on the main
     path's key plane, exactly, timed by CUDA events;
  7. a profiler trace of two replayed flushes (where ingest time goes:
     host ms by stage, the pool pass's share of the trace's host time,
     the card's busy share and the number of cudaLaunchKernel calls);
  O. (the 4-shard state freed) the object API at one shard over the
     COMFS analog at its own 500,000 edges, in batches cut at subwindow
     boundaries plus one straddling batch: O1 ``LSketch.insert`` at CFG
     (the first two and the last kernel-route batches replayed on the CPU
     through the plain versions, leaf for leaf; the insert kernel at
     S = 1 against its plain version on a fresh and a loaded state), O2
     N_SCALAR scalar calls of every query kind x edge label x last in
     {None, 1}, each equal to the batched and the scan answers, with one
     plane build a horizon, O3 the edge probe and the vertex scan at
     S = 1 and the single-sketch drop-ins against their plain versions,
     O4 reachability, subgraph counts and the scalar analytics, O5
     ``GSS`` at GSS_CFG (one bin a batch; the claim table's spill) held
     to a CPU replay run in a child process, O6 ``LGS`` at LGS_CFG held to
     a CPU replay; edges/s, µs per call and each sketch's state_bytes;
  L1. (the sketch state freed) the flash-attention kernel against its
     plain version on Qwen3-8B's and SmolLM-135M's prefill attention, a
     ragged length and bf16; medians of CUDA-event times beside the plain
     version, PyTorch's scaled_dot_product_attention and the bound (the
     tensor-core rate of each variant: bf16, or split-TF32's three MMAs a
     product in f32), with each case's kernel/SDPA ratio and share of
     the bound;
  L2. Qwen3-8B prefill of one 8,192-token prompt through ``lm.forward``
     with the kernel (36 launches), against the same weights and tokens
     through the plain attention; logits agree to LOGIT_TOL of the largest
     logit, and with TF32 on they do not;
  L3. ``DecodeServer`` (4 slots, 256 positions) answers 8 requests of 128
     prompt tokens and 32 greedy new tokens; a profiler trace of 8 decode
     steps at that batch (where a step's time goes); then the prompt's
     first 128 tokens through ``serve_step`` on a 1-slot cache agree with
     L2's forward logits at those positions;
  8. one JSON line of the kernels and the end-to-end numbers, the card
     line, and the result line.

Four paths count kernel launches, each from 0 just before it: the sketch
path (phases 4 and 5), the analytics path (phase 6b, before its
comparisons), the object path (phase O, before its comparisons; the
single-sketch rows' launches) and the prefill (L2, the kernel forward). Each kernel's
``launches`` in the JSON line is from the path it was ported for.
TF32 is off throughout (the models are f32), except in the one forward
of L2 that shows the tolerance would catch it.
Exits non-zero without printing a result when no card is present, or when
the repository's ``src`` is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import multiprocessing
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch import sketch as skt  # noqa: E402
from repro_torch.core import (GSS, LGS, LGSConfig, LSketch,  # noqa: E402
                              gss_config, init_state, state_bytes)
from repro_torch.core import hashing as hsh  # noqa: E402
from repro_torch.core.lgs import LGS_LEAVES, lgs_state_bytes  # noqa: E402
from repro_torch.core.lsketch import (edge_probes, precompute,  # noqa: E402
                                      valid_slot_mask)
from repro_torch.core.types import (LEAVES, LSketchConfig,  # noqa: E402
                                    LSketchState, init_leaves)
from repro_torch.data.stream import COMFS, generate  # noqa: E402
from repro_torch.engine import insert as eng  # noqa: E402
from repro_torch.engine.window import WindowRing  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import \
    ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.heavy_hitters.kernel import (  # noqa: E402
    cell_decode_kernel_sharded, cell_decode_plain)
from repro_torch.kernels.heavy_hitters.ops import _static_blocks  # noqa: E402
from repro_torch.kernels.sketch_insert import \
    ops as insert_ops  # noqa: E402
from repro_torch.kernels.sketch_insert.kernel import (  # noqa: E402
    TABLE_LOG2_MAX, pool_pass_kernel_sharded, pool_pass_plain,
    pool_stats_buffer, pool_stats_split, sketch_insert_kernel_sharded,
    sketch_insert_plain)
from repro_torch.kernels.sketch_insert.ops import (  # noqa: E402
    _bin_plan, insert_window_batch_pallas)
from repro_torch.kernels.sketch_query.kernel import (  # noqa: E402
    edge_query_kernel, edge_query_plain, sketch_query_kernel_sharded,
    sketch_query_plain)
from repro_torch.kernels.sketch_query.ops import \
    edge_query_pallas  # noqa: E402
from repro_torch.kernels.vertex_scan.kernel import (  # noqa: E402
    vertex_scan_kernel_sharded, vertex_scan_plain)
from repro_torch.kernels.vertex_scan.ops import (  # noqa: E402
    pool_lookup, scan_lines, vertex_query_pallas)
from repro_torch.launch.serve import DecodeServer, Request  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.sketch.ingest import (StackedBatch,  # noqa: E402
                                       _degenerate_batch, _partition_stack)


def _tool(name: str):
    """A script of the repository's ``tools/``, loaded as a module."""
    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# phase 6's edge-query split (a tool of its own, so that it runs on older
# trees as well)
EDGE_SPLIT = _tool("edge_query_split")

# benchmarks/paper_tables.py _lsk_cfg(COMFS, d=2048, k=8, window=True)
CFG = LSketchConfig(d=2048, n_blocks=4, F=1024, r=8, s=8, c=16, k=8,
                    window_size=1440, pool_capacity=16384, pool_probes=16)
N_SHARDS = 4
N_EDGES = 2_000_000
FULL_STREAM_EDGES = 1_806_067_135  # com-Friendster, the stream COMFS models
MAX_FLUSH = 65_536
SPAN_FLUSH = 512
N_QUERIES = 1024
N_SCAN_SAMPLE = 64
HORIZONS = (None, 1, 8)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, published peak
# H100 SXM dense tensor-core rates, published peaks: bf16, and TF32, which
# the f32 flash kernel runs three times a product (split-TF32, the
# cheapest way the card has to f32 accuracy)
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
SEED = 0
INSERT_REPS = 5
POOL_REPS = 7
# phase 6b: (entry point, k, arguments) of each analytics call
ANALYTICS = (("heavy_vertices", 16, {"direction": "out"}),
             ("heavy_vertices", 16, {"direction": "in"}),
             ("heavy_edges", 16, {}),
             ("top_labels", 4, {"direction": "out"}),
             ("top_labels", 4, {"direction": "in"}))
N_REACH = 64
REACH_HOPS = 4

# phase O, the object path at one shard (benchmarks/paper_tables.py builds
# these objects and asks them scalar questions): the COMFS analog at its
# own spec length; LSketch at CFG, GSS at the paper tables' width, LGS at
# their d // 2 rule (paper_tables.py:164)
OBJ_EDGES = COMFS.n_edges
N_SCALAR = 256
N_OBJ_REACH = 16
N_SUBGRAPHS = 16
DROP_IN_EDGES = 8192
GSS_CFG = gss_config(d=2048, pool_capacity=16384)
LGS_CFG = LGSConfig(d=1024, copies=6, c=16, k=8,
                    window_size=COMFS.window_size)

# the LM phases: Qwen3-8B at full width (configs/qwen3_8b.py)
LM_ARCH = "qwen3-8b"
LM_REDUCED = False
PREFILL_LEN = 8192
DECODE_CHECK = 128  # decode-vs-prefill positions
SERVE = dict(batch_slots=4, max_seq=256, requests=8, prompt=128, max_new=32)
# the plain forward's query-chunk threshold: the same function's chunked
# branch, so no [1, 32, 8192, 8192] f32 score tensor (8.6 GB) is held
PLAIN_CHUNK_THRESHOLD = 1024
# logits: max |kernel - plain| / max |plain| over the prompt. Two f32
# forwards that differ only in the order of their sums agree to ~1e-6 of
# the largest logit; TF32 rounds every matmul input to 10 bits (~5e-4
# relative) and lands near 1e-3. 1e-4 sits between, under the 1e-3 bound
# of tests/test_models.py::test_decode_matches_prefill.
LOGIT_TOL = 1e-4
# (label, B, Hq, Hkv, L, dh, dtype) of the L1 checks; the first is the
# prefill's own launch shape and gives the kernel row's numbers
FLASH_CASES = (
    ("qwen3-8b prefill", 1, 32, 8, 8192, 128, torch.float32),
    ("smollm-135m prefill", 4, 9, 3, 2048, 64, torch.float32),
    ("ragged L=1000", 2, 32, 8, 1000, 128, torch.float32),
    ("bf16", 2, 32, 8, 2048, 128, torch.bfloat16),
)
FLASH_REPS = 10

WRAPPERS = {
    "sketch_insert_kernel_sharded": sketch_insert_kernel_sharded,
    "pool_pass_kernel_sharded": pool_pass_kernel_sharded,
    "sketch_query_kernel_sharded": sketch_query_kernel_sharded,
    "vertex_scan_kernel_sharded": vertex_scan_kernel_sharded,
    "cell_decode_kernel_sharded": cell_decode_kernel_sharded,
    "flash_attention_kernel": flash_attention_kernel,
}
MAIN_PATH = ("sketch_insert_kernel_sharded", "pool_pass_kernel_sharded",
             "sketch_query_kernel_sharded", "vertex_scan_kernel_sharded")
ANALYTICS_PATH = ("cell_decode_kernel_sharded",
                  "sketch_query_kernel_sharded", "vertex_scan_kernel_sharded")
OBJECT_PATH = MAIN_PATH + ("cell_decode_kernel_sharded",)
# the single-sketch entries' rows: the wrapper whose launches each counts
OBJECT_KERNELS = {"sketch_insert_kernel": "sketch_insert_kernel_sharded",
                  "sketch_query_kernel": "sketch_query_kernel_sharded",
                  "vertex_scan_kernel": "vertex_scan_kernel_sharded"}
KERNELS = {
    "sketch_insert_kernel_sharded": dict(
        source="src/repro_torch/csrc/sketch_insert.cu",
        replaces="src/repro/kernels/sketch_insert/kernel.py:324"),
    "pool_pass_kernel_sharded": dict(
        source="src/repro_torch/csrc/pool_pass.cu",
        replaces="src/repro/kernels/sketch_insert/ops.py:42",
        replaces_note="_pool_pass: an XLA while_loop; no Pallas kernel "
                      "computes it"),
    "sketch_query_kernel_sharded": dict(
        source="src/repro_torch/csrc/sketch_query.cu",
        replaces="src/repro/kernels/sketch_query/kernel.py:113"),
    "vertex_scan_kernel_sharded": dict(
        source="src/repro_torch/csrc/vertex_scan.cu",
        replaces="src/repro/kernels/vertex_scan/kernel.py:99"),
    "cell_decode_kernel_sharded": dict(
        source="src/repro_torch/csrc/cell_decode.cu",
        replaces="src/repro/kernels/heavy_hitters/kernel.py:97"),
    "flash_attention_kernel": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:67"),
    # the single-sketch entries: the kernels above at S = 1 on [1, ...]
    # views, through the object API
    "sketch_insert_kernel": dict(
        source="src/repro_torch/csrc/sketch_insert.cu",
        replaces="src/repro/kernels/sketch_insert/kernel.py:114",
        entry="kernels/sketch_insert/ops.py::matrix_insert_binned"),
    "sketch_query_kernel": dict(
        source="src/repro_torch/csrc/sketch_query.cu",
        replaces="src/repro/kernels/sketch_query/kernel.py:81",
        entry="kernels/sketch_query/ops.py::edge_query_pallas"),
    "vertex_scan_kernel": dict(
        source="src/repro_torch/csrc/vertex_scan.cu",
        replaces="src/repro/kernels/vertex_scan/kernel.py:69",
        entry="kernels/vertex_scan/ops.py::vertex_query_pallas"),
}


def _log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _sync():
    torch.cuda.synchronize()


def event_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def event_times(fn, reps: int) -> list:
    """Milliseconds of each of ``reps`` runs of ``fn``, by CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _sync()
        start.record()
        fn()
        end.record()
        _sync()
        times.append(start.elapsed_time(end))
    return times


def n_distinct(ids: torch.Tensor) -> int:
    return int(torch.unique(ids).numel())


def diff(pairs):
    """(mismatching elements, max abs difference) over (a, b) int tensor
    pairs."""
    n_bad, err = 0, 0
    for a, b in pairs:
        ne = a != b
        n = int(ne.sum())
        if n:
            n_bad += n
            err = max(err, int((a[ne].long() - b[ne].long()).abs().max()))
    return n_bad, err


def flush_cuts(time_col: np.ndarray, subwindow: int):
    """Flush boundaries: every subwindow boundary and every MAX_FLUSH edges
    within a subwindow — except one boundary near the middle, which a
    SPAN_FLUSH-edge flush straddles. Returns (cuts, index of that flush)."""
    widx = time_col // subwindow
    bounds = (np.flatnonzero(np.diff(widx)) + 1).tolist()
    mid = bounds[len(bounds) // 2]
    lo, hi = mid - SPAN_FLUSH // 2, mid + SPAN_FLUSH // 2
    seg_edges = sorted(set([0] + [b for b in bounds if b != mid]
                           + [lo, hi, len(time_col)]))
    cuts = [0]
    for a, z in zip(seg_edges[:-1], seg_edges[1:]):
        if (a, z) == (lo, hi):
            cuts.append(z)
            continue
        n_chunks = -(-(z - a) // MAX_FLUSH)
        step = -(-(z - a) // n_chunks)
        cuts.extend(list(range(a + step, z, step)) + [z])
    return cuts, cuts.index(lo)


def insert_args(cfg, spec, batch, states, dev):
    """The insert kernel's inputs for one flush, prepared as the engine
    prepares them against the ring of ``states[0]``; the ring plan is
    committed to every state of ``states`` (re-claimed slots zeroed).
    Returns (the kernel's arguments before the state leaves, the probes,
    the bin fills)."""
    cols, counts = _partition_stack(spec, batch)
    tb = {f: torch.from_numpy(v).to(dev) for f, v in cols.items()}
    B = tb["src"].shape[1]
    n_valid = torch.from_numpy(counts).to(dev)
    valid = torch.arange(B, device=dev)[None, :] < n_valid[:, None]
    widx = torch.div(tb["time"], cfg.subwindow_size, rounding_mode="floor")
    plan = WindowRing.for_config(cfg).plan(states[0].slot_widx,
                                           states[0].cur_widx, widx, valid)
    for st in states:
        WindowRing.zero_reset_slots(st.C, 3, plan.reset)
        WindowRing.zero_reset_slots(st.P, 3, plan.reset)
        st.slot_widx.copy_(plan.slot_widx)
        st.cur_widx.copy_(plan.cur_widx)
    probes = edge_probes(cfg, precompute(cfg, tb["src"], tb["src_label"]),
                         precompute(cfg, tb["dst"], tb["dst_label"]))
    le_idx = hsh.edge_label_bucket(tb["edge_label"], cfg.c, cfg.seed)
    w = (tb["weight"] * plan.count_live).to(torch.int32).contiguous()
    _, _, order, bcounts, offs = _bin_plan(cfg, probes, w)
    slot = plan.slot[:, 0].to(torch.int32).contiguous()
    args = (probes.rows.contiguous(), probes.cols.contiguous(),
            probes.keys.contiguous(), w, le_idx, slot, order, offs, bcounts)
    return args, probes, bcounts


def warm_up(dev) -> dict:
    """One tiny launch of the insert and pool kernels (a one-edge flush
    into a 2 x 2 matrix, a one-item pass over a 2-slot pool): the
    milliseconds of each, by CUDA events. Their first launch in a process
    loads the module; this takes that cost before the timed runs."""
    i32 = lambda *shape, v=0: torch.full(shape, v, dtype=torch.int32,  # noqa
                                         device=dev)
    st = [i32(1, 2, 2, 2, v=-1), i32(1, 2, 2, 2, 1), i32(1, 2, 2, 2, 1, 1)]
    ins = event_ms(lambda: sketch_insert_kernel_sharded(
        i32(1, 1, 1), i32(1, 1, 1), i32(1, 1, 1, v=5), i32(1, 1, v=1),
        i32(1, 1), i32(1), i32(1, 1), i32(1, 1), i32(1, 1, v=1), *st, 1))
    pool = [i32(1, 2, 2, v=-1), i32(1, 2, 1), i32(1, 2, 1, 1), i32(1)]
    pp = event_ms(lambda: pool_pass_kernel_sharded(
        i32(1, 1, v=3), i32(1, 1, v=4), i32(1, 1, v=1), i32(1, 1, v=1),
        i32(1, 1), i32(1, 1), i32(1, 1, v=1), *pool, probes=2, seed=0))
    return {"sketch_insert_kernel_sharded": ins,
            "pool_pass_kernel_sharded": pp}


def check_insert_kernel(cfg, spec, batches, dev, tag, phase="3") -> dict:
    """Phase 3: the insert kernel and its plain version on two states on
    the card, fed the stream's first flush on fresh states and then its
    second flush into the same, loaded states, exactly as the engine would;
    then the kernel timed over INSERT_REPS launches of each flush, each on
    its pre-flush key plane (after a warm-up launch)."""
    kern, plain = init_leaves(cfg, (spec.n_shards,), dev), \
        init_leaves(cfg, (spec.n_shards,), dev)
    warm = warm_up(dev)
    flags, cases = {}, []
    for label, batch in (("fresh", batches[0]), ("loaded", batches[1])):
        args, probes, bcounts = insert_args(cfg, spec, batch, (kern, plain),
                                            dev)
        S, B = args[3].shape
        pre_key = kern.key.clone()
        first = event_ms(lambda: flags.__setitem__(
            "kernel", sketch_insert_kernel_sharded(*args, kern.key, kern.C,
                                                   kern.P, B)))
        plain_ms = event_ms(lambda: flags.__setitem__(
            "plain", sketch_insert_plain(*args, plain.key, plain.C, plain.P,
                                         B)))
        mism, err = diff([(flags["kernel"].int(), flags["plain"].int()),
                          (kern.key, plain.key), (kern.C, plain.C),
                          (kern.P, plain.P)])
        cases.append(dict(label=label, args=args, B=B, pre_key=pre_key,
                          first=first, plain_ms=plain_ms, mismatches=mism,
                          max_abs_err=err, fill=int(bcounts.max()),
                          walked=int(bcounts.clamp(max=B).sum())))
        _log(f"phase {phase} insert kernel vs plain, {label} state [S={S}, "
             f"B={B}], {cases[-1]['walked']} edges walked, largest bin "
             f"{cases[-1]['fill']}: mismatches={mism} max_abs_err={err}; "
             f"kernel first launch {first:.3f} ms, plain {plain_ms:.1f} ms "
             f"{tag}")
        if label == "fresh":
            nbytes, shape = insert_nbytes(cfg, probes, args, bcounts, kern)
    if any(c["mismatches"] for c in cases):
        raise AssertionError("insert kernel disagrees with its plain version")
    # the timed launches run on the plain state's tensors, each from its
    # flush's pre-flush key plane (C and P only receive adds, which do not
    # change the walk)
    for c in cases:
        def launch():
            plain.key.copy_(c["pre_key"])
            return event_ms(lambda: sketch_insert_kernel_sharded(
                *c["args"], plain.key, plain.C, plain.P, c["B"]))
        c["runs"] = [launch() for _ in range(INSERT_REPS)]
        c["ms"] = float(np.median(c["runs"]))
        _log(f"phase {phase} insert kernel, {c['label']} state: median "
             f"{c['ms']:.4f} ms over {INSERT_REPS} launches ("
             f"{[round(r, 4) for r in c['runs']]}), "
             f"{1e3 * c['ms'] / max(c['fill'], 1):.4f} us per step of the "
             f"longest bin ({c['fill']} edges) {tag}")
    fresh, loaded = cases
    _log(f"phase {phase} first-launch cost: warm-up launches "
         f"{json.dumps(warm)} ms; then the first full launch "
         f"{fresh['first']:.3f} ms against "
         f"a median of {fresh['ms']:.4f} ms {tag}")
    return dict(mismatches=fresh["mismatches"] + loaded["mismatches"],
                max_abs_err=max(fresh["max_abs_err"], loaded["max_abs_err"]),
                ms=fresh["ms"], ms_runs=fresh["runs"],
                first_launch_ms=fresh["first"], warm_up_ms=warm,
                ms_loaded=loaded["ms"], plain_ms=fresh["plain_ms"],
                plain_ms_loaded=loaded["plain_ms"], nbytes=nbytes,
                largest_bin=fresh["fill"], largest_bin_loaded=loaded["fill"],
                us_per_step=1e3 * fresh["ms"] / max(fresh["fill"], 1),
                shape=shape)


def insert_nbytes(cfg, probes, args, bcounts, kern):
    """Bytes the insert must move on a fresh state, each read once and
    written once: per walked edge its order entry, s probe coordinates and
    keys, weight and label; each (shard, bin)'s offset and count; the
    distinct candidate key cells of the walked edges; each distinct
    winning cell's key write and C read-modify-write, each distinct (cell,
    label) P read-modify-write (a fresh state: exactly the cells that
    received weight, at the shard's one slot); one flag per row."""
    w, slot = args[3], args[5]
    S, B = w.shape
    dev = w.device
    walked = int(bcounts.clamp(max=B).sum())
    live = w > 0
    sh = torch.arange(S, device=dev)[:, None, None]
    cells = (sh * cfg.d + probes.rows.long()) * cfg.d + probes.cols.long()
    n_cand = n_distinct(cells[live][..., None] * 2 +
                        torch.arange(2, device=dev))  # key [S, d, d, 2]
    n_win = sum(int((kern.C[i, ..., int(slot[i])] != 0).sum())
                for i in range(S))
    n_win_le = sum(int((kern.P[i, ..., int(slot[i]), :] != 0).sum())
                   for i in range(S))
    nbytes = walked * (4 + 3 * cfg.s * 4 + 8) + 2 * bcounts.numel() * 4 + \
        n_cand * 4 + n_win * (4 + 8) + n_win_le * 8 + S * B
    return nbytes, (f"S={S} B={B} walked={walked} candidate_cells={n_cand} "
                    f"winning_cells={n_win}")


class PoolCapture:
    """Keeps a copy of the pool pass's inputs and of the pool leaves as
    they stand before the call, for the flushes it is entered around:
    wraps the wrapper where ``_pool_pass`` calls it (the wrapper still
    counts its own launches)."""

    def __init__(self):
        self.items = self.leaves = self.kw = None

    def __enter__(self):
        inner = insert_ops.pool_pass_kernel_sharded

        def capture(*args, **kw):
            self.items = [a.clone() for a in args[:7]]
            self.leaves = [a.clone() for a in args[7:]]
            self.kw = kw
            return inner(*args, **kw)

        self._inner = inner
        insert_ops.pool_pass_kernel_sharded = capture
        return self

    def __exit__(self, *exc):
        insert_ops.pool_pass_kernel_sharded = self._inner


def pool_nbytes(items, before, after, probes, seed) -> tuple:
    """Bytes the pool pass must move for these inputs, each read once and
    written once: the eligible flags; per eligible item its six scalars;
    the distinct pool-key rows it reads up to its first fit (a host replay
    of the walk) and those written; each pool_C and pool_P element that
    changed (read and written); pool_lost. Returns (bytes, eligible
    items)."""
    ps = hsh.pool_slot_seq(items[0], items[1], before[0].shape[1], probes,
                           seed).cpu().numpy()
    pid_s, pid_d, _, w_key, _, _, elig = (x.cpu().numpy() for x in items)
    pk0 = before[0].cpu().numpy()
    S, B, _ = ps.shape
    nbytes, n_items = S * B * 4, 0
    for sh in range(S):
        pk, read = pk0[sh].copy(), set()
        for i in np.flatnonzero(elig[sh]):
            n_items += 1
            hit = -1
            for q in ps[sh, i].tolist():
                read.add(q)
                if pk[q, 0] == -1 or (pk[q, 0] == pid_s[sh, i] and
                                      pk[q, 1] == pid_d[sh, i]):
                    hit = q
                    break
            nbytes += 6 * 4
            if hit >= 0 and w_key[sh, i] > 0:
                pk[hit] = (pid_s[sh, i], pid_d[sh, i])
        nbytes += len(read) * 8 + int((pk != pk0[sh]).any(1).sum()) * 8
    nbytes += sum(int((a != b).sum()) * 8 for a, b in zip(before[1:3],
                                                          after[1:3]))
    return nbytes + S * 8, n_items


def pool_split(items, leaves, kw, ms, tag) -> dict:
    """Phase 3b's split: one launch on a fresh copy with the kernel's stats
    buffer (per shard: rounds, rounds voided by a lane carrying its slot's
    first claimer's pair and by another lane, ns per stage), and the
    device time of POOL_REPS launches from a profiler trace beside the
    event window ``ms`` (which holds the wrapper's host time too)."""
    stats = pool_stats_buffer(items[0].shape[0], items[0].device)
    fresh = [x.clone() for x in leaves]
    pool_pass_kernel_sharded(*items, *fresh, **kw, stats=stats)
    _sync()
    split = pool_stats_split(stats.cpu())
    del fresh
    copies = iter([[x.clone() for x in leaves]
                   for _ in range(POOL_REPS + 1)])  # one warms up
    kernels = device_ms(lambda: pool_pass_kernel_sharded(
        *items, *next(copies), **kw), POOL_REPS)
    del copies
    device = kernels.pop("total")
    _log(f"phase 3b pool split (stats buffer, one launch): "
         f"{json.dumps(split)}; device ms a launch by kernel (profiler, "
         f"{POOL_REPS} launches) {json.dumps(kernels)} = {device:.4f} "
         f"ms against the event window's {ms:.4f} ms (host share "
         f"{1 - device / ms if ms else 0.0:.4f}) {tag}")
    return dict(split, device_ms=device, device_ms_by_kernel=kernels)


def check_pool_kernel(capture, tag) -> dict:
    """Phase 3b: the pool kernel against its plain version on the rejects
    of the main path's last kernel-route flush, each run on a fresh copy
    of the pool leaves as that flush found them; CUDA-event median."""
    items, leaves, kw = capture.items, capture.leaves, capture.kw
    if items is None:
        raise AssertionError("the pool pass of the captured flush never ran")
    want = [x.clone() for x in leaves]
    plain_ms = event_ms(lambda: pool_pass_plain(*items, *want, **kw))
    got = [x.clone() for x in leaves]
    pool_pass_kernel_sharded(*items, *got, **kw)
    _sync()
    mism, err = diff(zip(got, want))
    del got

    def launch():
        fresh = [x.clone() for x in leaves]
        return event_ms(lambda: pool_pass_kernel_sharded(*items, *fresh,
                                                         **kw))

    runs = [launch() for _ in range(POOL_REPS)]
    ms = float(np.median(runs))
    nbytes, n_items = pool_nbytes(items, leaves, want, **kw)
    S, B = items[0].shape
    probes = kw["probes"]
    leaf_bytes = sum(x.numel() * 4 for x in leaves)
    _log(f"phase 3b pool kernel vs plain on the last kernel-route flush's "
         f"rejects [S={S}, B={B}, probes={probes}], {n_items} eligible "
         f"items (per shard {items[6].sum(1).tolist()}), pool leaves "
         f"{leaf_bytes} bytes a copy: mismatches={mism} max_abs_err={err}; "
         f"kernel median {ms:.4f} ms over {POOL_REPS} launches on a fresh "
         f"copy each ({[round(r, 4) for r in runs]}), plain {plain_ms:.1f} "
         f"ms, byte bound {1e3 * nbytes / HBM_BYTES_PER_S:.5f} ms "
         f"({nbytes} bytes) {tag}")
    if mism:
        raise AssertionError("the pool kernel disagrees with its plain "
                             "version")
    split = pool_split(items, leaves, kw, ms, tag)
    return {"pool_pass_kernel_sharded": dict(
        mismatches=mism, max_abs_err=err, ms=ms, ms_runs=runs,
        plain_ms=plain_ms, nbytes=nbytes, split=split,
        shape=f"S={S} B={B} probes={probes} eligible={n_items} "
              f"pool_leaf_bytes={leaf_bytes}")}


def clone_check(cfg, spec, state, clone, batch, i) -> None:
    """Phase 4: replay shard 0's rows of a flush on its CPU clone through
    the plain versions and compare leaf for leaf with the card."""
    cols, counts = _partition_stack(spec, batch)
    row0 = {f: torch.from_numpy(v[0:1].copy()) for f, v in cols.items()}
    saved = dict(eng.ROUTE_EDGES)
    eng.insert_stacked_fused_impl(cfg, clone, StackedBatch(**row0),
                                  counts[0:1], use_kernel=True)
    eng.ROUTE_EDGES.update(saved)
    live = state.shards.map(lambda x: x[0:1].cpu())
    bad = [f for f, x, y in zip(LEAVES, clone.leaves(), live.leaves())
           if not torch.equal(x, y)]
    _log(f"phase 4 flush {i}: CPU clone of shard 0 through the plain "
         f"versions vs the card, leaf for leaf: "
         f"{'equal' if not bad else 'DIFFER ' + str(bad)}")
    if bad:
        raise AssertionError(f"shard-0 clone differs in {bad}")


def ingest_stream(cfg, spec, stream, flushes, span_i, dev, tag,
                  capture=None):
    """Phase 4: the stream through ``skt.ingest`` flush by flush. The
    first two flushes and the last kernel-route flush are replayed on a
    CPU clone of shard 0 (outside the timed calls); ``capture`` (a
    ``PoolCapture``) is entered around the last kernel-route flush."""
    state = skt.create(spec, device=dev)
    routes = {"kernel": 0, "scan": 0}
    last_k = max(i for i in range(len(flushes)) if i != span_i)
    flush_s = []
    for i, (a, z) in enumerate(flushes):
        batch = stream.slice(a, z)
        checked = i < 2 or i == last_k
        clone = state.shards.map(lambda x: x[0:1].cpu()) if checked else None
        before = dict(eng.ROUTE_EDGES)
        with capture if capture is not None and i == last_k else \
                contextlib.nullcontext():
            _sync()
            t0 = time.perf_counter()
            state = skt.ingest(spec, state, batch, path="cuda")
            _sync()
            flush_s.append(time.perf_counter() - t0)
        for k in routes:
            routes[k] += eng.ROUTE_EDGES[k] - before[k]
        if (eng.ROUTE_EDGES["scan"] != before["scan"]) != (i == span_i):
            raise AssertionError(f"flush {i} took the wrong route (the "
                                 f"boundary-spanning flush is {span_i})")
        if clone is not None:
            clone_check(cfg, spec, state, clone, batch, i)
    n_edges, total = len(stream), sum(routes.values())
    if total != n_edges or not routes["kernel"] or not routes["scan"]:
        raise AssertionError(f"route counts {routes} != {n_edges} edges")
    ingest_s = sum(flush_s)
    kernel_s = ingest_s - flush_s[span_i]
    pool_used = int((state.shards.pool_key[..., 0] != -1).sum())
    _log(f"phase 4 ingest: {n_edges} edges in {len(flushes)} flushes, "
         f"{ingest_s:.3f} s of ingest calls = {n_edges / ingest_s:.0f} "
         f"edges/s; kernel route {routes['kernel']} edges in {kernel_s:.3f} "
         f"s = {routes['kernel'] / kernel_s:.0f} edges/s {tag}; route "
         f"edges: kernel {routes['kernel']} "
         f"({routes['kernel'] / total:.4%}), scan {routes['scan']} "
         f"({routes['scan'] / total:.4%}); pool entries {pool_used}, "
         f"pool_lost {state.shards.pool_lost.tolist()}; per flush: kernel "
         f"route median {1e3 * np.median(np.delete(flush_s, span_i)):.1f} "
         f"ms (first {1e3 * flush_s[0]:.1f}, last {1e3 * flush_s[last_k]:.1f}"
         f"), scan-route flush ({flushes[span_i][1] - flushes[span_i][0]} "
         f"edges) {1e3 * flush_s[span_i]:.1f} ms")
    return state, n_edges / ingest_s, routes["kernel"] / kernel_s


def query_inputs(cfg, stream):
    """The query batches of phase 5, as host arrays, seeded."""
    rng = np.random.default_rng(SEED + 1)
    recent = np.flatnonzero(stream.time >= stream.time[-1] -
                            cfg.subwindow_size * 2)
    ei = rng.choice(recent, N_QUERIES)
    vi = rng.integers(0, len(stream), N_QUERIES)
    even = np.arange(N_QUERIES) % 2 == 0
    return dict(
        etime=stream.time[ei],
        src=stream.src[ei], src_label=stream.src_label[ei],
        dst=stream.dst[ei], dst_label=stream.dst_label[ei],
        le=stream.edge_label[ei],
        v=np.where(even, stream.src[vi], stream.dst[vi]).astype(np.int32),
        lv=np.where(even, stream.src_label[vi],
                    stream.dst_label[vi]).astype(np.int32),
        labels=(np.arange(N_QUERIES) % COMFS.n_vertex_labels).astype(
            np.int32))


def query_batch(qi, kind, with_le, last, sl=slice(None)):
    le = qi["le"][sl] if with_le else None
    if kind == "edge":
        return skt.QueryBatch.edges(qi["src"][sl], qi["src_label"][sl],
                                    qi["dst"][sl], qi["dst_label"][sl], le,
                                    last=last)
    if kind in ("vertex-out", "vertex-in"):
        return skt.QueryBatch.vertices(qi["v"][sl], qi["lv"][sl], le,
                                       direction=kind[7:], last=last)
    return skt.QueryBatch.labels(qi["labels"][sl], le, last=last)


KINDS = ("edge", "vertex-out", "vertex-in", "label")


def run_queries(spec, state, qi, tag):
    """Phase 5: every kind x edge label x horizon on the kernel path."""
    answers, q_times = {}, {}
    for kind in KINDS:
        for with_le in (False, True):
            for last in HORIZONS:
                q = query_batch(qi, kind, with_le, last)
                skt.query_planes(spec, state, last)  # plane build: set-up
                _sync()
                t0 = time.perf_counter()
                out = skt.query(spec, state, q, path="cuda")
                _sync()
                q_times.setdefault(kind, []).append(
                    time.perf_counter() - t0)
                if out.shape != (N_QUERIES,) or out.dtype != torch.int32 \
                        or int(out.min()) < 0:
                    raise AssertionError(f"bad {kind} answers")
                answers[(kind, with_le, last)] = out.cpu()
    hit = float((answers[("edge", False, None)] > 0).float().mean())
    _log(f"phase 5 queries: {len(answers)} batches of {N_QUERIES}; edge "
         f"queries with a positive estimate: {hit:.4f}")
    for kind, ts in q_times.items():
        _log(f"phase 5 {kind}: {1e6 * np.mean(ts) / N_QUERIES:.3f} us/query "
             f"(mean over {len(ts)} batches of {N_QUERIES}, cached planes) "
             f"{tag}")
    return answers


def check_scan_path(spec, state, qi, answers) -> None:
    """Phase 5: sampled kernel-path answers against the dense scan path."""
    sample = slice(0, N_SCAN_SAMPLE)
    mism = 0
    for (kind, with_le, last), got in answers.items():
        q = query_batch(qi, kind, with_le, last, sample)
        want = skt.query(spec, state, q, path="scan").cpu()
        mism += int((want != got[sample]).sum())
    _log(f"phase 5 cuda path vs scan path on {N_SCAN_SAMPLE} queries x "
         f"{len(answers)} batches: mismatches={mism}")
    if mism:
        raise AssertionError("cuda-path answers differ from the scan path")


def scan_nbytes(cfg, lines, f, le, key_plane, direction) -> int:
    """Bytes a vertex-scan batch must move, each read once: every shard's
    keys on the distinct lines the batch scans (queries share lines), cw
    of each distinct matching cell and pw of each distinct (matching cell,
    label), the per-query inputs and the two outputs."""
    S, _, d, _ = key_plane.shape
    nq = lines.shape[0]
    dev = key_plane.device
    base = (torch.arange(S, device=dev)[:, None, None, None] * 2 +
            torch.arange(2, device=dev)[:, None, None]) * d
    j = torch.arange(d, device=dev)
    lq = le[None, None, :, None].long()
    cells, cells_le = [], []
    for i in range(cfg.r):  # the plain scan's match rule, by line
        li = lines[:, i].long()
        if direction == "out":
            kg = key_plane[:, :, li]  # [S, 2, nq, d]
            cell = (base + li[:, None]) * d + j
        else:
            kg = key_plane[:, :, :, li].movedim(3, 2)
            cell = (base + j) * d + li[:, None]
        ia, ib, fa, fb = hsh.unpack_key(kg, cfg.F)
        idx, fp = (ia, fa) if direction == "out" else (ib, fb)
        match = (kg != -1) & (idx == i) & (fp == f[None, None, :, None])
        cells.append(cell.expand_as(match)[match])
        cells_le.append((cell * cfg.c + lq).expand_as(match)[match])
    n_lines = n_distinct(lines)
    return S * n_lines * 2 * d * 4 + n_distinct(torch.cat(cells)) * 4 + \
        n_distinct(torch.cat(cells_le)) * 4 + nq * (cfg.r + 2) * 4 + \
        2 * S * nq * 4


def device_ms(fn, reps: int) -> dict:
    """Device milliseconds a call of ``fn`` by kernel (and memset), from a
    profiler trace of ``reps`` calls, with their total."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync()
    out = {e.key[:40]: e.self_device_time_total / 1e3 / reps
           for e in prof.key_averages()
           if e.device_type.name == "CUDA" and e.self_device_time_total > 0
           and not getattr(e, "is_user_annotation", False)}
    out["total"] = sum(out.values())
    return out


def vertex_query_split(cfg, planes, qi, dev, direction, tag, reps=5):
    """Phase 6: one 1,024-query vertex batch of
    ``vertex_scan/ops.py::vertex_query_planes`` (with the edge label) in
    its three stages, by CUDA events: addressing and lines, the scan
    kernel, the dense [S, B, Q] pool lookup; medians of ``reps``."""
    v, lv, le = (torch.from_numpy(qi[k]).to(dev) for k in ("v", "lv", "le"))
    spans = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        _sync()
        ev[0].record()
        pre, lines = scan_lines(cfg, v, lv)
        le_idx = hsh.edge_label_bucket(le, cfg.c, cfg.seed)
        ev[1].record()
        vertex_scan_kernel_sharded(lines, pre.f.contiguous(), le_idx,
                                   planes.key, planes.cw, planes.pw, r=cfg.r,
                                   F=cfg.F, direction=direction)
        ev[2].record()
        pool_lookup(planes, pre.vid, le_idx, direction)
        ev[3].record()
        _sync()
        spans.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    addr, scan, pool = (float(np.median(x)) for x in zip(*spans))
    Q = planes.pool_key.shape[1]
    _log(f"phase 6 vertex-{direction} query split (one batch of "
         f"{len(v)}, with the edge label, CUDA events, median of {reps}): "
         f"addressing and lines {addr:.4f} ms, scan kernel {scan:.4f} ms, "
         f"pool lookup [S, B, Q={Q}] {pool:.4f} ms; "
         f"{1e3 * (addr + scan + pool) / len(v):.3f} us a query {tag}")


def probe_nbytes(cfg, pr, le, key, cw_hits=1, pool=None) -> int:
    """Bytes an edge-probe launch must move, each read once: the per-query
    inputs (the contract entry's probe triples and label, or the fused
    entry's five raw columns), the distinct key cells the walks visit (up
    to and including each one's stop), cw of each distinct hit cell and pw
    of each distinct (hit cell, label) at each of ``cw_hits`` horizons, the
    outputs. ``pool`` (the fused entry: ``(pool_key, pool_probes)``) adds
    the pool-key pairs the walks without a stop probe and the counters of
    each distinct winning slot."""
    S, _, d, _ = key.shape
    nq, s = pr.rows.shape
    dev = key.device
    rows, cols = pr.rows.long(), pr.cols.long()
    cur = key[:, :, rows, cols].movedim(1, -1)  # [S, nq, s, 2]
    match = (cur == pr.keys[None, :, :, None]).reshape(S, nq, -1)
    stop = match | (cur == -1).reshape(S, nq, -1)
    first = stop.to(torch.uint8).argmax(-1, keepdim=True)
    any_stop = stop.any(-1)
    visited = torch.where(any_stop[..., None], first + 1, stop.shape[-1])
    sh = torch.arange(S, device=dev)[:, None, None, None]
    ids = (((sh * 2 + torch.arange(2, device=dev)) * d +
            rows[None, :, :, None]) * d + cols[None, :, :, None]
           ).reshape(S, nq, -1)  # cells of the planes [S, 2, d, d]
    seen = torch.arange(stop.shape[-1], device=dev) < visited
    hit = any_stop & match.gather(-1, first)[..., 0]
    hit_ids = ids.gather(-1, first)[..., 0][hit]
    hit_le = le[None, :].expand(S, -1)[hit]
    counters = n_distinct(hit_ids) + n_distinct(hit_ids * cfg.c + hit_le)
    if pool is None:
        return nq * (3 * s * 4 + 4) + n_distinct(ids[seen]) * 4 + \
            counters * 4 + 3 * S * nq * 4
    pool_key, probes = pool
    Q = pool_key.shape[1]
    ps = hsh.pool_slot_seq(pr.pid_src, pr.pid_dst, Q, probes,
                           cfg.seed).long()  # [nq, probes]
    slots = (torch.arange(S, device=dev)[:, None, None] * Q + ps)
    go = ~any_stop  # [S, nq]
    pk = pool_key[:, ps]  # [S, nq, probes, 2]
    pm = (pk[..., 0] == pr.pid_src[None, :, None]) & \
        (pk[..., 1] == pr.pid_dst[None, :, None])
    won = go & pm.any(-1)
    slot = slots.gather(-1, pm.to(torch.uint8).argmax(-1, keepdim=True)
                        )[..., 0][won]
    counters += n_distinct(slot) + n_distinct(slot * cfg.c +
                                              le[None, :].expand(S, -1)[won])
    return nq * 5 * 4 + 2 * cfg.n_blocks * 4 + n_distinct(ids[seen]) * 4 + \
        n_distinct(slots[go]) * 8 + cw_hits * counters * 4 + \
        2 * cw_hits * S * nq * 4


def check_edge_query_kernel(cfg, spec, state, planes, qi, pr, le, dev,
                            tag) -> dict:
    """Phase 6: the fused entry (the addressing, the walk and the pool
    lookup in one launch) against ``edge_query_plain`` on the main path's
    planes with and without the edge label, and on the horizon-stacked
    planes of HORIZONS; CUDA events and profiler device time beside the
    byte bound, at H = 1 and for the sweep."""
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    q = [t(qi[k]) for k in ("src", "src_label", "dst", "dst_label")]
    lab = t(qi["le"])
    multi, uniq = skt.query_planes_multi(spec, state, list(HORIZONS))
    pairs = []
    for pl in (planes, multi):
        for l in (lab, None):
            got = edge_query_kernel(cfg, pl, *q, l)
            want = edge_query_plain(cfg, pl, *q, l)
            pairs += list(zip(got, want))
    _sync()
    mism, err = diff(pairs)
    del pairs
    one, sweep = (cfg, planes, *q, lab), (cfg, multi, *q, lab)
    ms = event_ms(lambda: edge_query_kernel(*one), 50)
    dev_ms = device_ms(lambda: edge_query_kernel(*one), 20)
    plain_ms = event_ms(lambda: edge_query_plain(*one), 5)
    sweep_ms = event_ms(lambda: edge_query_kernel(*sweep), 50)
    sweep_plain = event_ms(lambda: edge_query_plain(*sweep), 3)
    pool = (planes.pool_key, cfg.pool_probes)
    nbytes = probe_nbytes(cfg, pr, le, planes.key, 1, pool)
    sweep_bytes = probe_nbytes(cfg, pr, le, planes.key, len(uniq), pool)
    _log(f"phase 6 edge_query (fused: addressing, walk, pool) vs plain: "
         f"mismatches={mism} (H=1 and the H={len(uniq)} sweep, with and "
         f"without the label); H=1 {ms:.4f} ms (CUDA events, 50 launches), "
         f"device {dev_ms['total']:.4f} ms a launch (profiler: "
         f"{json.dumps(dev_ms)}), byte bound "
         f"{1e3 * nbytes / HBM_BYTES_PER_S:.7f} ms, plain {plain_ms:.3f} "
         f"ms; sweep H={len(uniq)} {sweep_ms:.4f} ms, bound "
         f"{1e3 * sweep_bytes / HBM_BYTES_PER_S:.7f} ms, plain "
         f"{sweep_plain:.3f} ms {tag}")
    if mism:
        raise AssertionError("the fused edge-query entry disagrees with "
                             "its plain version")
    return dict(fused_mismatches=mism, fused_max_abs_err=err, fused_ms=ms,
                fused_device_ms=dev_ms["total"], fused_plain_ms=plain_ms,
                bound_ms_fused=1e3 * nbytes / HBM_BYTES_PER_S,
                fused_sweep_horizons=len(uniq), fused_sweep_ms=sweep_ms,
                fused_sweep_plain_ms=sweep_plain,
                bound_ms_fused_sweep=1e3 * sweep_bytes / HBM_BYTES_PER_S)


def check_query_kernels(cfg, spec, state, qi, dev, tag) -> dict:
    """Phase 6: the edge-probe kernel's two entries and the vertex-scan
    kernel against their plain versions on the main path's planes and
    1,024-query inputs, and the edge query's split."""
    planes = skt.query_planes(spec, state, None)
    S = planes.key.shape[0]
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    pr = edge_probes(cfg, precompute(cfg, t(qi["src"]), t(qi["src_label"])),
                     precompute(cfg, t(qi["dst"]), t(qi["dst_label"])))
    le = hsh.edge_label_bucket(t(qi["le"]), cfg.c, cfg.seed)
    q_args = (pr.rows.contiguous(), pr.cols.contiguous(),
              pr.keys.contiguous(), le, planes.key, planes.cw, planes.pw)
    got = sketch_query_kernel_sharded(*q_args)
    want = sketch_query_plain(*q_args)
    _sync()
    mism, err = diff(zip(got, want))
    ms = event_ms(lambda: sketch_query_kernel_sharded(*q_args), 50)
    dev_ms = device_ms(lambda: sketch_query_kernel_sharded(*q_args), 20)
    plain_ms = event_ms(lambda: sketch_query_plain(*q_args), 5)
    nbytes = probe_nbytes(cfg, pr, le, planes.key)
    _log(f"phase 6 sketch_query kernel vs plain: mismatches={mism}; "
         f"kernel {ms:.4f} ms (CUDA events, 50 launches), device "
         f"{dev_ms['total']:.4f} ms a launch (profiler: "
         f"{json.dumps(dev_ms)}), byte bound "
         f"{1e3 * nbytes / HBM_BYTES_PER_S:.7f} ms, plain "
         f"{plain_ms:.3f} ms {tag}")
    row = dict(mismatches=mism, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               nbytes=nbytes, device_ms=dev_ms["total"],
               shape=f"S={S} nq={N_QUERIES}")
    row.update(check_edge_query_kernel(cfg, spec, state, planes, qi, pr, le,
                                       dev, tag))
    row["edge_query_split"] = EDGE_SPLIT.edge_query_split(
        sys.modules[__name__], cfg, spec, state, qi, dev, tag)
    out = {"sketch_query_kernel_sharded": row}

    pre, lines = scan_lines(cfg, t(qi["v"]), t(qi["lv"]))
    v_args = (lines, pre.f.contiguous(), le, planes.key, planes.cw,
              planes.pw)
    _, per_line = torch.unique(lines, return_counts=True)
    _, per_tile = torch.unique(torch.div(lines, 32, rounding_mode="floor"),
                               return_counts=True)
    groups = {"out": (len(per_line), int(per_line.max())),
              "in": (len(per_tile), int(per_tile.max()))}
    res = {}
    for direction in ("out", "in"):
        kw = dict(r=cfg.r, F=cfg.F, direction=direction)
        got = vertex_scan_kernel_sharded(*v_args, **kw)
        want = vertex_scan_plain(*v_args, **kw)
        _sync()
        v_mism, v_err = diff(zip(got, want))
        v_ms = event_ms(lambda: vertex_scan_kernel_sharded(*v_args, **kw),
                        20)
        v_dev = device_ms(lambda: vertex_scan_kernel_sharded(*v_args, **kw),
                          20)
        v_plain = event_ms(lambda: vertex_scan_plain(*v_args, **kw), 3)
        v_bytes = scan_nbytes(cfg, lines, pre.f, le, planes.key, direction)
        res[direction] = (v_mism, v_err, v_ms, v_plain, v_bytes, v_dev)
        n_groups, most = groups[direction]
        _log(f"phase 6 vertex_scan[{direction}] kernel vs plain: mismatches="
             f"{v_mism}; {N_QUERIES * cfg.r} references on "
             f"{len(per_line)} distinct lines ({n_groups} "
             f"{'lines' if direction == 'out' else '32-column tiles'} "
             f"referenced, at most {most} references on one); kernel "
             f"{v_ms:.4f} ms (CUDA events, 20 launches), device "
             f"{v_dev['total']:.4f} ms a launch (profiler: "
             f"{json.dumps(v_dev)}), byte bound "
             f"{1e3 * v_bytes / HBM_BYTES_PER_S:.4f} ms, plain "
             f"{v_plain:.3f} ms {tag}")
        vertex_query_split(cfg, planes, qi, dev, direction, tag)
    vo, vn = res["out"], res["in"]
    out["vertex_scan_kernel_sharded"] = dict(
        mismatches=vo[0] + vn[0], max_abs_err=max(vo[1], vn[1]), ms=vo[2],
        plain_ms=vo[3], nbytes=vo[4], direction="out", ms_in=vn[2],
        plain_ms_in=vn[3], bound_ms_in=1e3 * vn[4] / HBM_BYTES_PER_S,
        device_ms=vo[5]["total"], device_ms_in=vn[5]["total"],
        distinct_lines=len(per_line), most_refs_on_a_line=groups["out"][1],
        tiles=groups["in"][0], most_refs_in_a_tile=groups["in"][1],
        shape=f"S={S} nq={N_QUERIES}")
    if any(v["mismatches"] for v in out.values()):
        raise AssertionError("a query kernel disagrees with its plain "
                             "version")
    return out


def count_launches(names, fn):
    """Run ``fn`` with every wrapper's launch count from 0; returns
    (``fn``'s result, the counts). Raises if a kernel of ``names`` never
    launched."""
    for w in WRAPPERS.values():
        w.launches = 0
    out = fn()
    launches = {n: w.launches for n, w in WRAPPERS.items()}
    if not all(launches[n] for n in names):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    return out, launches


def _timed(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def _analytics_calls():
    """(label, entry point, k, arguments) of every phase-6b analytics
    call: each of ANALYTICS at last in {None, 1}, and one sweep."""
    def label(name, kw):
        return f"{name}({', '.join(f'{a}={v}' for a, v in kw.items())})"

    calls = [(name, k, dict(kw, last=last))
             for name, k, kw in ANALYTICS for last in (None, 1)]
    calls.append(("heavy_vertices", 16,
                  {"direction": "out", "horizons": list(HORIZONS)}))
    return [(label(name, kw), name, k, kw) for name, k, kw in calls]


def analytics_path(cfg, spec, state, qi, answers, tag):
    """Phase 6b, the counted analytics run on the "cuda" path: top-k calls,
    list-``last`` queries (each row equal to phase 5's single-horizon
    answers) and reachability of sampled in-window edges (all True).
    Returns the top-k answers by call label."""
    plane_s = {}
    for last in (None, 1):
        _, plane_s[f"last={last}"] = _timed(
            lambda: skt.query_planes(spec, state, last))
    _, plane_s["multi" + str(list(HORIZONS))] = _timed(
        lambda: skt.query_planes_multi(spec, state, list(HORIZONS)))
    _log(f"phase 6b plane builds (s, host clock): {json.dumps(plane_s)} "
         f"{tag}")
    got = {}
    for label, name, k, kw in _analytics_calls():
        out, sec = _timed(lambda: getattr(skt, name)(spec, state, k,
                                                     path="cuda", **kw))
        got[label] = [x.cpu() for x in out]
        _log(f"phase 6b cuda {label}: {1e3 * sec:.3f} ms {tag}")
    for kind in KINDS:
        for with_le in (False, True):
            q = query_batch(qi, kind, with_le, list(HORIZONS))
            before = sketch_query_kernel_sharded.launches
            out, sec = _timed(lambda: skt.query(spec, state, q, path="cuda"))
            probes = sketch_query_kernel_sharded.launches - before
            want = torch.stack([answers[(kind, with_le, h)]
                                for h in HORIZONS])
            if out.shape != want.shape or not torch.equal(out.cpu(), want):
                raise AssertionError(f"list-last {kind} rows differ from "
                                     f"the single-horizon answers")
            if kind == "edge" and state.device.type == "cuda" and \
                    probes != 1:  # every horizon of a sweep in one launch
                raise AssertionError(f"an edge sweep took {probes} "
                                     f"edge-probe launches, not 1")
            _log(f"phase 6b list-last {kind} le={with_le} last="
                 f"{list(HORIZONS)}: rows equal phase 5; "
                 f"{1e6 * sec / N_QUERIES:.3f} us/query {tag}")
    newest = qi["etime"] // cfg.subwindow_size == \
        qi["etime"].max() // cfg.subwindow_size
    cand = np.flatnonzero(newest & (answers[("edge", False, None)].numpy()
                                    > 0))
    if not len(cand):
        raise AssertionError("no in-window edge answers to sample")
    pick = np.random.default_rng(SEED + 2).choice(
        cand, min(N_REACH, len(cand)), replace=False)
    reach, sec = _timed(lambda: skt.reachable_many(
        spec, state, qi["src"][pick], qi["src_label"][pick],
        qi["dst"][pick], qi["dst_label"][pick], max_hops=REACH_HOPS))
    _log(f"phase 6b reachable_many on {len(pick)} sampled in-window edges, "
         f"max_hops={REACH_HOPS}: {int(reach.sum())} reachable, "
         f"{1e3 * sec:.3f} ms {tag}")
    if not reach.all():
        raise AssertionError("a one-hop edge the sketch holds is not "
                             "reachable")
    return got


def check_analytics(cfg, spec, state, got, tag) -> dict:
    """Phase 6b comparisons: every "cuda" top-k equals the "scan" path's,
    and the decode kernel equals its plain version on the main path's key
    plane."""
    for label, name, k, kw in _analytics_calls():
        want, sec = _timed(lambda: getattr(skt, name)(spec, state, k,
                                                      path="scan", **kw))
        if not all(torch.equal(a, b.cpu()) for a, b in zip(got[label],
                                                           want)):
            raise AssertionError(f"cuda {label} differs from the scan path")
        _log(f"phase 6b scan {label}: equal to cuda; {1e3 * sec:.3f} ms")
    key = skt.query_planes(spec, state, None).key
    top = got["heavy_edges(last=None)"]
    _log(f"phase 6b top edge (src vid, dst vid, weight): "
         f"{int(top[0][0])}, {int(top[1][0])}, {int(top[2][0])}; occupied "
         f"cells {int((key != -1).sum())} of {key.numel()}")
    starts, widths = _static_blocks(cfg)
    kw = dict(starts=starts, widths=widths, r=cfg.r, F=cfg.F)
    got_k = cell_decode_kernel_sharded(key, **kw)
    want = cell_decode_plain(key, **kw)
    _sync()
    mism, err = diff(zip(got_k, want))
    del got_k, want
    ms = event_ms(lambda: cell_decode_kernel_sharded(key, **kw), 50)
    plain_ms = event_ms(lambda: cell_decode_plain(key, **kw), 3)
    nbytes = 3 * key.numel() * 4 + 2 * len(starts) * 4
    _log(f"phase 6b cell_decode kernel vs plain on key {tuple(key.shape)}: "
         f"mismatches={mism}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
         f"byte bound {1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms {tag}")
    if mism:
        raise AssertionError("the decode kernel disagrees with its plain "
                             "version")
    return {"cell_decode_kernel_sharded": dict(
        mismatches=mism, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        nbytes=nbytes, shape=f"key {list(key.shape)}")}


def profile_ingest(spec, state, stream, flushes, tag):
    """Phase 7: a profiler trace over a replay of the last two flushes (the
    same subwindow, so the ring does not move); the ``lsketch.*`` ranges
    split a flush by stage. Returns the trace's metrics."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync()
        t0 = time.perf_counter()
        for a, z in flushes[-2:]:
            state = skt.ingest(spec, state, stream.slice(a, z), path="cuda")
        _sync()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device time as the profiler's own table sums it: CUDA-side events
    # that are not user annotations (a range's device-side twin spans its
    # whole window and would count idle time as busy)
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type.name == "CUDA"
                 and not getattr(e, "is_user_annotation", False))
    stages = {e.key: e.cpu_time_total / 1e3 for e in events
              if e.key.startswith("lsketch.") and e.device_type.name == "CPU"}
    launches = sum(e.count for e in events
                   if e.key.startswith("cudaLaunchKernel"))
    host_ms = sum(e.self_cpu_time_total for e in events
                  if e.device_type.name == "CPU") / 1e3
    pool_ms = stages.get("lsketch.pool_pass", 0.0)
    pool_share = pool_ms / host_ms if host_ms else 0.0
    _log(f"phase 7 profile of 2 replayed flushes: wall {1e3 * wall:.1f} ms, "
         f"device kernels {dev_us / 1e3:.1f} ms (busy share "
         f"{dev_us / 1e6 / wall:.4f}), host ms by stage "
         f"{json.dumps(stages)}; lsketch.pool_pass {pool_share:.4f} of the "
         f"trace's host time ({host_ms:.1f} ms), {pool_ms / 1e3 / wall:.4f} "
         f"of the wall; {launches} cudaLaunchKernel calls {tag}")
    _log(events.table(sort_by="self_cpu_time_total", row_limit=12))
    return dict(profile_wall_ms=1e3 * wall,
                       profile_busy_share=dev_us / 1e6 / wall,
                       profile_pool_pass_share=pool_share,
                       profile_launches=launches)


def flash_inputs(B, Hq, Hkv, L, dh, dtype, dev):
    """q, k, v of one L1 case, drawn with numpy from SEED."""
    rng = np.random.default_rng(SEED + L + dh)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             ).to(dev, dtype)
            for shape in ((B, Hq, L, dh), (B, Hkv, L, dh), (B, Hkv, L, dh))]


def flash_flops(B, Hq, L, dh) -> int:
    """Operations a causal call needs: 4 dh (a multiply-add for q.k and
    one for p.v) per (query, key) pair the mask keeps, L (L + 1) / 2 pairs
    per head."""
    return 4 * dh * B * Hq * L * (L + 1) // 2


def flash_ptxas(log: str) -> dict:
    """{(type, dh): (registers, spill store bytes, spill load bytes)} of
    the flash kernel's template instances, from its ``-Xptxas -v``
    report."""
    out, inst, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"lsk_flash_attention_kernelI(\w+?)Li(\d+)E",
                          m.group(1))
            inst = (("bf16" if "bfloat16" in k.group(1) else "f32"),
                    int(k.group(2))) if k else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and inst:
            out[inst] = (int(m.group(1)), *spills)
            inst = None
    return out


def flash_sass_hmma(obj: Path) -> dict:
    """{function: tensor-core MMA (HMMA) instructions} in the flash
    kernel's object, by ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


def flash_build_report() -> dict:
    """Phase 2's check that the flash kernel is built for the tensor cores:
    each instance's registers and spills, and its HMMA count."""
    regs = flash_ptxas(build.PTXAS_LOG["flash_attention.cu"])
    hmma = flash_sass_hmma(build.BUILD_DIR / "flash_attention.o")
    _log(f"flash kernel instances (type, dh): registers, spill store / "
         f"load bytes {regs}; HMMA instructions by cuobjdump -sass "
         f"{hmma}")
    if len(regs) != 8 or len(hmma) != 8 or min(hmma.values()) == 0:
        raise AssertionError("the flash kernel's eight instances are not "
                             "all built with tensor-core MMAs")
    return dict(registers={f"{t} dh{d}": r for (t, d), r in regs.items()},
                hmma=sum(hmma.values()))


def flash_ops_ms(flops: int, dtype) -> tuple:
    """(ms, the rate's name) of ``flops`` at the tensor-core rate the
    kernel's variant for ``dtype`` runs at: bf16 MMAs, or three TF32 MMAs
    a product in f32."""
    if dtype == torch.bfloat16:
        return 1e3 * flops / BF16_FLOPS_PER_S, \
            f"bf16 flops over {BF16_FLOPS_PER_S / 1e12:g} TFLOP/s"
    return 1e3 * 3 * flops / TF32_FLOPS_PER_S, \
        f"split-TF32 3 x flops over {TF32_FLOPS_PER_S / 1e12:g} TFLOP/s"


def flash_check(got, want):
    """(max |got - want|, elements out of tolerance, the tolerance). f32:
    |d| < 2e-5 (the same f32 sums in another order move an output ~1e-6);
    bf16: one bf16 rounding of the output, |d| <= 2**-7 max(|want|, 1)."""
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        bad = d > 2.0 ** -7 * want.float().abs().clamp_min(1)
        tol = "|d| <= 2**-7 max(|plain|, 1)"
    else:
        bad = d >= 2e-5
        tol = "|d| < 2e-5"
    return float(d.max()), int(bad.sum()), tol


def sdpa(q, k, v):
    """PyTorch's fused attention on the same inputs: the yardstick of L1,
    timed here and called nowhere in the port."""
    F = torch.nn.functional
    try:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    except TypeError:  # a PyTorch without enable_gqa: repeat the KV heads
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
            is_causal=True)


def check_flash_kernel(dev, tag) -> dict:
    """L1: the flash kernel against its plain version on every case;
    CUDA-event medians of the kernel, the plain version and SDPA."""
    cases = []
    for label, B, Hq, Hkv, L, dh, dtype in FLASH_CASES:
        q, k, v = flash_inputs(B, Hq, Hkv, L, dh, dtype, dev)
        got = flash_attention_kernel(q, k, v, True)
        want = flash_attention_plain(q, k, v, True)
        _sync()
        err, n_bad, tol = flash_check(got, want)
        lib_err = float((sdpa(q, k, v).float() - want.float()).abs().max())
        del got, want
        ms = float(np.median(event_times(
            lambda: flash_attention_kernel(q, k, v, True), FLASH_REPS)))
        plain_ms = float(np.median(event_times(
            lambda: flash_attention_plain(q, k, v, True), FLASH_REPS)))
        library_ms = float(np.median(event_times(lambda: sdpa(q, k, v),
                                                 FLASH_REPS)))
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        flops = flash_flops(B, Hq, L, dh)
        ops_ms, rate = flash_ops_ms(flops, dtype)
        bound = max(ops_ms, 1e3 * nbytes / HBM_BYTES_PER_S)
        cases.append(dict(label=label, shape=f"q {list(q.shape)} k "
                          f"{list(k.shape)} {str(dtype)[6:]}",
                          max_abs_err=err, out_of_tolerance=n_bad,
                          tolerance=tol, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, nbytes=nbytes,
                          ops_ms=ops_ms, ops_rate=rate,
                          sdpa_ratio=ms / library_ms,
                          bound_share=bound / ms))
        _log(f"L1 flash {label} {cases[-1]['shape']}: max_abs_err={err:.3g} "
             f"({tol}; {n_bad} out), sdpa vs plain {lib_err:.3g}; kernel "
             f"{ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
             f"{plain_ms:.3f} ms, sdpa {library_ms:.3f} ms, kernel/sdpa "
             f"{ms / library_ms:.3f}; bound {bound:.4f} ms ({rate} against "
             f"bytes over {HBM_BYTES_PER_S / 1e12:g} TB/s), {bound / ms:.3f} "
             f"of it reached (medians of {FLASH_REPS}) {tag}")
        del q, k, v
    torch.cuda.empty_cache()
    if any(c["out_of_tolerance"] for c in cases):
        raise AssertionError("the flash kernel disagrees with its plain "
                             "version")
    main = cases[0]
    return {"flash_attention_kernel": dict(
        mismatches=0, max_abs_err=main["max_abs_err"], ms=main["ms"],
        plain_ms=main["plain_ms"], library_ms=main["library_ms"],
        nbytes=main["nbytes"], ops_ms=main["ops_ms"],
        ops_rate=main["ops_rate"], shape=main["shape"],
        tolerance=main["tolerance"],
        cases=[{k: v for k, v in c.items() if k != "nbytes"}
               for c in cases])}


def lm_model(dev, tag):
    """The LM config (f32) and its seeded weights, drawn on the card."""
    cfg = configs.get(LM_ARCH, reduced=LM_REDUCED)
    params, sec = _timed(lambda: lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    _log(f"L2 {cfg.name}: {cfg.param_count()} parameters by "
         f"ModelConfig.param_count(), {nbytes} bytes of f32 weights on the "
         f"card, drawn in {sec:.2f} s {tag}")
    return cfg, params


def logit_err(got, ref_cpu, scale: float) -> float:
    """max |got - ref| / scale, ``ref`` brought to the card in row chunks."""
    err = 0.0
    for a in range(0, ref_cpu.shape[1], 1024):
        ref = ref_cpu[:, a:a + 1024].to(got.device)
        err = max(err, float((got[:, a:a + 1024] - ref).abs().max()))
    return err / scale


class _LaunchTimer:
    """CUDA events around each flash launch of one forward: wraps the
    kernel where ``ops.attention`` calls it (the wrapper still counts its
    own launches)."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        inner = flash_ops.flash_attention_kernel

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*a, **kw)
            end.record()
            self.events.append((start, end))
            return out

        self._inner = inner
        flash_ops.flash_attention_kernel = timed
        return self

    def __exit__(self, *exc):
        flash_ops.flash_attention_kernel = self._inner

    def ms(self) -> float:
        _sync()
        return sum(s.elapsed_time(e) for s, e in self.events)


def prefill_phase(cfg, params, dev, tag):
    """L2: one prompt through the plain forward (the reference), the
    counted kernel forward, and the kernel forward with TF32 on. Returns
    (metrics, the prompt tokens, the kernel forward's first DECODE_CHECK
    logits rows)."""
    tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (1, PREFILL_LEN)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens}
    saved = tattn.CHUNKED_ATTN_THRESHOLD
    tattn.CHUNKED_ATTN_THRESHOLD = min(saved, PLAIN_CHUNK_THRESHOLD)
    try:
        ref, plain_s = _timed(lambda: lm.forward(
            cfg.replace(attn_impl="plain"), params, batch))
    finally:
        tattn.CHUNKED_ATTN_THRESHOLD = saved
    ref_cpu = ref.cpu()  # one forward's logits on the card at a time
    scale = float(ref.abs().max())
    if not bool(torch.isfinite(ref).all()):
        raise AssertionError("the plain forward's logits are not finite")
    del ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _LaunchTimer() as timer:
        (logits, sec), launches = count_launches(
            (), lambda: _timed(lambda: lm.forward(cfg, params, batch)))
    kernel_ms = timer.ms()
    peak = torch.cuda.max_memory_allocated()
    n = launches["flash_attention_kernel"]
    V = cfg.vocab_size
    if tuple(logits.shape) != (1, PREFILL_LEN, V) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    err = logit_err(logits, ref_cpu, scale)
    head = logits[0, :DECODE_CHECK].clone()
    del logits
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = lm.forward(cfg, params, batch)
        err_tf32 = logit_err(tf32, ref_cpu, scale)
        del tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    D, L = cfg.d_model, PREFILL_LEN
    mm_flops = 2 * L * (cfg.param_count() - V * D)  # the table is a gather
    attn_flops = cfg.n_layers * flash_flops(1, cfg.n_heads, L, cfg.head_dim)
    out = dict(prefill_tokens_per_s=L / sec, prefill_s=sec,
               plain_prefill_s=plain_s, prefill_flash_ms=kernel_ms,
               prefill_flash_share=kernel_ms / (1e3 * sec),
               prefill_flash_launches=n, lm_peak_memory_bytes=peak,
               prefill_logit_rel_err=err, prefill_logit_rel_err_tf32=err_tf32,
               logit_scale=scale, logit_tol=LOGIT_TOL,
               prefill_matmul_flops=mm_flops, prefill_attention_flops=attn_flops)
    _log(f"L2 prefill of {L} tokens, {cfg.name}: kernel forward {sec:.3f} s "
         f"= {L / sec:.1f} tokens/s ({(mm_flops + attn_flops) / sec / 1e12:.2f}"
         f" TFLOP/s over {mm_flops:.4g} matmul + {attn_flops:.4g} attention "
         f"flops), {n} flash launches taking {kernel_ms:.1f} ms by CUDA "
         f"events ({kernel_ms / (1e3 * sec):.4f} of the forward); plain "
         f"forward {plain_s:.3f} s; peak device memory {peak} bytes {tag}")
    _log(f"L2 logits: max|kernel - plain| / max|plain| = {err:.3g} (max "
         f"|plain| {scale:.4g}; tolerance {LOGIT_TOL}); the same with TF32 "
         f"on: {err_tf32:.3g}")
    if not err <= LOGIT_TOL:
        raise AssertionError("kernel-forward logits disagree with the plain "
                             "forward")
    return out, tokens, head


def check_prefill_on_the_card(cfg, out) -> None:
    """L2's card-only checks: one flash launch per layer, and TF32 fails
    the logit tolerance that the f32 kernel forward meets."""
    if out["prefill_flash_launches"] != cfg.n_layers:
        raise AssertionError(f"{out['prefill_flash_launches']} flash "
                             f"launches in a {cfg.n_layers}-layer forward")
    if not out["prefill_logit_rel_err_tf32"] > LOGIT_TOL:
        raise AssertionError("the logit tolerance does not catch TF32")


def profile_decode(cfg, params, dev, tag, steps: int = 8) -> dict:
    """L3: a profiler trace of ``steps`` decode steps at the server's
    batch, each ending in the logits' copy to the host as the server's
    does: wall and device-kernel time per step (where a step's time
    goes)."""
    from torch.profiler import ProfilerActivity, profile

    B = SERVE["batch_slots"]
    caches = lm.init_cache(cfg, B, SERVE["max_seq"], dev)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    lm.serve_step(cfg, params, caches, tok)[0].cpu()  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            lm.serve_step(cfg, params, caches, tok)[0].cpu()
        _sync()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    _log(f"L3 profile of {steps} decode steps at batch {B}: wall "
         f"{1e3 * wall / steps:.3f} ms/step, device kernels {dev_ms / steps:.3f}"
         f" ms/step (busy share {dev_ms / 1e3 / wall:.4f}), "
         f"{launches / steps:.0f} kernels/step; top by device time "
         f"(ms/step): " + json.dumps(
             {e.key[:60]: round(e.self_device_time_total / 1e3 / steps, 3)
              for e in top}) + f" {tag}")
    return dict(decode_profile_wall_ms_per_step=1e3 * wall / steps,
                decode_profile_device_ms_per_step=dev_ms / steps,
                decode_profile_busy_share=dev_ms / 1e3 / wall)


def serve_phase(cfg, params, tokens, head, dev, tag) -> dict:
    """L3: the decode server on SERVE's requests, then the prompt's first
    DECODE_CHECK tokens through ``serve_step`` on a 1-slot cache against
    the prefill logits at those positions."""
    rng = np.random.default_rng(SEED + 4)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
        0, cfg.vocab_size, SERVE["prompt"])], max_new=SERVE["max_new"])
        for _ in range(SERVE["requests"])]
    server = DecodeServer(cfg, params, batch_slots=SERVE["batch_slots"],
                          max_seq=SERVE["max_seq"], device=dev)
    steps = [0]
    inner_step = server.step

    def step():
        steps[0] += 1
        inner_step()

    server.step = step
    (_, sec), launches = count_launches((), lambda: _timed(
        lambda: server.run(reqs)))
    n_new = [len(r.out) for r in reqs]
    if not all(r.done for r in reqs) or n_new != [SERVE["max_new"]] * len(
            reqs):
        raise AssertionError(f"requests unfinished: new tokens {n_new}")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    if not cfg.tie_embeddings:  # a step gathers B rows of the input table
        weight_bytes -= params["embed"]["tok"].numel() * 4
    step_bound_ms = 1e3 * weight_bytes / HBM_BYTES_PER_S
    out = dict(decode_tokens_per_s=sum(n_new) / sec, decode_steps=steps[0],
               decode_ms_per_step=1e3 * sec / steps[0],
               decode_step_bound_ms=step_bound_ms,
               decode_tokens_processed_per_s=steps[0] * SERVE["batch_slots"]
               / sec)
    _log(f"L3 DecodeServer {SERVE}: {len(reqs)} of {len(reqs)} requests done, "
         f"{sum(n_new)} new tokens in {sec:.3f} s = "
         f"{out['decode_tokens_per_s']:.2f} tokens/s; {steps[0]} steps, "
         f"{out['decode_ms_per_step']:.3f} ms/step against a {step_bound_ms:.3f}"
         f" ms byte bound (weights read once a step); flash launches "
         f"{launches['flash_attention_kernel']} (decode never runs it); "
         f"first request's tokens {reqs[0].out[:8]} {tag}")
    out.update(profile_decode(cfg, params, dev, tag))
    caches = lm.init_cache(cfg, 1, DECODE_CHECK, dev)
    err = 0.0
    for i in range(DECODE_CHECK):
        lg, caches = lm.serve_step(cfg, params, caches, tokens[:, i:i + 1])
        err = max(err, float((lg[0, 0] - head[i]).abs().max()))
    rel = err / float(head.abs().max())
    out["decode_logit_rel_err"] = rel
    _log(f"L3 decode vs prefill over {DECODE_CHECK} positions: max|decode - "
         f"prefill| / max|prefill| = {rel:.3g} (tolerance {LOGIT_TOL})")
    if not rel <= LOGIT_TOL:
        raise AssertionError("decode through the cache disagrees with the "
                             "prefill")
    return out


# --------------------------------------------------------------------------
# phase O: the object path (LSketch, GSS, LGS at one shard)
# --------------------------------------------------------------------------

def _columns(b):
    return [getattr(b, f) for f in ("src", "dst", "src_label", "dst_label",
                                    "edge_label", "weight", "time")]


def _to_cpu(state):
    """A CPU copy of a plain state (a copy on the CPU too)."""
    return state.map(lambda x: x.to("cpu", copy=True))


def _differs(cpu_state, state) -> list:
    """The leaf names where a CPU state and another state differ."""
    names = LEAVES if len(cpu_state.leaves()) == len(LEAVES) else \
        LGS_LEAVES
    return [n for n, x, y in zip(names, cpu_state.leaves(), state.leaves())
            if not torch.equal(x, y.cpu())]


def _gss_replay(conn, cfg, batches) -> None:
    """Phase O5's CPU replay, in a child process: a GSS on the CPU (the
    kernel route through the plain versions) fed ``batches`` (column
    lists); sends its leaves and seconds after each."""
    torch.set_num_threads(1)
    g = GSS(cfg, device="cpu")
    g.insert_path = "cuda"
    for cols in batches:
        t0 = time.perf_counter()
        g.insert(*cols)
        conn.send(([x.numpy() for x in g.state.leaves()],
                   time.perf_counter() - t0))
    conn.close()


def start_gss_replay(stream, flushes):
    """Start phase O5's CPU replay of the first two batches in a child
    process, which runs while the card works; returns (process, pipe)."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    batches = [[np.ascontiguousarray(c) for c in _columns(stream.slice(*f))]
               for f in flushes[:2]]
    proc = ctx.Process(target=_gss_replay, args=(send, GSS_CFG, batches),
                       daemon=True)
    proc.start()
    send.close()
    return proc, recv


def object_ingest(cfg, stream, flushes, span_i, dev, tag):
    """Phase O1: the stream through ``LSketch.insert`` batch by batch at
    one shard. The first two batches are replayed on a fresh CPU state
    and the last kernel-route batch on a CPU copy, through the plain
    versions, and compared leaf for leaf (outside the timed calls).
    Returns (the object, a CPU copy of its final state, numbers)."""
    obj = LSketch(cfg, insert_path="cuda", query_path="cuda", device=dev)
    last_k = max(i for i in range(len(flushes)) if i != span_i)
    routes, flush_s, clone = {"kernel": 0, "scan": 0}, [], None
    for i, (a, z) in enumerate(flushes):
        batch = stream.slice(a, z)
        if i == 0:
            clone = init_state(cfg, "cpu")
        elif i == last_k:
            clone = _to_cpu(obj.state)
        before = dict(eng.ROUTE_EDGES)
        _sync()
        t0 = time.perf_counter()
        obj.insert(*_columns(batch))
        _sync()
        flush_s.append(time.perf_counter() - t0)
        for k in routes:
            routes[k] += eng.ROUTE_EDGES[k] - before[k]
        if (eng.ROUTE_EDGES["scan"] != before["scan"]) != (i == span_i):
            raise AssertionError(f"object batch {i} took the wrong route")
        if i < 2 or i == last_k:
            saved = dict(eng.ROUTE_EDGES)
            eng.insert_batch(cfg, clone, batch, path="cuda")
            eng.ROUTE_EDGES.update(saved)
            bad = _differs(clone, obj.state)
            _log(f"phase O1 batch {i}: CPU replay through the plain "
                 f"versions vs the card, leaf for leaf: "
                 f"{'equal' if not bad else 'DIFFER ' + str(bad)}")
            if bad:
                raise AssertionError(f"object batch {i} differs in {bad}")
        if i == 1:
            clone = None
    n, total = len(stream), sum(flush_s)
    span_n = flushes[span_i][1] - flushes[span_i][0]
    kernel_s = total - flush_s[span_i]
    out = dict(edges_per_s=n / total,
               kernel_route_edges_per_s=routes["kernel"] / kernel_s,
               span_edges=span_n, span_ms=1e3 * flush_s[span_i],
               span_ms_per_edge=1e3 * flush_s[span_i] / span_n,
               batches=len(flushes), state_bytes=state_bytes(cfg))
    _log(f"phase O1 LSketch.insert: {n} edges in {len(flushes)} batches, "
         f"{total:.3f} s = {out['edges_per_s']:.0f} edges/s; kernel route "
         f"{routes['kernel']} edges in {kernel_s:.3f} s = "
         f"{out['kernel_route_edges_per_s']:.0f} edges/s; the straddling "
         f"batch ({span_n} edges, scan route) {out['span_ms']:.1f} ms = "
         f"{out['span_ms_per_edge']:.4f} ms an edge; state_bytes "
         f"{out['state_bytes']} {tag}")
    return obj, clone, out


def _scalar_call(obj, qi, kind, with_le, last, j):
    le = int(qi["le"][j]) if with_le else None
    if kind == "edge":
        return obj.edge_weight(int(qi["src"][j]), int(qi["src_label"][j]),
                               int(qi["dst"][j]), int(qi["dst_label"][j]),
                               le=le, last=last)
    if kind == "label":
        return obj.label_aggregate(int(qi["labels"][j]), le=le, last=last)
    return obj.vertex_weight(int(qi["v"][j]), int(qi["lv"][j]), le=le,
                             direction=kind[7:], last=last)


def object_scalar_queries(obj, qi, tag) -> dict:
    """Phase O2: N_SCALAR scalar calls of every kind x edge label x last in
    {None, 1} on the object; each equals the batched ``skt.query`` on the
    same handle, which equals the scan path on N_SCAN_SAMPLE queries. The
    planes are built once per horizon."""
    spec, n = obj.spec, N_SCALAR
    builds = skt.PLANES_BUILD_COUNTS["build"]
    us, mism = {}, 0
    for kind in KINDS:
        for with_le in (False, True):
            for last in (None, 1):
                _sync()
                t0 = time.perf_counter()
                got = [_scalar_call(obj, qi, kind, with_le, last, j)
                       for j in range(n)]
                us.setdefault(kind, []).append(
                    1e6 * (time.perf_counter() - t0) / n)
                q = query_batch(qi, kind, with_le, last, slice(0, n))
                batched = skt.query(spec, obj.handle, q, path="cuda").cpu()
                mism += int((torch.tensor(got, dtype=torch.int32)
                             != batched).sum())
                m = min(N_SCAN_SAMPLE, n)
                scan = skt.query(spec, obj.handle, query_batch(
                    qi, kind, with_le, last, slice(0, m)), path="scan")
                mism += int((scan.cpu() != batched[:m]).sum())
    builds = skt.PLANES_BUILD_COUNTS["build"] - builds
    out = {f"scalar_us_{k}": float(np.mean(v)) for k, v in us.items()}
    out.update(plane_builds=builds, scalar_mismatches=mism)
    _log(f"phase O2 scalar calls: {n} of each kind x edge label x last in "
         f"{{None, 1}}, us per call {json.dumps(us)}; equal to the batched "
         f"query and the scan path: mismatches={mism}; plane builds {builds}"
         f" for 2 horizons {tag}")
    if mism:
        raise AssertionError("scalar answers differ from the batched or "
                             "scan answers")
    if builds != 2:
        raise AssertionError(f"{builds} plane builds for 2 horizons")
    return out


def object_structural(obj, qi, tag) -> dict:
    """Phase O4: reachability of sampled in-window edges (all True),
    subgraph counts of edge triples (the minimum of their edge answers),
    and the scalar heavy hitters and heavy edges (the host reference)
    equal to the handle's analytics (the cell-decode kernel)."""
    cfg, spec = obj.cfg, obj.spec
    edge = skt.query(spec, obj.handle, query_batch(qi, "edge", False, None),
                     path="cuda").cpu().numpy()
    newest = qi["etime"] // cfg.subwindow_size == \
        qi["etime"].max() // cfg.subwindow_size
    cand = np.flatnonzero(newest & (edge > 0))
    if not len(cand):
        raise AssertionError("no in-window edge answers to sample")
    pick = np.random.default_rng(SEED + 3).choice(
        cand, min(N_OBJ_REACH, len(cand)), replace=False)
    t0 = time.perf_counter()
    reach = [obj.reachable(int(qi["src"][j]), int(qi["src_label"][j]),
                           int(qi["dst"][j]), int(qi["dst_label"][j]),
                           max_hops=REACH_HOPS) for j in pick]
    reach_ms = 1e3 * (time.perf_counter() - t0) / len(pick)
    if not all(reach):
        raise AssertionError("an in-window edge is not reachable")
    triples = np.arange(3 * N_SUBGRAPHS).reshape(N_SUBGRAPHS, 3)
    sub = [obj.subgraph_count([(int(qi["src"][j]), int(qi["src_label"][j]),
                                int(qi["dst"][j]), int(qi["dst_label"][j]))
                               for j in tr]) for tr in triples]
    if sub != [int(edge[tr].min()) for tr in triples]:
        raise AssertionError("subgraph counts differ from the minimum of "
                             "their edges")
    hh = {}
    for direction in ("out", "in"):
        vid, w = skt.heavy_vertices(spec, obj.handle, 16,
                                    direction=direction, path="cuda")
        hh[direction] = (obj.heavy_hitters(16, direction),
                         list(zip(vid.tolist(), w.tolist())))
    s, d, w = skt.heavy_edges(spec, obj.handle, 16, path="cuda")
    hh["edges"] = (obj.heavy_edges(16),
                   list(zip(s.tolist(), d.tolist(), w.tolist())))
    bad = [k for k, (a, b) in hh.items() if a != b]
    _log(f"phase O4 reachable on {len(pick)} sampled in-window edges: all "
         f"True, {reach_ms:.3f} ms a call; subgraph_count of "
         f"{N_SUBGRAPHS} edge triples equal to their edges' minimum; the "
         f"scalar heavy_hitters (out, in) and heavy_edges vs the handle's "
         f"analytics: {'equal' if not bad else 'DIFFER ' + str(bad)}; top "
         f"edge {hh['edges'][0][:1]} {tag}")
    if bad:
        raise AssertionError(f"scalar analytics differ: {bad}")
    return dict(reachable_ms=reach_ms)


def _reset(state) -> None:
    """Empty a plain LSketch state in place."""
    for x, v in zip(state.leaves(), (-1, 0, 0, -1, 0, 0, 0, -(2**30),
                                     -(2**30))):
        x.fill_(v)


def _plane_build_bytes(cfg, n_slots: int) -> int:
    """Bytes a one-shard plane build must move: C and P (and the pool's
    counters) at the in-window slots read once, the key plane read and
    written twin-leading, cw, pw and the pool planes written once."""
    d, c, Q = cfg.d, cfg.c, cfg.pool_capacity
    return n_slots * (d * d * 2 + Q) * 4 * (1 + c) + 2 * d * d * 2 * 4 + \
        (d * d * 2 + Q) * 4 * (1 + c)


def check_object_kernels(cfg, obj, clone, batch, qi, dev, tag) -> dict:
    """Phase O3: the edge probe (fused entry, with the label) and the
    vertex scan (both directions) at S = 1 on the object's planes against
    their plain versions, timed by CUDA events beside their byte bounds;
    then the single-sketch drop-ins (``insert_window_batch_pallas`` on
    fresh states, ``edge_query_pallas``/``vertex_query_pallas`` at
    last=2) on the card against the same calls on the CPU copy of the
    object's state (the plain versions), exactly."""
    planes = skt.query_planes(obj.spec, obj.handle, None)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    q = [t(qi[k]) for k in ("src", "src_label", "dst", "dst_label")]
    lab = t(qi["le"])
    pr = edge_probes(cfg, precompute(cfg, q[0], q[1]),
                     precompute(cfg, q[2], q[3]))
    le = hsh.edge_label_bucket(lab, cfg.c, cfg.seed)
    got = edge_query_kernel(cfg, planes, *q, lab)
    want = edge_query_plain(cfg, planes, *q, lab)
    _sync()
    e_mism, e_err = diff(zip(got, want))
    e_ms = event_ms(lambda: edge_query_kernel(cfg, planes, *q, lab), 50)
    e_plain = event_ms(lambda: edge_query_plain(cfg, planes, *q, lab), 5)
    e_bytes = probe_nbytes(cfg, pr, le, planes.key, 1,
                           (planes.pool_key, cfg.pool_probes))
    pre, lines = scan_lines(cfg, t(qi["v"]), t(qi["lv"]))
    v_args = (lines, pre.f.contiguous(), le, planes.key, planes.cw,
              planes.pw)
    scan = {}
    for direction in ("out", "in"):
        kw = dict(r=cfg.r, F=cfg.F, direction=direction)
        got = vertex_scan_kernel_sharded(*v_args, **kw)
        want = vertex_scan_plain(*v_args, **kw)
        _sync()
        m, err = diff(zip(got, want))
        scan[direction] = dict(
            mismatches=m, max_abs_err=err,
            ms=event_ms(lambda: vertex_scan_kernel_sharded(*v_args, **kw),
                        20),
            plain_ms=event_ms(lambda: vertex_scan_plain(*v_args, **kw), 3),
            nbytes=scan_nbytes(cfg, lines, pre.f, le, planes.key,
                               direction))
    del got, want

    # the insert drop-in on fresh states: the card against the CPU
    small = batch.slice(0, DROP_IN_EDGES)
    widx = int(small.time[0]) // cfg.subwindow_size
    fresh = init_state(cfg, dev)
    host = insert_window_batch_pallas(cfg, init_state(cfg, "cpu"), small,
                                      widx)
    insert_window_batch_pallas(cfg, fresh, small, widx)
    i_mism = len(_differs(host, fresh))
    del host
    _reset(fresh)  # the kernel's bytes for these inputs, on a scratch run
    one = fresh.map(lambda x: x.unsqueeze(0))
    args, probes, bcounts = insert_args(cfg, obj.spec, small, (one,), dev)
    sketch_insert_kernel_sharded(*args, one.key, one.C, one.P,
                                 args[3].shape[1])
    i_bytes, _ = insert_nbytes(cfg, probes, args, bcounts, one)
    del one

    def timed_insert():
        _reset(fresh)
        return event_ms(lambda: insert_window_batch_pallas(cfg, fresh, small,
                                                           widx))

    i_runs = [timed_insert() for _ in range(3)]
    del fresh

    # the query drop-ins at last=2, each building its planes
    e3 = (q[0], q[2], (q[1], q[3], lab))
    vq = (t(qi["v"]), (t(qi["lv"]), lab))
    calls = {"edge_query_pallas": (e3, lambda st, a: edge_query_pallas(
        cfg, st, *a, last=2))}
    for direction in ("out", "in"):
        calls[f"vertex_query_pallas[{direction}]"] = (
            vq, lambda st, a, dr=direction: vertex_query_pallas(
                cfg, st, *a, direction=dr, last=2))
    drop, state = {}, obj.state
    for name, (a, fn) in calls.items():
        a_cpu = tuple(x.cpu() if isinstance(x, torch.Tensor) else
                      tuple(y.cpu() for y in x) for x in a)
        got = fn(state, a)
        _sync()
        t0 = time.perf_counter()
        want = fn(clone, a_cpu)
        plain_s = time.perf_counter() - t0
        m, _ = diff((x.cpu(), y) for x, y in zip(got, want))
        drop[name] = dict(mismatches=m, ms=float(np.median(
            [event_ms(lambda: fn(state, a)) for _ in range(5)])),
            cpu_plain_ms=1e3 * plain_s)
    n_slots = int(valid_slot_mask(cfg, state, 2).sum())
    plane_bytes = _plane_build_bytes(cfg, n_slots)
    i_ms = float(np.median(i_runs))
    _log(f"phase O3 at S=1: edge_query (fused, with the label) vs plain: "
         f"mismatches={e_mism}; {e_ms:.4f} ms (CUDA events, 50 launches), "
         f"byte bound {1e3 * e_bytes / HBM_BYTES_PER_S:.7f} ms, plain "
         f"{e_plain:.3f} ms; vertex_scan out/in vs plain: mismatches "
         f"{scan['out']['mismatches']}/{scan['in']['mismatches']}; "
         f"{scan['out']['ms']:.4f}/{scan['in']['ms']:.4f} ms, byte bound "
         f"{1e3 * scan['out']['nbytes'] / HBM_BYTES_PER_S:.4f}/"
         f"{1e3 * scan['in']['nbytes'] / HBM_BYTES_PER_S:.4f} ms, plain "
         f"{scan['out']['plain_ms']:.3f}/{scan['in']['plain_ms']:.3f} ms "
         f"{tag}")
    _log(f"phase O3 drop-ins vs their plain versions on the CPU: "
         f"insert_window_batch_pallas ({len(small)} edges, fresh state) "
         f"mismatches={i_mism}, {i_ms:.4f} ms median of 3 "
         f"({[round(r, 4) for r in i_runs]}), its kernel's byte bound "
         f"{1e3 * i_bytes / HBM_BYTES_PER_S:.5f} ms; the query drop-ins "
         f"(each builds its planes, bound "
         f"{1e3 * plane_bytes / HBM_BYTES_PER_S:.4f} ms for {n_slots} "
         f"slots): {json.dumps(drop)} {tag}")
    if e_mism or i_mism or any(v["mismatches"] for v in scan.values()) or \
            any(v["mismatches"] for v in drop.values()):
        raise AssertionError("a single-sketch entry disagrees with its "
                             "plain version")
    qd = drop["edge_query_pallas"]
    vo, vi = drop["vertex_query_pallas[out]"], drop["vertex_query_pallas[in]"]
    return {
        "sketch_query_kernel": dict(
            mismatches=e_mism + qd["mismatches"], max_abs_err=e_err,
            ms=e_ms, plain_ms=e_plain, nbytes=e_bytes, drop_in_ms=qd["ms"],
            drop_in_cpu_plain_ms=qd["cpu_plain_ms"],
            drop_in_bound_ms=1e3 * (plane_bytes + e_bytes) /
            HBM_BYTES_PER_S, shape=f"S=1 nq={len(qi['src'])} fused"),
        "vertex_scan_kernel": dict(
            mismatches=sum(v["mismatches"] for v in scan.values()) +
            vo["mismatches"] + vi["mismatches"],
            max_abs_err=max(v["max_abs_err"] for v in scan.values()),
            ms=scan["out"]["ms"], plain_ms=scan["out"]["plain_ms"],
            nbytes=scan["out"]["nbytes"], direction="out",
            ms_in=scan["in"]["ms"], plain_ms_in=scan["in"]["plain_ms"],
            bound_ms_in=1e3 * scan["in"]["nbytes"] / HBM_BYTES_PER_S,
            drop_in_ms=vo["ms"], drop_in_ms_in=vi["ms"],
            drop_in_cpu_plain_ms=vo["cpu_plain_ms"],
            shape=f"S=1 nq={len(qi['v'])}"),
        "insert_drop_in": dict(mismatches=i_mism, ms=i_ms, runs=i_runs,
                               bound_ms=1e3 * i_bytes / HBM_BYTES_PER_S,
                               edges=len(small)),
    }


def object_gss(stream, flushes, qi, dev, tag):
    """Phase O5's card half: ``GSS.insert`` of the same batches (times
    normalized to 0, so every batch is one subwindow and takes the kernel
    route in the one bin of the one block), a CPU copy of the state after
    each of the first two and each batch's new claims; then edge and
    vertex queries and heavy edges (the cell-decode kernel at one block)
    against the scan path."""
    g = GSS(GSS_CFG, device=dev)
    g.insert_path = g.query_path = "cuda"
    snaps, claims, flush_s = [], [], []
    for i, (a, z) in enumerate(flushes):
        occupied = int((g.state.key != -1).sum())
        _sync()
        t0 = time.perf_counter()
        g.insert(*_columns(stream.slice(a, z)))
        _sync()
        flush_s.append(time.perf_counter() - t0)
        claims.append(int((g.state.key != -1).sum()) - occupied)
        if i < 2:
            snaps.append(_to_cpu(g.state))
    cap = 1 << (TABLE_LOG2_MAX - 1)
    past = [max(0, c - cap) for c in claims]
    mism = 0
    for kind in ("edge", "vertex-out", "vertex-in"):
        q = query_batch(qi, kind, False, None, slice(0, N_SCALAR))
        got = skt.query(g.spec, g.handle, q, path="cuda").cpu()
        want = skt.query(g.spec, g.handle, q, path="scan").cpu()
        mism += int((got != want).sum())
    top = skt.heavy_edges(g.spec, g.handle, 16, path="cuda")
    want = skt.heavy_edges(g.spec, g.handle, 16, path="scan")
    mism += sum(int((a.cpu() != b.cpu()).sum()) for a, b in zip(top, want))
    n = len(stream)
    out = dict(edges_per_s=n / sum(flush_s),
               largest_bin=max(z - a for a, z in flushes), claims=claims,
               claims_past_capacity=past, state_bytes=state_bytes(GSS_CFG),
               query_mismatches=mism)
    _log(f"phase O5 GSS.insert ({GSS_CFG.d} x {GSS_CFG.d}, one block): "
         f"{n} edges in {len(flushes)} batches, {sum(flush_s):.3f} s = "
         f"{out['edges_per_s']:.0f} edges/s; each batch one bin (largest "
         f"{out['largest_bin']} edges); new claims per batch {claims}, past "
         f"the claim table's {cap}: {past}; edge and vertex (out, in) "
         f"queries and heavy_edges (cell decode at one block) vs the scan "
         f"path: mismatches={mism}; state_bytes {out['state_bytes']} {tag}")
    if mism:
        raise AssertionError("GSS answers differ from the scan path")
    return g, snaps, out


def check_gss(stream, flushes, snaps, replay, dev, tag) -> dict:
    """Phase O5's checks: the card's GSS after each of the first two
    batches against the child's CPU replay, leaf for leaf; the insert
    kernel's time on the first batch (CUDA events, median of
    INSERT_REPS launches from the pre-flush key plane)."""
    proc, recv = replay
    cpu_s = []
    for i, snap in enumerate(snaps):
        leaves, sec = recv.recv()
        cpu_s.append(sec)
        bad = _differs(LSketchState(*[torch.from_numpy(x) for x in leaves]),
                       snap)
        _log(f"phase O5 GSS batch {i}: the CPU replay (plain versions, a "
             f"child process, {sec:.1f} s) vs the card, leaf for leaf: "
             f"{'equal' if not bad else 'DIFFER ' + str(bad)}")
        if bad:
            raise AssertionError(f"GSS batch {i} differs in {bad}")
    proc.join(timeout=60)
    spec = skt.make_spec("gss", config=GSS_CFG)
    scratch = init_leaves(GSS_CFG, (1,), dev)
    batch = _degenerate_batch(stream.slice(*flushes[0]))
    args, _, bcounts = insert_args(GSS_CFG, spec, batch, (scratch,), dev)
    B = args[3].shape[1]

    def launch():
        scratch.key.fill_(-1)
        return event_ms(lambda: sketch_insert_kernel_sharded(
            *args, scratch.key, scratch.C, scratch.P, B))

    runs = [launch() for _ in range(INSERT_REPS)]
    fill = int(bcounts.max())
    out = dict(kernel_ms=float(np.median(runs)), kernel_runs=runs,
               bin_fill=fill, cpu_replay_s=cpu_s)
    _log(f"phase O5 GSS insert kernel on the first batch (one bin of "
         f"{fill} edges): median {out['kernel_ms']:.3f} ms over "
         f"{INSERT_REPS} launches ({[round(r, 3) for r in runs]}), "
         f"{1e3 * out['kernel_ms'] / max(fill, 1):.4f} us per edge {tag}")
    return out


def object_lgs(stream, flushes, qi, dev, tag) -> dict:
    """Phase O6: ``LGS.insert`` of the same batches on the card (a
    count-min scatter-add) and on the CPU; the states leaf for leaf, and
    edge and vertex (out, in) answers with and without the edge label at
    last in {None, 1}."""
    objs, secs = {}, {}
    for where in (dev, "cpu"):
        obj = LGS(LGS_CFG, device=where)
        flush_s = []
        for a, z in flushes:
            _sync()
            t0 = time.perf_counter()
            obj.insert(*_columns(stream.slice(a, z)))
            _sync()
            flush_s.append(time.perf_counter() - t0)
        objs[str(where)], secs[str(where)] = obj, sum(flush_s)
    card, host = objs[str(dev)], objs["cpu"]
    bad = _differs(host.state, card.state)
    sl = slice(0, N_SCALAR)

    def answers(o, le, last):
        return [o.edge_weight(qi["src"][sl], qi["src_label"][sl],
                              qi["dst"][sl], qi["dst_label"][sl], le=le,
                              last=last)] + [
            o.vertex_weight(qi["v"][sl], qi["lv"][sl], le=le, direction=dr,
                            last=last) for dr in ("out", "in")]

    mism = 0
    for le in (None, qi["le"][sl]):
        for last in (None, 1):
            mism += sum(int((a != b).sum()) for a, b in zip(
                answers(card, le, last), answers(host, le, last)))
    n = len(stream)
    out = dict(edges_per_s=n / secs[str(dev)],
               cpu_edges_per_s=n / secs["cpu"],
               state_bytes=lgs_state_bytes(LGS_CFG), mismatches=mism)
    _log(f"phase O6 LGS.insert ({LGS_CFG}): {n} edges in {len(flushes)} "
         f"batches, {secs[str(dev)]:.3f} s = {out['edges_per_s']:.0f} "
         f"edges/s (the CPU replay {secs['cpu']:.3f} s); state vs the CPU "
         f"replay, leaf for leaf: "
         f"{'equal' if not bad else 'DIFFER ' + str(bad)}; edge and vertex (out, in) answers with and without the label "
         f"at last in {{None, 1}}: mismatches={mism}; state_bytes "
         f"{out['state_bytes']} {tag}")
    if bad or mism:
        raise AssertionError("the card's LGS differs from its CPU replay")
    return out


def object_phase(dev, tag):
    """Phase O: the object API at one shard over the COMFS analog at its
    own length, in batches cut at subwindow boundaries plus one straddling
    one. Launch counts run from 0 over the object path (O1, O2, O4, O5's
    card half, O6); the comparisons with plain versions come after.
    Returns (the kernel rows, the launches, the numbers)."""
    cfg = CFG
    stream = generate(dataclasses.replace(COMFS, n_edges=OBJ_EDGES),
                      seed=SEED, weighted=True)
    cuts, span_i = flush_cuts(stream.time, cfg.subwindow_size)
    flushes = list(zip(cuts[:-1], cuts[1:]))
    qi = query_inputs(cfg, stream)
    replay = start_gss_replay(stream, flushes)
    try:
        def path():
            obj, clone, o1 = object_ingest(cfg, stream, flushes, span_i,
                                           dev, tag)
            o2 = object_scalar_queries(obj, qi, tag)
            o4 = object_structural(obj, qi, tag)
            gss, snaps, o5 = object_gss(stream, flushes, qi, dev, tag)
            del gss
            o6 = object_lgs(stream, flushes, qi, dev, tag)
            return obj, clone, snaps, dict(lsketch=dict(o1, **o2, **o4),
                                           gss=o5, lgs=o6)

        names = OBJECT_PATH if dev.type == "cuda" else ()
        (obj, clone, snaps, numbers), launches = count_launches(names, path)
        _log(f"phase O object-path launches: {launches} {tag}")
        spec1 = obj.spec
        rows = {"sketch_insert_kernel": check_insert_kernel(
            cfg, spec1, [stream.slice(*f) for f in flushes[:2]], dev, tag,
            phase="O1")}
        torch.cuda.empty_cache()
        rows.update(check_object_kernels(cfg, obj, clone,
                                         stream.slice(*flushes[0]), qi, dev,
                                         tag))
        rows["sketch_insert_kernel"]["drop_in"] = rows.pop("insert_drop_in")
        rows["sketch_insert_kernel"]["mismatches"] += \
            rows["sketch_insert_kernel"]["drop_in"]["mismatches"]
        del obj, clone
        torch.cuda.empty_cache()
        numbers["gss"].update(check_gss(stream, flushes, snaps, replay, dev,
                                        tag))
    finally:
        if replay[0].is_alive():
            replay[0].terminate()
        replay[0].join()
    return rows, launches, numbers


def deployment():
    """The spec, the seeded stream and its flushes ``[(a, z)]``, with the
    index of the boundary-spanning flush."""
    spec = skt.make_spec("lsketch", n_shards=N_SHARDS, config=CFG)
    stream = generate(dataclasses.replace(COMFS, n_edges=N_EDGES), seed=SEED,
                      weighted=True)
    cuts, span_i = flush_cuts(stream.time, CFG.subwindow_size)
    return spec, stream, list(zip(cuts[:-1], cuts[1:])), span_i


def kernel_entries(results: dict, launches: dict) -> list:
    """The ``kernels`` list of the JSON line. Each bound is the larger of
    the bytes the check counted over HBM_BYTES_PER_S and the time of the
    operations it counted, where it counted any (``ops_ms``, at the rate
    ``ops_rate`` names); ``library_ms`` is null where no single PyTorch
    call computes the kernel's function."""
    out = []
    for kname, r in results.items():
        bytes_ms = 1e3 * r["nbytes"] / HBM_BYTES_PER_S
        ops_ms = r.get("ops_ms", 0.0)
        out.append(dict(
            name=kname, route="cuda", **KERNELS[kname],
            launches=launches[kname],
            **{k: v for k, v in r.items()
               if k not in ("nbytes", "ops_ms", "library_ms")},
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="operations" if ops_ms > bytes_ms else "bytes",
            library_ms=r.get("library_ms")))
    return out


def main() -> int:
    """The smoke run: the full deployment, on the card only."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the models are f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()  # phase 1
    name = torch.cuda.get_device_name(0)
    _log(f"card: {card} | torch.cuda.get_device_name(0)={name} | "
         f"torch {torch.__version__} cuda {torch.version.cuda}")
    tag = f"[{card}]"

    t0 = time.perf_counter()  # phase 2
    build.build(force=True)
    build.load_library()
    _log(f"build: {len(build.PTXAS_LOG)} sources compiled in parallel and "
         f"linked in {time.perf_counter() - t0:.1f} s")
    for src, log in build.PTXAS_LOG.items():
        _log(f"--- nvcc -Xptxas -v {src}\n{log.strip()}")
    flash_build = flash_build_report()

    cfg = CFG
    spec, stream, flushes, span_i = deployment()
    _log(f"deployment: {cfg} x {spec.n_shards} shards; stream COMFS analog, "
         f"{N_EDGES} edges (cut from the real stream's {FULL_STREAM_EDGES} "
         f"for the time limit), {len(flushes)} flushes, subwindow "
         f"{cfg.subwindow_size} time units")

    results = {"sketch_insert_kernel_sharded": check_insert_kernel(
        cfg, spec, [stream.slice(*f) for f in flushes[:2]], dev, tag)}
    torch.cuda.empty_cache()

    # the main path: every launch count from 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    qi = query_inputs(cfg, stream)

    capture = PoolCapture()

    def main_path():
        state, rate, k_rate = ingest_stream(cfg, spec, stream, flushes,
                                            span_i, dev, tag, capture)
        return state, rate, k_rate, run_queries(spec, state, qi, tag)

    (state, edges_per_s, kernel_edges_per_s, answers), launches = \
        count_launches(MAIN_PATH, main_path)
    peak = torch.cuda.max_memory_allocated()
    _log(f"phase 5 main-path launches: {launches}; peak device memory "
         f"{peak} bytes {tag}")
    results.update(check_pool_kernel(capture, tag))  # phase 3b
    del capture

    check_scan_path(spec, state, qi, answers)
    results.update(check_query_kernels(cfg, spec, state, qi, dev, tag))

    skt.clear_plane_cache(state)  # phase 6b: the analytics path
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got, a_launches = count_launches(ANALYTICS_PATH, lambda: analytics_path(
        cfg, spec, state, qi, answers, tag))
    _log(f"phase 6b analytics-path launches: {a_launches} {tag}")
    results.update(check_analytics(cfg, spec, state, got, tag))
    a_peak = torch.cuda.max_memory_allocated()
    _log(f"phase 6b peak device memory {a_peak} bytes {tag}")
    launches["cell_decode_kernel_sharded"] = \
        a_launches["cell_decode_kernel_sharded"]
    skt.clear_plane_cache(state)
    torch.cuda.empty_cache()

    profile = profile_ingest(spec, state, stream, flushes, tag)
    del state  # phase O and the LM phases start from an empty card
    torch.cuda.empty_cache()

    obj_rows, o_launches, obj_out = object_phase(dev, tag)  # phase O
    results.update(obj_rows)
    launches.update({k: o_launches[w] for k, w in OBJECT_KERNELS.items()})
    torch.cuda.empty_cache()

    results.update(check_flash_kernel(dev, tag))  # L1
    results["flash_attention_kernel"]["build"] = flash_build
    cfg_lm, params = lm_model(dev, tag)  # L2
    lm_out, tokens, head = prefill_phase(cfg_lm, params, dev, tag)
    check_prefill_on_the_card(cfg_lm, lm_out)
    launches["flash_attention_kernel"] = lm_out["prefill_flash_launches"]
    lm_out.update(serve_phase(cfg_lm, params, tokens, head, dev, tag))  # L3
    del params, head
    torch.cuda.empty_cache()

    seconds = time.perf_counter() - t_start
    _log(f"total {seconds:.1f} s")
    print(json.dumps({"kernels": kernel_entries(results, launches),
                      "card": card, "peak_memory_bytes": peak,
                      "analytics_peak_memory_bytes": a_peak,
                      "ingest_edges_per_s": edges_per_s,
                      "ingest_kernel_route_edges_per_s": kernel_edges_per_s,
                      "object": obj_out, **profile, **lm_out,
                      "seconds": seconds}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
