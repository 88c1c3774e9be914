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
     forward's and backward's instances must each hold tensor-core MMAs
     (``cuobjdump -sass``), their registers and spills are logged;
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
  C. the mesh-resident collective path on the same handle, over a
     one-rank NCCL group on this card (``distributed.ranks.init_group``;
     4 shards divide it, so the handle is sharded, not replicated), every
     kernel launch of C1-C4 and C6's card half counted from 0: C1 the
     handle ``place``d (a view at one rank) answers phase 5's batches and
     each kind's HORIZONS sweep on ``path="collective"``, each equal to
     phase 5's answer (µs a query beside the cuda path's, the
     ``all_reduce`` and ``all_gather`` calls of each batch and their
     CUDA-event ms); C2 phase 6b's top-k calls on the collective path,
     each equal to phase 6b's; C3 phase 4's stream in phase 4's flushes
     into a fresh placed handle, equal to phase 4's state leaf for leaf
     with its context kept, a collective query after each of the last
     COLLECTIVE_TAIL flushes whose planes (folded or built) equal a cold
     build, edges/s beside phase 4's; C4 ``SketchServer(mesh=...,
     query_path="collective")`` fed phase 4's stream answers phase V's
     mixed requests, each equal to ``skt.query(path="cuda")`` on phase
     4's state; C5 ``serve --mode sketch --shards 4 --mesh 1
     --collective`` exits 0 and ``--mesh 2`` on a one-card box exits
     non-zero with the reference's message; C6
     ``RouterTelemetry(mesh=...)`` at DeepSeek-V2's 160 routed experts
     (top-6) fed TELEMETRY_STEPS seeded skewed routing steps of
     TELEMETRY_TOKENS tokens with a ``CapacityController.update`` after
     each, its collective loads every TELEMETRY_CHECK steps equal to a
     CPU copy's on the scan path and its final state and capacity
     factors equal to a host-resident twin's (µs a step of ingest,
     update and ``load_vector``); the phase's peak device memory; the
     group is destroyed at the end;
  7. a profiler trace of two replayed flushes (where ingest time goes:
     host ms by stage, the pool pass's share of the trace's host time,
     the card's busy share and the number of cudaLaunchKernel calls);
  S. (the 4-shard state freed) the streaming loop on a fresh handle of
     the deployment: the COMFS analog at its own 500,000 edges through
     ``AsyncIngestor`` in batches of <= 16,384 cut at subwindow
     boundaries; after each dispatched batch a 1,024-query edge batch at
     last=None and a sweep at last in (None, 1, 4) on planes kept by
     flush deltas (a flush that enters a new subwindow moves the ring and
     its planes are built: the rounds of each kind must be the predicted
     ones, and some folded). S2 every 8th round and the last: the planes
     and answers against cold builds, exactly; S3 the final answers
     one-sided against ``GroundTruth`` (est >= truth - pool_lost); S4
     pure-ingest passes of ``AsyncIngestor`` and synchronous ``ingest``
     (sync, async, async, sync, then one profiled pass of each: edges/s
     and the card's busy share), each final state equal to the loop's
     leaf for leaf; fold and build ms, the bytes of a delta link and the
     peak device memory;
  R. (the S state freed) skew-aware routing at the deployment: phase 4's
     stream in phase 4's flushes through ``AsyncIngestor`` with the
     heavy-key detector (HEAT_THRESHOLD, SPLIT_REPLICAS); logs the splits
     and the batch each came in, ``PARTITION_STATS`` beside the unrouted
     partition of the same batches, per-shard pool use beside phase 4's
     and edges/s; the final state equals a synchronous ``ingest`` replay
     of the same batches under the spec each was partitioned with, leaf
     for leaf, and N_QUERIES edge and vertex-out answers are one-sided
     against the exact truth (est >= truth - pool_lost);
  T. (the R states freed) the tenant pool: TENANTS tenants at TENANT_CFG
     and TENANT_SHARDS shards in a ``TenantPool`` of TENANTS slots (the
     deployment's 18.4 GB), tenant t the COMFS analog from seed t cut to
     TENANT_EDGES edges on a clock TENANT_OFFSET * t subwindows ahead,
     its batches cut at its own boundaries, the tenant spec routed by the
     detector over the first round (and ``recommend_budget``'s table,
     logged). T1 the pooled ingest (no scan-route edge); T2 each tenant
     in turn against a standalone handle fed the same batches: the state
     leaf for leaf, every ``query_many`` answer (kind x last x edge
     label, TENANT_QUERIES a tenant) and ``top_k_many`` (k=16, and a
     sweep); T3 a pooled edge dispatch is one probe launch, a vertex one
     one scan launch, a ``top_k_many`` one decode; T4 the grouped entries
     of the edge probe and the vertex scan against their plain versions
     on the pool's planes, timed beside their byte bounds; T5 a tenant
     past the pool's slots evicts the LRU tenant through a checkpoint,
     which a query readmits into another slot with the same answers
     (bytes, save and restore seconds); T6 pooled against standalone
     query and ingest costs, recorded;
  V. the sketch server at the deployment: V1 phase 4's stream in phase
     4's flushes through ``SketchServer(heat_threshold=HEAT_THRESHOLD,
     split_replicas=SPLIT_REPLICAS, horizons=SERVER_HORIZONS)``; V2
     SERVER_REQUESTS interleaved requests (every kind, with and without
     the edge label, last in SERVER_LASTS) in one flush and again kind by
     kind (µs a request; one probe launch a flush, one scan launch a
     (direction, horizon)); V3 every
     answer equal to ``skt.query`` on the served state, samples equal to
     the scan path, ``top_k`` equal to ``skt.heavy_*`` on the scan path,
     reachability of sampled in-window edges, ``budget_report()`` and
     ``serving_summary()``; V4 pool mode at phase T's tenants, every
     answer equal to a per-tenant ``query_many``; V5 ``serve --mode
     sketch`` (CLI_ARGS: 5,000 edges) for every kind and in pool mode
     with a sweep, as concurrent processes (each must exit 0); V6
     ``BigramSketch`` on the card against a CPU twin;
  M. merge, reshard and restore: M1 a tenant at phase T's size resharded
     on the card 2 -> 4, 2 -> 1 and with the prune, each leaf for leaf
     against the plain host replay of a CPU copy (seconds of both, split
     into decode, claim and scatter); M3 the tenant's checkpoint
     restored at 4 and 1 shards (equal to M1's reshards), GSS at GSS_CFG
     resharded 1 -> 2 against the plain replay, LGS at LGS_CFG restored
     2 -> 1 (``merge_all``) and 2 -> 3, ``merge_all`` against its CPU
     copy's; M2 phase V's state resharded 4 -> 4 under
     ``budget_report().routing`` and 4 -> 2: per-shard occupancy before
     and after, vertex and label answers conserved where nothing was
     dropped, edge answers one-sided against ``GroundTruth``;
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
     prompt tokens and 32 greedy new tokens; the peak memory of one
     decode step at that batch and a profiler trace of 8 (where a step's
     time goes); then the prompt's
     first 128 tokens through ``serve_step`` on a 1-slot cache agree with
     L2's forward logits at those positions;
  L4. Gemma-3 4B at its published widths and depth (34 layers: 29 local
     of window 1024, 5 global; f32 weights from a seed): L2 and L3 at
     8,192 prompt tokens (5 flash launches at dh=256, the local layers on
     the plain masked attention, as in the JAX package), then the model
     cut to its first period of 6 layers (same weights) takes a
     1,280-token prompt through ``serve_step`` on a 1-slot 2,048-position
     cache, wrapping the 1,024-row local rings, against its forward;
  L5. DeepSeek-V2 at its published widths cut to 3 layers (the dense
     layer, 2 MoE layers of 160 routed + 2 shared experts, MLA): a
     2,048-token prefill drop-free and at the config's capacity factor
     1.25 (the dropped share), decode of 128 tokens against the drop-free
     prefill, the telemetry summing to tokens x 6 x 2 and ingested by a
     ``RouterTelemetry`` on the card and one on the CPU, loads equal;
  L6. Kimi-K2, Jamba, xLSTM, phi-3-vision (with a vision prefix) and
     SeamlessM4T (through ``encode_memory`` and ``serve_step(memory=)``)
     at their reduced configs, weights drawn on the CPU and carried to the
     card: forward and ``serve_step`` card against CPU, decode against
     the drop-free prefill, each within LOGIT_TOL; each global GQA layer
     one flash launch (the kernel row's ``launches_lm_archs``);
  L7. the flash backward (``csrc/flash_attention_bwd.cu``: dq and D, then
     dk and dv a KV head's group at a time) against
     ``flash_attention_backward_plain`` from the forward's own out and lse
     on SmolLM-135M's training launch, Qwen3-8B's, Gemma-3's dh=256,
     phi-3-vision's dh=96, dh=16, a ragged length, non-causal and bf16:
     dq, dk and dv each within FLASH_BWD_TOL of the largest |plain|, and
     a second launch on the same inputs bit-identical (no atomics);
     CUDA-event medians beside the plain backward, SDPA's backward and the
     bound (2.5 x the forward's operations at the card's tensor-core rate
     for the type: bf16 over 989 TFLOP/s, f32 as split-TF32); the
     forward with no lse (serving's) at L1's shape beside L1's time;
  L8. ``launch.train.train`` on SmolLM-135M at its published widths and
     depth (30 layers, d 576, 9/3 heads, dh 64, vocab 49,152; f32 weights
     from a seed): 20 steps of 8 x 4,096 tokens (the train_4k cell's
     length; its batch of 256 cut to 8) in 2 microbatches, async saves
     every 10 steps: the loss finite and its last 5 steps' mean below the
     first 5's; ms a step, tokens/s, model FLOP/s (6 params tokens plus
     attention) against the f32 peak, peak memory, one forward and one
     backward flash launch a layer a microbatch; one more step of the
     trained state under the profiler: device kernel time by group (flash
     backward, flash forward, matmuls, the rest) and the card's busy
     share. Then one step at 2 x
     2,048 from one seeded state and batch with ``attn_impl="kernel"`` and
     ``"plain"``: loss and grad_norm within TRAIN_REL, every updated leaf
     within TRAIN_PARAM_TOL;
  L9. the MoE trainer with router telemetry, Kimi-K2 at its reduced config
     as ``tests/test_system.py::test_train_moe_with_telemetry`` runs it (12
     steps, ``controller_every=4``, 2 x 32), on the card and on the CPU
     from one seed: losses within LOGIT_TOL, the telemetry matrices equal
     as int32, ``RouterTelemetry.load_vector`` and the capacity factors
     equal; the insert, pool and scan launches of the card's run;
  L10. the sharded trainer over a one-rank NCCL group (``launch.mesh``,
     ``launch.shardings``, ``step_fns.shard_state``/
     ``make_sharded_train_step``): ``train(mesh=)`` on SmolLM-135M as L8
     runs it (seed, batches, microbatches and schedule) for
     SHARDED_STEPS steps, its losses within TRAIN_REL of L8's first and
     its ms a step beside L8's, one forward and one backward flash launch
     a layer a microbatch; one step at L8's check shape, sharded against
     unsharded from one state and batch (TRAIN_REL, TRAIN_PARAM_TOL);
     SHARDED_MOE_STEPS steps of reduced Kimi-K2 through the MoE's
     expert-parallel branch (its expert slice and all-gather over the
     one-rank model group, counted) against the unsharded steps; the CLI
     ``launch.train --mesh 1`` for SHARDED_CLI_STEPS steps at L8's
     shapes, its first loss L8's;
  L11. a crash and a restore: L8's trainer for RESTART_STEPS steps
     unbroken, then under ``distributed.fault_tolerance.RestartLoop``
     with a checkpoint every RESTART_CKPT_EVERY steps and a fault
     injected once after step RESTART_FAULT_AFTER; one restart, the last
     step RESTART_STEPS, the losses the unbroken run's bit for bit, the
     restart's seconds; ``StragglerPolicy`` fed the runs' step seconds
     and ``HeartbeatMonitor`` the restarted run's step starts report no
     straggler and no dead host; one forward and one backward flash
     launch a layer a microbatch for each step run;
  L12. tensor parallelism over "model" on this one card
     (``step_fns.make_sharded_train_step`` with several model ranks,
     ``sharded_grads``): SmolLM-135M at full width and depth, TP_STEPS
     steps of TP_BATCH x TP_SEQ on each mesh of TP_MESHES, the model
     ranks as spawned processes sharing the card over a gloo group with
     CUDA tensors (NCCL takes one card a rank; gloo stages them through
     host memory): at 1 x 3 every rank runs 3 of the 9 heads, at 1 x 2
     the "sp" fallback runs each rank's 1,024 query rows at its
     ``q_offset``. Each mesh from L8's seed against the one-device
     gradient of the same state and batch (loss, gradient norm and every
     rank's gradient shards within TRAIN_REL of each leaf's largest
     magnitude); each rank's flash calls on its local shapes, one
     forward and one backward launch a layer a step; step ms, rank 0's
     peak memory and its collectives' calls and bytes; then, in this
     process, the flash forward (out and lse) and backward pair at every
     call shape and ``q_offset`` L12's ranks launch, against the plain
     versions on the same card tensors at L1's and L7's tolerances
     (``check_flash_tp_rows``; rows "L12 ..." in the two kernels' cases);
  L13. sharded serving on this one card (``step_fns.init_sharded_params``,
     ``make_sharded_prefill_step``, ``make_sharded_serve_step``,
     ``DecodeServer(mesh=)``), SERVE_TP_PARTS' ranks as one gloo group of
     spawned processes sharing the card, each part against the
     one-device path computed on the card first: (a) Qwen3-8B at 1 x 2,
     a 2,048-token split prefill (one flash launch a global layer a
     rank, on the rank's heads) and the server on SERVE_TP; (b)
     xLSTM-1.3B at 1 x 2, one period of its pattern, the mixers on their
     channel shards: prefill, server and the split train gradient; (c)
     Gemma-3 4B at 2 x 1, one period of 6 layers, 4 decode steps of one
     sequence of long_500k's slots (where the estimated peaks fit) with
     the caches' sequence over "data"; ms a step, the share inside
     gloo's collectives, rank 0's peak memory and collectives, every
     rank's flash launches; then the flash forward at (a)'s call shape
     against its plain version (``check_flash_serve_rows``; rows "L13
     ..." in the kernel's cases);
  E1. the cell estimator (``launch.dryrun.estimate``, on the host's meta
     tensors) at L8's cell, L2's prefill, L3's decode step, L12's 1 x 3
     cell and L13's prefill and decode cells (rank 0) against their
     measurements in this run: the
     peak memory within ESTIMATE_MEMORY_MARGIN and its split, the FLOPs
     against the run's own counts, L8's ms a step against the roofline's
     bound;
  8. one JSON line of the kernels and the end-to-end numbers, the card
     line, and the result line.

Phases V, M and C count launches, each run from 0, on five more paths:
the single-handle server (V1-V2), the pool-mode server (V4),
``BigramSketch`` (V6), the reshards (M1, M2, M3 summed) and the
collective path (C1-C4, C6); each kernel row gains them as
``launches_new_paths``.
Seven paths count kernel launches, each from 0 just before it: the
sketch path (phases 4 and 5), the analytics path (phase 6b, before its
comparisons), the streaming loop (phase S1-S2, reported in its numbers),
the routed ingest (phase R, with its queries), the pool path (phase
T1-T3; the grouped rows' launches), the object path (phase O, before its
comparisons; the single-sketch rows' launches) and the prefill (L2, the
kernel forward); the trainer (L8, the flash forward and backward) and
the MoE trainer (L9, the telemetry's kernels), the sharded trainer
(L10), the restarted trainer (L11, with its unbroken twin), the
tensor-parallel trainer (L12, every rank's launches summed) and sharded
serving (L13, likewise) each count from 0 too, in every row's
``launches_train``. Each kernel's
``launches`` in the JSON line is from the path it was ported for (the
flash backward's from L8).
TF32 is off throughout (the models are f32), except in the one forward
of L2 that shows the tolerance would catch it.
Exits non-zero without printing a result when no card is present, or when
the repository's ``src`` is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

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
from repro_torch.data.stream import (COMFS, GroundTruth,  # noqa: E402
                                     generate)
from repro_torch.engine import insert as eng  # noqa: E402
from repro_torch.engine.window import WindowRing  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import \
    ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    HEAD_DIMS as FLASH_HEAD_DIMS, flash_attention_backward_kernel,
    flash_attention_backward_plain, flash_attention_kernel,
    flash_attention_plain)
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
from repro_torch.data.tokens import (DEFAULT_BAND_VOCAB,  # noqa: E402
                                     SyntheticCorpus, TokenPipelineConfig)
from repro_torch.distributed.ranks import (backend_for,  # noqa: E402
                                           init_group, spawn_ranks)
from repro_torch.distributed.sharding_ctx import local_slice  # noqa: E402
from repro_torch.telemetry import (CapacityController,  # noqa: E402
                                   RouterTelemetry)
from repro_torch.configs.shapes import ShapeCell  # noqa: E402
from repro_torch.distributed.checkpoint import \
    CheckpointManager  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    HeartbeatMonitor, HostClock, RestartLoop, StragglerPolicy)
from repro_torch.launch import dryrun, step_fns  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.launch.serve import DecodeServer, Request  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.launch.serve_sketch import SketchServer  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.sketch.ingest import (StackedBatch,  # noqa: E402
                                       _degenerate_batch, _partition_stack)
from repro_torch.sketch.reshard import RESHARD_SPLIT  # noqa: E402
from repro_torch.telemetry.stream_stats import (  # noqa: E402
    PARTITION_STATS, BigramSketch)


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
# H100 SXM published peaks, kept in one place of the port
# (``launch/dryrun.py``): HBM3; dense tensor-core bf16, and TF32, which
# the f32 flash kernel runs three times a product (split-TF32, the
# cheapest way the card has to f32 accuracy); f32 outside the tensor
# cores (SIMT FMAs)
HBM_BYTES_PER_S = dryrun.HBM_BYTES_PER_S
BF16_FLOPS_PER_S = dryrun.BF16_FLOPS_PER_S
TF32_FLOPS_PER_S = dryrun.TF32_FLOPS_PER_S
F32_FLOPS_PER_S = dryrun.F32_FLOPS_PER_S
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

# phase S, the streaming loop on the main path's deployment: the COMFS
# analog at its own length through AsyncIngestor, in batches cut at
# subwindow boundaries (none takes the scan route); after each dispatched
# batch an edge batch at last=None and a horizon sweep, so that the
# single and the stacked fold both run; every CHECK_EVERY-th round and
# the last held to cold builds
STREAM_EDGES = COMFS.n_edges
STREAM_FLUSH = 16_384
SWEEP = (None, 1, 4)
CHECK_EVERY = 8

# phase R, routing at the main deployment: phase 4's stream and flushes
# through AsyncIngestor with the heavy-key detector
HEAT_THRESHOLD = 0.02
SPLIT_REPLICAS = 4

# phase T, the tenant pool: TENANTS tenants at _lsk_cfg(COMFS, d=1024,
# k=8, window=True) and TENANT_SHARDS shards each, in a pool of TENANTS
# slots (16 rows of ~1.15 GB: the main deployment's 18.4 GB); tenant t
# the COMFS analog from seed t cut to TENANT_EDGES edges, its clock
# offset by TENANT_OFFSET * t subwindows; TENANT_QUERIES queries a tenant
TENANTS = 8
TENANT_SHARDS = 2
TENANT_CFG = dataclasses.replace(CFG, d=1024)
TENANT_EDGES = 250_000
TENANT_OFFSET = 3
TENANT_QUERIES = 128

# phase V, the sketch server at the main deployment: phase 4's stream and
# flushes through SketchServer(heat_threshold=HEAT_THRESHOLD,
# split_replicas=SPLIT_REPLICAS, horizons=SERVER_HORIZONS), then
# SERVER_REQUESTS interleaved requests (KINDS x edge label x SERVER_LASTS);
# pool mode at phase T's tenants; the CLI at its defaults (CLI_ARGS adds
# flags); BigramSketch over BIGRAM_STEPS corpus batches of BIGRAM_BATCH
# (sequences, tokens) each
SERVER_REQUESTS = 4096
SERVER_HORIZONS = (1, 8)
SERVER_LASTS = (None, 1, 8)
SERVER_TOPK = 16
# phase V5's CLI runs at 5,000 edges (the CLI's default 20,000 cut for the
# run's time limit: lsketch's scan-route ingest runs ~800 edges/s there)
CLI_ARGS = ("--edges", "5000")
BIGRAM_STEPS = 8
BIGRAM_BATCH = (4, 256)

# the LM phases: Qwen3-8B at full width (configs/qwen3_8b.py)
# phase C: the mesh-resident collective path at the deployment
COLLECTIVE_TAIL = 4  # C3: the last flushes, each checked against a build
# C6: DeepSeek-V2's routed experts (160, top-6) at 8,192 tokens a step
TELEMETRY = dict(n_experts=160, n_buckets=256, window_steps=64,
                 subwindows=8, n_shards=4)
TELEMETRY_STEPS = 256
TELEMETRY_TOKENS = 8192
TELEMETRY_TOP_K = 6
TELEMETRY_CHECK = 32

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
    ("gemma3-4b global prefill", 1, 8, 4, 8192, 256, torch.float32),
    ("phi-3-vision prefill", 1, 32, 32, 576 + 2048, 96, torch.float32),
    ("gemma3-4b bf16", 1, 8, 4, 8192, 256, torch.bfloat16),
)
FLASH_REPS = 10
# L4: Gemma-3 4B at its published widths and depth (29 local layers of
# window 1024, 5 global); the ring check cuts depth to one period of 6
GEMMA_ARCH = "gemma3_4b"
GEMMA_PREFILL = 8192
RING_PROMPT = 1280  # > the 1,024-row local rings: they wrap
RING_SEQ = 2048
# L5: DeepSeek-V2 at its published widths, depth cut to the dense layer
# and two MoE layers; 2,048 tokens (MLA's unchunked [1, 128, L, L] f32
# scores are 34 GB at 8,192)
DSV2_ARCH = "deepseek_v2_236b"
DSV2_LAYERS = 3
DSV2_PREFILL = 2048
# L6: the other five at their reduced configs, card against CPU
REDUCED_ARCHS = ("kimi_k2_1t_a32b", "jamba_15_large_398b", "xlstm_13b",
                 "phi3_vision_42b", "seamless_m4t_medium")
REDUCED_BATCH, REDUCED_LEN, REDUCED_FRAMES = 2, 64, 24
# L7: the flash backward (label, B, Hq, Hkv, L, dh, dtype, causal); the
# first is the L8 trainer's own launch (a microbatch of 4 x 4,096) and
# gives the kernel row's numbers
FLASH_BWD_CASES = (
    ("smollm-135m train_4k", 4, 9, 3, 4096, 64, torch.float32, True),
    ("smollm-135m full batch", 8, 9, 3, 4096, 64, torch.float32, True),
    ("qwen3-8b train_4k", 1, 32, 8, 4096, 128, torch.float32, True),
    ("gemma3-4b global dh=256", 1, 8, 4, 2048, 256, torch.float32, True),
    ("phi-3-vision dh=96", 1, 32, 32, 2048, 96, torch.float32, True),
    ("dh=16", 2, 8, 2, 2048, 16, torch.float32, True),
    ("ragged L=1000", 2, 9, 3, 1000, 64, torch.float32, True),
    ("non-causal", 2, 9, 3, 2048, 64, torch.float32, False),
    ("bf16", 2, 32, 8, 2048, 128, torch.bfloat16, True),
)
FLASH_BWD_REPS = 5
# dq, dk, dv against the plain backward: max |d| over the largest |plain|
# of the three; f32 sums in another order move a gradient ~1e-6 of it,
# bf16 gradients are rounded to 2**-8 of their size
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# L8: SmolLM-135M at its published widths and depth trained at the
# train_4k cell's sequence length (its batch of 256 cut to 8, the
# reference trainer's default), in 2 microbatches of 4 x 4,096
TRAIN_ARCH = "smollm_135m"
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES = 8, 4096, 2
TRAIN_LR = 1e-3
TRAIN_CKPT_EVERY = 10
# one step from one state and batch with the kernel and with the plain
# attention; eps = 1e-3 keeps AdamW's update a smooth function of the
# gradient (tests/test_torch_train.py), so the two steps' parameters
# agree to TRAIN_PARAM_TOL; loss and gradient norm to TRAIN_REL
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2048
TRAIN_REL, TRAIN_PARAM_TOL = 1e-5, 1e-6
# L9: the MoE trainer with telemetry, as
# tests/test_system.py::test_train_moe_with_telemetry runs it
MOE_TRAIN = dict(arch="kimi_k2_1t_a32b", steps=12, batch_size=2, seq_len=32,
                 controller_every=4)
# L10: the sharded trainer at world 1 (a one-rank NCCL group; NCCL takes
# one card a rank): SHARDED_STEPS steps as L8's first, SHARDED_MOE_STEPS
# of reduced Kimi-K2 through the expert-parallel branch, the CLI's
# --mesh 1 for SHARDED_CLI_STEPS
SHARDED_STEPS = 5
SHARDED_MOE_STEPS = 2
SHARDED_CLI_STEPS = 2
# L11: L8's trainer (its arch, shapes and optimizer) under RestartLoop,
# RESTART_STEPS steps with a checkpoint every RESTART_CKPT_EVERY and a
# fault injected once after step RESTART_FAULT_AFTER, against an unbroken
# run in the same process; the health policies read the run's step times
# (StragglerPolicy's and HeartbeatMonitor's defaults)
RESTART_STEPS = 6
RESTART_CKPT_EVERY = 3
RESTART_FAULT_AFTER = 4
# L12: tensor parallelism over "model" on this one card: the model ranks as
# processes sharing it over a gloo group with CUDA tensors (NCCL takes one
# card a rank). SmolLM-135M at full width and depth (L8's arch and seed),
# TP_STEPS steps of TP_BATCH x TP_SEQ on each mesh of TP_MESHES (9 heads on
# 3 ranks: head-parallel; on 2: the "sp" fallback at q_offset 0 and 1024),
# held to the one-device step from one state and batch (TRAIN_REL: loss,
# gradient norm and every gradient leaf against its largest magnitude)
TP_MESHES = ((1, 3), (1, 2))
TP_BATCH, TP_SEQ, TP_STEPS = 2, 2048, 2
# the flash forward's lse against the plain version's at L12's call shapes:
# max |d| (f32 sums in another order move it ~1e-6)
TP_LSE_TOL = 1e-5
# L13: sharded serving on this one card, the ranks as gloo processes as
# L12's (one group for the three parts): (a) Qwen3-8B at 1 x 2 (16 query
# heads and 4 KV heads a rank, the vocabulary split): a split prefill of
# 2,048 tokens and DecodeServer(mesh=) on SERVE_TP; (b) xLSTM-1.3B at 1 x 2
# (the channel split: 2 mLSTM heads a rank, sLSTM on half the channels): a
# 512-token prefill, the server and the split train gradient of 2 x 512;
# (c) Gemma-3 4B at 2 x 1, one sequence, its caches' sequence over "data"
# (context parallelism): 4 decode steps from seeded caches, long_500k's
# CP_SEQ_MAX slots where the estimated peaks fit CP_MEMORY_SHARE of the
# card. Widths are published; (b) keeps one period of its 7:1 pattern (8
# layers: deeper, the random-weight stack's f32 rounding alone moves its
# logits past LOGIT_TOL), (c) one period of 6 (5 local layers, 1 global:
# every decode step gathers each layer over "data", and gloo stages the
# bytes through host memory); tools/serve_tp_conditioning.py --card runs
# both at published depth. Each part against the one-device path computed
# on the card first: logits within LOGIT_TOL, the greedy tokens equal, a
# gradient as SERVE_TP_GRAD_REL
SERVE_TP = dict(batch_slots=4, max_seq=256, requests=4, prompt=8, max_new=8)
SERVE_TP_PARTS = {
    "a": dict(arch=LM_ARCH, mesh=(1, 2), prefill=2048, serve=SERVE_TP),
    "b": dict(arch="xlstm_13b", mesh=(1, 2), prefill=512, serve=SERVE_TP,
              train=(2, 512), layers=8),
    "c": dict(arch=GEMMA_ARCH, mesh=(2, 1), steps=4, layers=6),
}
CP_SEQ_MAX = 524_288  # long_500k
CP_MEMORY_SHARE = 0.9
# L13b's gradient: the loss within TRAIN_REL; each rank's shard of each
# gradient leaf within SERVE_TP_GRAD_REL of the leaf's norm. Leaf by leaf
# and element by element (L12's 1e-5) f32 cannot hold here: the
# random-weight xLSTM at published width is ill-conditioned, so that one
# device's f32 gradient at L13b's 2 x 512 tokens lies 2.4e-3 of a leaf's
# largest element from an f64 evaluation (sLSTM's w_gates;
# tools/serve_tp_conditioning.py --cpu); a wrong split is off by O(1) of
# the norm
SERVE_TP_GRAD_REL = 1e-3
# E1: the cell estimator against L8's, L2's and L3's measurements; the memory
# estimate must fall within this share of the measured peak (fixed in
# PERF.md before the first card run)
ESTIMATE_MEMORY_MARGIN = 0.15
TRAIN_PATH = ("flash_attention_kernel", "flash_attention_backward_kernel")
MOE_TRAIN_PATH = ("sketch_insert_kernel_sharded", "pool_pass_kernel_sharded",
                  "vertex_scan_kernel_sharded")

WRAPPERS = {
    "sketch_insert_kernel_sharded": sketch_insert_kernel_sharded,
    "pool_pass_kernel_sharded": pool_pass_kernel_sharded,
    "sketch_query_kernel_sharded": sketch_query_kernel_sharded,
    "vertex_scan_kernel_sharded": vertex_scan_kernel_sharded,
    "cell_decode_kernel_sharded": cell_decode_kernel_sharded,
    "flash_attention_kernel": flash_attention_kernel,
    "flash_attention_backward_kernel": flash_attention_backward_kernel,
}
MAIN_PATH = ("sketch_insert_kernel_sharded", "pool_pass_kernel_sharded",
             "sketch_query_kernel_sharded", "vertex_scan_kernel_sharded")
ANALYTICS_PATH = ("cell_decode_kernel_sharded",
                  "sketch_query_kernel_sharded", "vertex_scan_kernel_sharded")
OBJECT_PATH = MAIN_PATH + ("cell_decode_kernel_sharded",)
STREAM_PATH = MAIN_PATH[:3]  # phase S asks edge queries only
COLLECTIVE_PATH = MAIN_PATH + ("cell_decode_kernel_sharded",)
# the grouped entries' rows (phase T): the wrapper whose launches each
# counts on the pool path
GROUPED_KERNELS = {
    "sketch_query_kernel_sharded (grouped)": "sketch_query_kernel_sharded",
    "vertex_scan_kernel_sharded (grouped)": "vertex_scan_kernel_sharded"}
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
    "flash_attention_backward_kernel": dict(
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none (gradient of the TPU kernel's function; the JAX "
                 "package differentiates `_masked_attention`)"),
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
    # the grouped entries: a pooled stack of tenants, each block of rows
    # against its own tenant's queries, in one launch
    "sketch_query_kernel_sharded (grouped)": dict(
        source="src/repro_torch/csrc/sketch_query.cu",
        replaces="src/repro/kernels/sketch_query/kernel.py:113",
        entry="kernels/sketch_query/kernel.py::edge_query_kernel(groups=)"),
    "vertex_scan_kernel_sharded (grouped)": dict(
        source="src/repro_torch/csrc/vertex_scan.cu",
        replaces="src/repro/kernels/vertex_scan/kernel.py:99",
        entry="kernels/vertex_scan/kernel.py::vertex_scan_kernel_sharded"
              "(groups=)"),
}


_T0 = time.perf_counter()


def _log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script
    started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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


def _subwindow_bounds(time_col: np.ndarray, subwindow: int) -> list:
    widx = time_col // subwindow
    return (np.flatnonzero(np.diff(widx)) + 1).tolist()


def _chunked(seg_edges, max_flush: int, keep=()) -> list:
    """Cuts of the segments between ``seg_edges`` into near-equal flushes
    of at most ``max_flush`` edges (a segment in ``keep`` stays whole)."""
    cuts = [0]
    for a, z in zip(seg_edges[:-1], seg_edges[1:]):
        if (a, z) in keep:
            cuts.append(z)
            continue
        n_chunks = -(-(z - a) // max_flush)
        step = -(-(z - a) // n_chunks)
        cuts.extend(list(range(a + step, z, step)) + [z])
    return cuts


def flush_cuts(time_col: np.ndarray, subwindow: int):
    """Flush boundaries: every subwindow boundary and every MAX_FLUSH edges
    within a subwindow — except one boundary near the middle, which a
    SPAN_FLUSH-edge flush straddles. Returns (cuts, index of that flush)."""
    bounds = _subwindow_bounds(time_col, subwindow)
    mid = bounds[len(bounds) // 2]
    lo, hi = mid - SPAN_FLUSH // 2, mid + SPAN_FLUSH // 2
    seg_edges = sorted(set([0] + [b for b in bounds if b != mid]
                           + [lo, hi, len(time_col)]))
    cuts = _chunked(seg_edges, MAX_FLUSH, keep=((lo, hi),))
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
        clone = state.shards.map(lambda x: x[0:1].to("cpu", copy=True)) \
            if checked else None  # a copy on the CPU too
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


def device_us(events) -> float:
    """Device time of a profiler trace as the profiler's own table sums
    it: CUDA-side events that are not user annotations (a range's
    device-side twin spans its whole window and would count idle time as
    busy)."""
    return sum(e.self_device_time_total for e in events
               if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False))


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
    dev_us = device_us(events)
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


def flash_ptxas(log: str, kernel: str = "lsk_flash_attention_kernel"
                ) -> dict:
    """{(type, dh): (registers, spill store bytes, spill load bytes)} of
    the template instances of flash kernel ``kernel``, from its source's
    ``-Xptxas -v`` report."""
    out, inst, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(kernel + r"I(\w+?)Li(\d+)E", m.group(1))
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


def flash_build_report() -> tuple:
    """Phase 2's check that the flash kernels are built for the tensor
    cores: each instance's registers and spills, and its HMMA count; the
    forward's (``csrc/flash_attention.cu``) and the backward's
    (``csrc/flash_attention_bwd.cu``: the dq and dkdv kernels) rows."""
    n = 2 * len(FLASH_HEAD_DIMS)
    rows = []
    for src, kernels in (
            ("flash_attention", ("lsk_flash_attention_kernel",)),
            ("flash_attention_bwd", ("lsk_flash_bwd_dq_kernel",
                                     "lsk_flash_bwd_dkdv_kernel"))):
        hmma = {fn: c for fn, c in flash_sass_hmma(
            build.BUILD_DIR / f"{src}.o").items() if "lsk_flash" in fn}
        regs = {}
        for kern in kernels:
            got = flash_ptxas(build.PTXAS_LOG[f"{src}.cu"], kern)
            _log(f"{kern} instances (type, dh): registers, spill store / "
                 f"load bytes {got}")
            if len(got) != n:
                raise AssertionError(f"{kern}: {len(got)} of {n} instances "
                                     f"in the ptxas report")
            regs.update({f"{kern} {t} dh{d}": r for (t, d), r in got.items()})
        _log(f"{src}.cu: HMMA instructions by cuobjdump -sass {hmma} "
             f"(sum {sum(hmma.values())})")
        if len(hmma) != n * len(kernels) or min(hmma.values()) == 0:
            raise AssertionError(f"{src}.cu: its {n * len(kernels)} "
                                 f"instances are not all built with "
                                 f"tensor-core MMAs")
        rows.append(dict(registers=regs, hmma=sum(hmma.values())))
    return tuple(rows)


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


def sdpa(q, k, v, causal: bool = True):
    """PyTorch's fused attention on the same inputs: the yardstick of L1
    and (its backward) of L7, timed here and called nowhere in the
    port."""
    F = torch.nn.functional
    try:
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    except TypeError:  # a PyTorch without enable_gqa: repeat the KV heads
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
            is_causal=causal)


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
                          ops_ms=ops_ms, ops_rate=rate, bound_ms=bound,
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


def lm_model(dev, tag, cfg=None, phase="L2"):
    """An LM config (f32; LM_ARCH's unless given) and its seeded weights,
    drawn on the card."""
    cfg = cfg or configs.get(LM_ARCH, reduced=LM_REDUCED)
    params, sec = _timed(lambda: lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    _log(f"{phase} {cfg.name} ({cfg.n_layers} layers): {cfg.param_count()} "
         f"parameters by ModelConfig.param_count(), {nbytes} bytes of f32 "
         f"weights on the card, drawn in {sec:.2f} s {tag}")
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


def prefill_phase(cfg, params, dev, tag, length=None, tf32=True,
                  phase="L2"):
    """L2 (and L4): one prompt of ``length`` tokens (PREFILL_LEN) through
    the plain forward (the reference), the counted kernel forward, and,
    with ``tf32``, the kernel forward with TF32 on. Returns (metrics, the
    prompt tokens, the kernel forward's first DECODE_CHECK logits
    rows)."""
    L = length or PREFILL_LEN
    tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (1, L)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens}
    saved = tattn.CHUNKED_ATTN_THRESHOLD
    tattn.CHUNKED_ATTN_THRESHOLD = min(saved, PLAIN_CHUNK_THRESHOLD)
    try:
        (ref, _), plain_s = _timed(lambda: lm.forward(
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
        ((logits, _), sec), launches = count_launches(
            (), lambda: _timed(lambda: lm.forward(cfg, params, batch)))
    kernel_ms = timer.ms()
    peak = torch.cuda.max_memory_allocated()
    n = launches["flash_attention_kernel"]
    V = cfg.vocab_size
    if tuple(logits.shape) != (1, L, V) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    err = logit_err(logits, ref_cpu, scale)
    head = logits[0, :DECODE_CHECK].clone()
    del logits
    torch.cuda.empty_cache()
    err_tf32 = None
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_logits, _ = lm.forward(cfg, params, batch)
            err_tf32 = logit_err(tf32_logits, ref_cpu, scale)
            del tf32_logits
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    del ref_cpu
    torch.cuda.empty_cache()
    D = cfg.d_model
    mm_flops = 2 * L * (cfg.param_count() - V * D)  # the table is a gather
    attn_flops = n_flash_layers(cfg) * flash_flops(1, cfg.n_heads, L,
                                                   cfg.head_dim)
    out = dict(prefill_tokens_per_s=L / sec, prefill_s=sec,
               plain_prefill_s=plain_s, prefill_flash_ms=kernel_ms,
               prefill_flash_share=kernel_ms / (1e3 * sec),
               prefill_flash_launches=n, lm_peak_memory_bytes=peak,
               prefill_logit_rel_err=err, prefill_logit_rel_err_tf32=err_tf32,
               logit_scale=scale, logit_tol=LOGIT_TOL,
               prefill_matmul_flops=mm_flops, prefill_attention_flops=attn_flops)
    _log(f"{phase} prefill of {L} tokens, {cfg.name}: kernel forward "
         f"{sec:.3f} s "
         f"= {L / sec:.1f} tokens/s ({(mm_flops + attn_flops) / sec / 1e12:.2f}"
         f" TFLOP/s over {mm_flops:.4g} matmul + {attn_flops:.4g} attention "
         f"flops), {n} flash launches taking {kernel_ms:.1f} ms by CUDA "
         f"events ({kernel_ms / (1e3 * sec):.4f} of the forward); plain "
         f"forward {plain_s:.3f} s; peak device memory {peak} bytes {tag}")
    _log(f"{phase} logits: max|kernel - plain| / max|plain| = {err:.3g} "
         f"(max |plain| {scale:.4g}; tolerance {LOGIT_TOL})" +
         (f"; the same with TF32 on: {err_tf32:.3g}" if tf32 else ""))
    if not err <= LOGIT_TOL:
        raise AssertionError("kernel-forward logits disagree with the plain "
                             "forward")
    return out, tokens, head


def n_flash_layers(cfg) -> int:
    """The flash launches of one forward: the GQA attention layers without
    a window, of the decoder and the encoder."""
    if cfg.attention != "gqa":
        return 0
    return sum(p.kind == "attn" and not p.window
               for plan in lm.plans(cfg) if plan is not None
               for p in plan.layers)


def check_prefill_on_the_card(cfg, out) -> None:
    """L2's and L4's card-only checks: one flash launch per global GQA
    layer and, where it ran, TF32 fails the logit tolerance that the f32
    kernel forward meets."""
    if out["prefill_flash_launches"] != n_flash_layers(cfg):
        raise AssertionError(f"{out['prefill_flash_launches']} flash "
                             f"launches in a forward of "
                             f"{n_flash_layers(cfg)} global GQA layers")
    err = out["prefill_logit_rel_err_tf32"]
    if err is not None and not err > LOGIT_TOL:
        raise AssertionError("the logit tolerance does not catch TF32")


def profile_decode(cfg, params, dev, tag, steps: int = 8, serve=None,
                   phase="L3") -> dict:
    """L3: the peak memory of one decode step at the server's batch (E1
    holds the estimator to it), then a profiler trace of ``steps`` decode
    steps, each ending in the logits' copy to the host as the server's
    does: wall and device-kernel time per step (where a step's time
    goes)."""
    from torch.profiler import ProfilerActivity, profile

    serve = serve or SERVE
    B = serve["batch_slots"]
    caches = lm.init_cache(cfg, B, serve["max_seq"], dev)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    lm.serve_step(cfg, params, caches, tok)[0].cpu()  # warm
    torch.cuda.reset_peak_memory_stats()
    lm.serve_step(cfg, params, caches, tok)[0].cpu()
    peak = torch.cuda.max_memory_allocated()
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
    del caches
    _log(f"{phase} profile of {steps} decode steps at batch {B}: wall "
         f"{1e3 * wall / steps:.3f} ms/step, device kernels {dev_ms / steps:.3f}"
         f" ms/step (busy share {dev_ms / 1e3 / wall:.4f}), "
         f"{launches / steps:.0f} kernels/step, peak device memory of a "
         f"step {peak} bytes; top by device time "
         f"(ms/step): " + json.dumps(
             {e.key[:60]: round(e.self_device_time_total / 1e3 / steps, 3)
              for e in top}) + f" {tag}")
    return dict(decode_peak_memory_bytes=peak,
                decode_profile_wall_ms_per_step=1e3 * wall / steps,
                decode_profile_device_ms_per_step=dev_ms / steps,
                decode_profile_busy_share=dev_ms / 1e3 / wall)


def serve_phase(cfg, params, tokens, head, dev, tag, serve=None,
                phase="L3") -> dict:
    """L3 (and L4): the decode server on ``serve``'s requests (SERVE's),
    then the prompt's first DECODE_CHECK tokens through ``serve_step`` on
    a 1-slot cache against the prefill logits at those positions."""
    serve = serve or SERVE
    rng = np.random.default_rng(SEED + 4)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
        0, cfg.vocab_size, serve["prompt"])], max_new=serve["max_new"])
        for _ in range(serve["requests"])]
    server = DecodeServer(cfg, params, batch_slots=serve["batch_slots"],
                          max_seq=serve["max_seq"], device=dev)
    steps = [0]
    inner_step = server.step

    def step():
        steps[0] += 1
        inner_step()

    server.step = step
    (_, sec), launches = count_launches((), lambda: _timed(
        lambda: server.run(reqs)))
    n_new = [len(r.out) for r in reqs]
    if not all(r.done for r in reqs) or n_new != [serve["max_new"]] * len(
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
               decode_tokens_processed_per_s=steps[0] * serve["batch_slots"]
               / sec)
    del server.step, server  # the wrapper's cycle held the weights
    _log(f"{phase} DecodeServer {serve}: {len(reqs)} of {len(reqs)} "
         f"requests done, "
         f"{sum(n_new)} new tokens in {sec:.3f} s = "
         f"{out['decode_tokens_per_s']:.2f} tokens/s; {steps[0]} steps, "
         f"{out['decode_ms_per_step']:.3f} ms/step against a {step_bound_ms:.3f}"
         f" ms byte bound (weights read once a step); flash launches "
         f"{launches['flash_attention_kernel']} (decode never runs it); "
         f"first request's tokens {reqs[0].out[:8]} {tag}")
    out.update(profile_decode(cfg, params, dev, tag, serve=serve,
                              phase=phase))
    caches = lm.init_cache(cfg, 1, DECODE_CHECK, dev)
    err = 0.0
    for i in range(DECODE_CHECK):
        lg, caches = lm.serve_step(cfg, params, caches, tokens[:, i:i + 1])
        err = max(err, float((lg[0, 0] - head[i]).abs().max()))
    rel = err / float(head.abs().max())
    out["decode_logit_rel_err"] = rel
    _log(f"{phase} decode vs prefill over {DECODE_CHECK} positions: "
         f"max|decode - "
         f"prefill| / max|prefill| = {rel:.3g} (tolerance {LOGIT_TOL})")
    if not rel <= LOGIT_TOL:
        raise AssertionError("decode through the cache disagrees with the "
                             "prefill")
    return out


# --------------------------------------------------------------------------
# L4-L6: the other LM architectures
# --------------------------------------------------------------------------

def gemma_phase(dev, tag) -> tuple:
    """L4: Gemma-3 4B at its published widths and depth: the prefill
    against the plain forward, the decode server and decode against the
    prefill (``prefill_phase``/``serve_phase`` at GEMMA_PREFILL), then the
    ring wrap at depth 6. Returns (metrics, the flash launches of the
    prefill and of the ring model's forward)."""
    cfg, params = lm_model(dev, tag, configs.get(GEMMA_ARCH,
                                                 reduced=LM_REDUCED),
                           phase="L4")
    out, tokens, head = prefill_phase(cfg, params, dev, tag,
                                      length=GEMMA_PREFILL, tf32=False,
                                      phase="L4")
    if dev.type == "cuda":  # CPU tensors take the plain version
        check_prefill_on_the_card(cfg, out)
    out.update(serve_phase(cfg, params, tokens, head, dev, tag,
                           phase="L4"))
    del tokens, head
    torch.cuda.empty_cache()
    out.update(ring_phase(cfg, params, dev, tag))
    out["param_count"] = cfg.param_count()
    del params
    torch.cuda.empty_cache()
    return out, {"gemma3_4b prefill": out["prefill_flash_launches"],
                 "gemma3_4b ring forward": out["ring_flash_launches"]}


def ring_phase(cfg, params, dev, tag) -> dict:
    """L4 ring wrap: the full-width model cut to its first period (5 local
    layers, 1 global; the same weights), a RING_PROMPT-token prompt
    through ``serve_step`` on a 1-slot RING_SEQ-position cache — the
    local layers' 1,024-row rings wrap — against that model's forward
    logits at every position."""
    plan = lm.plans(cfg)[0]
    n = len(plan.pattern)
    cut = cfg.replace(n_layers=n)
    top = {k: params[k] for k in ("embed", "final_norm")}
    model = lm.LMParams({}, params.layers[:n])
    for k, v in top.items():
        model.add_module(k, v)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (1, RING_PROMPT)).astype(np.int32)).to(dev)
    (full, _), launches = count_launches(
        ("flash_attention_kernel",) if dev.type == "cuda" else (),
        lambda: lm.forward(cut, model, {"tokens": tokens}))
    caches = lm.init_cache(cut, 1, RING_SEQ, dev)
    rows = {c["mixer"]["k"].shape[1] for c in caches}
    scale = float(full.abs().max())
    err = 0.0
    _sync()
    t0 = time.perf_counter()
    for i in range(RING_PROMPT):
        lg, caches = lm.serve_step(cut, model, caches, tokens[:, i:i + 1])
        err = max(err, float((lg[0, 0] - full[0, i]).abs().max()))
    sec = time.perf_counter() - t0
    rel = err / scale
    windows = [p.window for p in plan.pattern]
    _log(f"L4 ring wrap: {cut.name} cut to {n} layers (windows {windows}), "
         f"{RING_PROMPT} prompt tokens through "
         f"serve_step on a 1-slot {RING_SEQ}-position cache (cache rows "
         f"{sorted(rows)}): max|decode - forward| / max|forward| = "
         f"{rel:.3g} (tolerance {LOGIT_TOL}); {1e3 * sec / RING_PROMPT:.3f} "
         f"ms/step; the forward's flash launches "
         f"{launches['flash_attention_kernel']} {tag}")
    if min(rows) >= RING_PROMPT or not rel <= LOGIT_TOL:
        raise AssertionError("L4: the ring-buffered decode disagrees with "
                             "the forward (or never wrapped)")
    return dict(ring_logit_rel_err=rel, ring_ms_per_step=1e3 * sec /
                RING_PROMPT, ring_flash_launches=launches[
                    "flash_attention_kernel"])


def deepseek_phase(dev, tag) -> dict:
    """L5: DeepSeek-V2 at its published widths, depth DSV2_LAYERS (the
    dense layer, then MoE layers of 160 routed + 2 shared experts): a
    DSV2_PREFILL-token prefill drop-free (capacity factor = n_experts) and
    at the config's 1.25 (its dropped share); the first DECODE_CHECK
    tokens through ``serve_step`` against the drop-free prefill; the
    prefill's telemetry (tokens x top_k x MoE layers edges) ingested by a
    ``RouterTelemetry`` on the card and one on the CPU, loads equal."""
    cfg = configs.get(DSV2_ARCH, reduced=LM_REDUCED).replace(
        n_layers=DSV2_LAYERS)
    cfg, params = lm_model(dev, tag, cfg, phase="L5")
    n_moe = sum(p.mlp == "moe" for p in lm.plans(cfg)[0].layers)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, (1, DSV2_PREFILL)).astype(np.int32)).to(dev)
    free = cfg.replace(capacity_factor=float(cfg.n_experts))
    torch.cuda.reset_peak_memory_stats()
    ((logits, aux_free), sec_free), launches = count_launches(
        (), lambda: _timed(lambda: lm.forward(free, params,
                                              {"tokens": tokens})))
    peak = torch.cuda.max_memory_allocated()
    head = logits[0, :DECODE_CHECK].clone()
    ok = tuple(logits.shape) == (1, DSV2_PREFILL, cfg.vocab_size) and bool(
        torch.isfinite(logits).all())
    del logits
    torch.cuda.empty_cache()
    (_, aux), sec = _timed(lambda: lm.forward(cfg, params,
                                              {"tokens": tokens}))
    caches = lm.init_cache(cfg, 1, DECODE_CHECK, dev)
    err = 0.0
    _sync()
    t0 = time.perf_counter()
    for i in range(DECODE_CHECK):
        lg, caches = lm.serve_step(cfg, params, caches, tokens[:, i:i + 1])
        err = max(err, float((lg[0, 0] - head[i]).abs().max()))
    dec_sec = time.perf_counter() - t0
    rel = err / float(head.abs().max())
    del caches, head
    want = DSV2_PREFILL * cfg.top_k * n_moe
    tele = aux["telemetry"]
    tele_sum = int(tele.sum())
    counts = tele.cpu().numpy()
    card = RouterTelemetry(n_experts=cfg.n_experts, device=dev)
    host = RouterTelemetry(n_experts=cfg.n_experts, device="cpu")
    card.ingest(counts, step=0)
    host.ingest(counts, step=0)
    load, load_cpu = card.load_vector(), host.load_vector()
    # one-sided up to the pool's lost weight: logged, not checked
    under = int((load < counts.sum(0)).sum())
    _log(f"L5 {cfg.name} cut to {DSV2_LAYERS} layers ({n_moe} MoE of "
         f"{cfg.n_experts} + {cfg.n_shared_experts} experts, top-"
         f"{cfg.top_k}): {DSV2_PREFILL}-token prefill drop-free {sec_free:.3f}"
         f" s ({DSV2_PREFILL / sec_free:.1f} tokens/s, peak device memory "
         f"{peak} bytes, flash launches {launches['flash_attention_kernel']}"
         f", MLA runs the plain attention), at capacity factor "
         f"{cfg.capacity_factor} {sec:.3f} s with dropped share "
         f"{float(aux['dropped']):.5f} (summed over {n_moe} layers; "
         f"drop-free {float(aux_free['dropped']):.5f}), lb_loss "
         f"{float(aux['lb_loss']):.5f}, z_loss {float(aux['z_loss']):.5f} "
         f"{tag}")
    _log(f"L5 decode of {DECODE_CHECK} tokens vs the drop-free prefill: "
         f"max|decode - prefill| / max|prefill| = {rel:.3g} (tolerance "
         f"{LOGIT_TOL}), {1e3 * dec_sec / DECODE_CHECK:.3f} ms/step; "
         f"telemetry sums to {tele_sum} (tokens x top_k x MoE layers = "
         f"{want}); RouterTelemetry on the card vs the CPU: load vectors "
         f"{'equal' if np.array_equal(load, load_cpu) else 'differ'}, "
         f"{under} experts under their counted load {tag}")
    if not ok or not rel <= LOGIT_TOL or tele_sum != want or \
            int(aux_free["telemetry"].sum()) != want or \
            float(aux_free["dropped"]) != 0.0 or \
            not np.array_equal(load, load_cpu):
        raise AssertionError("L5: DeepSeek-V2's serving path failed a check")
    del params
    torch.cuda.empty_cache()
    return dict(prefill_s_drop_free=sec_free, prefill_s=sec,
                prefill_tokens_per_s=DSV2_PREFILL / sec_free,
                peak_memory_bytes=peak, dropped=float(aux["dropped"]),
                lb_loss=float(aux["lb_loss"]), z_loss=float(aux["z_loss"]),
                decode_logit_rel_err=rel,
                decode_ms_per_step=1e3 * dec_sec / DECODE_CHECK,
                telemetry_sum=tele_sum, telemetry_under_counted=under,
                param_count=cfg.param_count())


def _arch_batch(cfg, dev):
    """Tokens and the arch's frontend inputs of L6, from SEED."""
    rng = np.random.default_rng(SEED + 7)
    B, L = REDUCED_BATCH, REDUCED_LEN
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, L)).astype(
        np.int32)}
    if cfg.frontend == "vision":
        batch["prefix_emb"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frame_emb"] = rng.standard_normal(
            (B, REDUCED_FRAMES, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def reduced_arch_phase(arch, dev, tag) -> tuple:
    """L6, one arch at its reduced config: weights drawn on the CPU from
    SEED and carried to the card; the card's forward (logits and aux; the
    kernel where the arch has global GQA layers) against the CPU's plain
    forward, ``serve_step`` over every position on both, and the card's
    decode against its own drop-free prefill (without the vision prefix,
    which the decode does not take). Returns (metrics, the forward's
    flash launches)."""
    cfg = configs.get(arch, reduced=True)
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    params = lm.init_params(cfg, torch.Generator().manual_seed(SEED),
                            "cpu").to(dev)
    batch_cpu = _arch_batch(cfg, "cpu")
    batch = {k: v.to(dev) for k, v in batch_cpu.items()}
    torch.cuda.reset_peak_memory_stats()
    ((logits, aux), sec), launches = count_launches(
        (), lambda: _timed(lambda: lm.forward(cfg, params, batch)))
    want, want_aux = lm.forward(cfg, cpu, batch_cpu)
    scale = float(want.abs().max())
    fwd_err = float((logits.cpu() - want).abs().max()) / scale
    tele_equal = torch.equal(aux["telemetry"].cpu(), want_aux["telemetry"])
    free = cfg.replace(capacity_factor=float(max(cfg.n_experts, 1)))
    text = {"tokens": batch["tokens"], **({"frame_emb": batch["frame_emb"]}
                                          if cfg.is_encdec else {})}
    full, _ = lm.forward(free, params, text)
    mem = mem_cpu = None
    if cfg.is_encdec:
        mem = lm.encode_memory(cfg, params, batch["frame_emb"])
        mem_cpu = lm.encode_memory(cfg, cpu, batch_cpu["frame_emb"])
    B, L = batch["tokens"].shape
    caches = lm.init_cache(cfg, B, L, dev)
    caches_cpu = lm.init_cache(cfg, B, L, "cpu")
    step_err = dec_err = 0.0
    fscale = float(full.abs().max())
    _sync()
    t0 = time.perf_counter()
    for i in range(L):
        lg, caches = lm.serve_step(cfg, params, caches,
                                   batch["tokens"][:, i:i + 1], memory=mem)
        lc, caches_cpu = lm.serve_step(cfg, cpu, caches_cpu,
                                       batch_cpu["tokens"][:, i:i + 1],
                                       memory=mem_cpu)
        lg = lg.cpu()
        step_err = max(step_err, float((lg - lc).abs().max()) /
                       float(lc.abs().max()))
        dec_err = max(dec_err, float((lg[:, 0] - full[:, i].cpu()).abs()
                                     .max()) / fscale)
    sec_dec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = launches["flash_attention_kernel"]
    _log(f"L6 {cfg.name} (reduced: {cfg.n_layers} layers"
         f"{f' + {cfg.encoder_layers} encoder' if cfg.is_encdec else ''}, "
         f"d_model {cfg.d_model}), batch {B} x {L}"
         f"{' + a vision prefix' if 'prefix_emb' in batch else ''}"
         f"{' + frames' if cfg.is_encdec else ''}: forward card vs CPU "
         f"{fwd_err:.3g}, telemetry {'equal' if tele_equal else 'differs'}"
         f" (dropped {float(aux['dropped']):.4f}); serve_step card vs CPU "
         f"{step_err:.3g}; decode vs drop-free prefill {dec_err:.3g} "
         f"(tolerance {LOGIT_TOL} of the largest logit); forward "
         f"{1e3 * sec:.1f} ms, {n} flash launches (want "
         f"{n_flash_layers(cfg)}); decode (card and CPU steps) "
         f"{1e3 * sec_dec / L:.3f} ms/step; peak device memory {peak} bytes "
         f"{tag}")
    if not (fwd_err <= LOGIT_TOL and step_err <= LOGIT_TOL
            and dec_err <= LOGIT_TOL and tele_equal):
        raise AssertionError(f"L6: {cfg.name} on the card disagrees")
    if dev.type == "cuda" and n != n_flash_layers(cfg):
        raise AssertionError(f"L6: {cfg.name}: {n} flash launches")
    return dict(forward_rel_err=fwd_err, serve_step_rel_err=step_err,
                decode_rel_err=dec_err, forward_ms=1e3 * sec,
                ms_per_step=1e3 * sec_dec / L, peak_memory_bytes=peak,
                flash_launches=n), n


def arch_phases(dev, tag) -> tuple:
    """L4, L5 and L6 in turn. Returns (metrics by arch, the flash launches
    of each new path)."""
    out, launches = {}, {}
    _free_card()
    out["gemma3_4b"], launches_g = gemma_phase(dev, tag)
    launches.update(launches_g)
    _free_card()
    out["deepseek_v2_236b"] = deepseek_phase(dev, tag)
    for arch in REDUCED_ARCHS:
        _free_card()
        out[arch], launches[f"{arch} reduced forward"] = \
            reduced_arch_phase(arch, dev, tag)
    _free_card()
    return out, launches


def _free_card() -> None:
    """Collect what only reference cycles still hold (a model's weights)
    and give the cached blocks back, so a phase starts from an empty
    card."""
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# L7-L9: training
# --------------------------------------------------------------------------

def flash_bwd_errors(got, want) -> list:
    """max |d| of dq, dk and dv, each over the largest |plain| of the three
    (at one key, dq and dk are 0 but for rounding)."""
    scale = max(float(w.float().abs().max()) for w in want)
    return [float((a.float() - b.float()).abs().max()) / max(scale, 1e-30)
            for a, b in zip(got, want)]


def sdpa_backward(q, k, v, do, causal):
    """A closure running SDPA's backward on the same inputs once (its
    forward run here, once)."""
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = sdpa(qq, kk, vv, causal)
    return lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                       retain_graph=True)


def check_flash_backward(dev, tag, l1_ms=None) -> dict:
    """L7: the backward pair against ``flash_attention_backward_plain`` on
    every FLASH_BWD_CASES case, from the forward's own out and lse;
    CUDA-event medians of the pair, the plain backward and SDPA's backward.
    Bound: 2.5 x the forward's operations (4 dh a kept pair) at the card's
    tensor-core rate for the type, as the forward's (``flash_ops_ms``: bf16
    over its peak, f32 as split-TF32's three MMAs a product), against the
    bytes of q, k, v, out, dout, lse, dq, dk and dv. Also the forward at L1's main shape with no lse
    (serving's) beside L1's time, and with lse (training's)."""
    cases = []
    for label, B, Hq, Hkv, L, dh, dtype, causal in FLASH_BWD_CASES:
        q, k, v = flash_inputs(B, Hq, Hkv, L, dh, dtype, dev)
        rng = np.random.default_rng(SEED + 3 * L + dh)
        do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)
                              ).to(dev, dtype)
        out, lse = flash_attention_kernel(q, k, v, causal, lse=True)
        got = flash_attention_backward_kernel(q, k, v, out, lse, do, causal)
        again = flash_attention_backward_kernel(q, k, v, out, lse, do,
                                                causal)
        want = flash_attention_backward_plain(q, k, v, out, lse, do, causal)
        _sync()
        errs = flash_bwd_errors(got, want)
        abs_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
        # no atomics: a second launch gives the same bits
        repeatable = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, want
        ms = float(np.median(event_times(
            lambda: flash_attention_backward_kernel(q, k, v, out, lse, do,
                                                    causal), FLASH_BWD_REPS)))
        plain_ms = float(np.median(event_times(
            lambda: flash_attention_backward_plain(q, k, v, out, lse, do,
                                                   causal), FLASH_BWD_REPS)))
        lib = sdpa_backward(q, k, v, do, causal)
        library_ms = float(np.median(event_times(lib, FLASH_BWD_REPS)))
        del lib
        fwd_ms = float(np.median(event_times(
            lambda: flash_attention_kernel(q, k, v, causal), FLASH_BWD_REPS)))
        fwd_lse_ms = float(np.median(event_times(
            lambda: flash_attention_kernel(q, k, v, causal, lse=True),
            FLASH_BWD_REPS)))
        pairs = L * (L + 1) // 2 if causal else L * L
        flops = 4 * dh * B * Hq * pairs
        ops_ms, rate = flash_ops_ms(2.5 * flops, dtype)
        nbytes = (5 * q.numel() + 4 * k.numel()) * q.element_size() + \
            4 * lse.numel()
        bound = max(ops_ms, 1e3 * nbytes / HBM_BYTES_PER_S)
        tol = FLASH_BWD_TOL[dtype]
        cases.append(dict(
            label=label, shape=f"q {list(q.shape)} k {list(k.shape)} "
            f"{str(dtype)[6:]} {'causal' if causal else 'non-causal'}",
            rel_err_dq_dk_dv=errs, max_abs_err=abs_err, tolerance=tol,
            out_of_tolerance=int(max(errs) >= tol), repeatable=repeatable,
            ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, nbytes=nbytes, ops_ms=ops_ms,
            ops_rate=rate, bound_ms=bound, bound_share=bound / ms,
            forward_ms=fwd_ms, forward_lse_ms=fwd_lse_ms))
        _log(f"L7 flash backward {label} {cases[-1]['shape']}: dq, dk, dv "
             f"max|d| / max|plain| {[f'{e:.3g}' for e in errs]} (tolerance "
             f"{tol}), a second launch bit-identical: {repeatable}; pair "
             f"{ms:.3f} ms ({2.5 * flops / ms / 1e9:.2f} TFLOP/s as 2.5 x "
             f"the forward's), plain {plain_ms:.3f} ms, SDPA's "
             f"backward {library_ms:.3f} ms, kernel/SDPA "
             f"{ms / library_ms:.3f}; bound {bound:.4f} ms (2.5 x {flops} "
             f"flops as {rate} against {nbytes} bytes over "
             f"{HBM_BYTES_PER_S / 1e12:g} TB/s),"
             f" {bound / ms:.3f} of it reached; forward {fwd_ms:.3f} ms, with"
             f" lse {fwd_lse_ms:.3f} (medians of {FLASH_BWD_REPS}) {tag}")
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    # serving's forward (no lse) at L1's main shape, beside L1's own time
    label, B, Hq, Hkv, L, dh, dtype = FLASH_CASES[0]
    q, k, v = flash_inputs(B, Hq, Hkv, L, dh, dtype, dev)
    serve_ms = float(np.median(event_times(
        lambda: flash_attention_kernel(q, k, v, True), FLASH_REPS)))
    lse_ms = float(np.median(event_times(
        lambda: flash_attention_kernel(q, k, v, True, lse=True), FLASH_REPS)))
    del q, k, v
    torch.cuda.empty_cache()
    _log(f"L7 forward at L1's {label} shape: no lse (serving) {serve_ms:.3f}"
         f" ms, L1's {l1_ms} ms; with lse (training) {lse_ms:.3f} ms {tag}")
    if any(c["out_of_tolerance"] for c in cases):
        raise AssertionError("L7: the flash backward disagrees with its "
                             "plain version")
    if not all(c["repeatable"] for c in cases):
        raise AssertionError("L7: two launches of the flash backward on "
                             "the same inputs differ")
    main = cases[0]
    return {"flash_attention_backward_kernel": dict(
        mismatches=0, max_abs_err=main["max_abs_err"],
        rel_err_dq_dk_dv=main["rel_err_dq_dk_dv"],
        repeatable=main["repeatable"], ms=main["ms"],
        plain_ms=main["plain_ms"], library_ms=main["library_ms"],
        nbytes=main["nbytes"], ops_ms=main["ops_ms"],
        ops_rate=f"2.5 x forward {main['ops_rate']}", shape=main["shape"],
        tolerance=main["tolerance"],
        forward_ms_no_lse_at_l1_shape=serve_ms,
        forward_ms_lse_at_l1_shape=lse_ms, l1_forward_ms=l1_ms,
        cases=[{k: v for k, v in c.items() if k != "nbytes"}
               for c in cases])}


def _train_batch(cfg, B, S, dev):
    """A seeded (tokens, labels) batch of the L8 check."""
    toks = np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


# L8's profiled step: a device kernel's group by its name
TRAIN_PROFILE_GROUPS = (
    ("flash_backward", re.compile(r"lsk_flash_bwd")),
    ("flash_forward", re.compile(r"lsk_flash_attention")),
    ("matmul", re.compile(r"gemm|xmma|cutlass", re.I)),
)


def profile_train_step(cfg, state, dev, tag, mesh=None) -> dict:
    """L8 (L10 with ``mesh``: the sharded step): one more train step of the
    trained state (TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICROBATCHES
    microbatches, the run's optimizer) under the profiler: device kernel
    time by TRAIN_PROFILE_GROUPS (the rest under "other"), each group's
    share of it, the top kernels, and the kernel time's share of the
    profiled step's wall time (the card's busy share; the profiler's host
    overhead lengthens that wall)."""
    from torch.profiler import ProfilerActivity, profile

    opt = AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=max(2, TRAIN_STEPS // 20),
                      decay_steps=TRAIN_STEPS)
    step = step_fns.make_train_step(cfg, opt, TRAIN_MICROBATCHES) \
        if mesh is None else step_fns.make_sharded_train_step(
            cfg, opt, mesh, TRAIN_MICROBATCHES)
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        _sync()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    by_group = {g: 0.0 for g, _ in TRAIN_PROFILE_GROUPS}
    by_group["other"] = 0.0
    for e in kernels:
        g = next((g for g, pat in TRAIN_PROFILE_GROUPS
                  if pat.search(e.key)), "other")
        by_group[g] += e.self_device_time_total / 1e3
    dev_ms = sum(by_group.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = dict(profile_wall_ms=1e3 * wall, profile_device_ms=dev_ms,
               profile_busy_share=dev_ms / 1e3 / wall,
               profile_device_ms_by_group=by_group,
               profile_share_by_group={g: v / max(dev_ms, 1e-12)
                                       for g, v in by_group.items()},
               profile_launches=sum(e.count for e in kernels))
    _log(f"{'L8' if mesh is None else 'L10'} profile of one train step "
         f"({TRAIN_BATCH} x {TRAIN_SEQ} in "
         f"{TRAIN_MICROBATCHES} microbatches): wall {1e3 * wall:.1f} ms, "
         f"device kernels {dev_ms:.1f} ms (busy share "
         f"{out['profile_busy_share']:.4f}), {out['profile_launches']} "
         f"kernels; device ms by group {json.dumps(by_group)}, shares "
         f"{json.dumps(out['profile_share_by_group'])}; top (ms): "
         + json.dumps({e.key[:60]: round(e.self_device_time_total / 1e3, 3)
                       for e in top}) + f" {tag}")
    return out


def train_phase(dev, tag) -> dict:
    """L8: ``launch.train.train`` on SmolLM-135M at its published widths
    and depth, TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens in
    TRAIN_MICROBATCHES microbatches (async saves every TRAIN_CKPT_EVERY
    steps and the final blocking one, into a temporary directory); the
    flash launches counted from 0 over the run. Then one train step from
    one seeded state and batch (TRAIN_CHECK_BATCH x TRAIN_CHECK_SEQ) with
    ``attn_impl="kernel"`` and with ``"plain"``: loss, grad_norm and
    every updated leaf compared."""
    cfg = configs.get(TRAIN_ARCH, reduced=LM_REDUCED)
    n_layers = n_flash_layers(cfg)
    stats = {}
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        (losses, sec), launches = count_launches((), lambda: _timed(
            lambda: train(TRAIN_ARCH, steps=TRAIN_STEPS, smoke=LM_REDUCED,
                          batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                          ckpt_dir=tmp, ckpt_every=TRAIN_CKPT_EVERY,
                          microbatches=TRAIN_MICROBATCHES, log_every=5,
                          seed=SEED, lr_peak=TRAIN_LR, device=dev,
                          stats=stats)))
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in stats["state"].params.parameters())
    profiled = profile_train_step(cfg, stats.pop("state"), dev, tag)
    _free_card()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = 1e3 * float(np.median(stats["step_s"][1:]))
    mb = TRAIN_BATCH // TRAIN_MICROBATCHES
    attn = 3 * n_layers * flash_flops(mb, cfg.n_heads, TRAIN_SEQ,
                                      cfg.head_dim) * TRAIN_MICROBATCHES
    model_flops = 6 * n_params * tokens + attn
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    out = dict(arch=cfg.name, layers=cfg.n_layers, param_count=n_params,
               steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
               microbatches=TRAIN_MICROBATCHES, lr_peak=TRAIN_LR,
               losses=losses, loss_first5=first, loss_last5=last,
               seconds=sec, first_step_ms=1e3 * stats["step_s"][0],
               step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               model_flops_per_step=model_flops,
               model_flops_share_f32_peak=model_flops / (step_ms * 1e-3)
               / F32_FLOPS_PER_S,
               peak_memory_bytes=peak,
               flash_forward_launches=launches["flash_attention_kernel"],
               flash_backward_launches=launches[
                   "flash_attention_backward_kernel"],
               launches=launches,
               grad_norm_last=stats["metrics"][-1]["grad_norm"],
               step_s=stats["step_s"], **profiled)
    _log(f"L8 train {cfg.name} ({cfg.n_layers} layers, {n_params} "
         f"parameters): {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
         f"tokens in {TRAIN_MICROBATCHES} microbatches in {sec:.1f} s; "
         f"first step {out['first_step_ms']:.1f} ms, median of the rest "
         f"{step_ms:.1f} ms ({out['tokens_per_s']:.1f} tokens/s, "
         f"{model_flops / (step_ms * 1e-3) / 1e12:.2f} model TFLOP/s = "
         f"{out['model_flops_share_f32_peak']:.3f} of the f32 peak); loss "
         f"first 5 {first:.4f}, last 5 {last:.4f}; peak device memory "
         f"{peak} bytes; flash launches forward "
         f"{out['flash_forward_launches']}, backward "
         f"{out['flash_backward_launches']} ({n_layers} layers x "
         f"{TRAIN_MICROBATCHES} microbatches x {TRAIN_STEPS} steps) {tag}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError("L8: the loss is not finite or did not fall")

    # one step, kernel against plain attention, from one state and batch
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, decay_steps=10, eps=1e-3)
    batch = _train_batch(cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, dev)
    res = {}
    for impl in ("kernel", "plain"):
        c = cfg.replace(attn_impl=impl)
        state = step_fns.init_train_state(
            c, opt, torch.Generator().manual_seed(SEED), dev)
        (state, m), n = count_launches((), lambda: step_fns.make_train_step(
            c, opt)(state, batch))
        res[impl] = (m, {k: p.detach() for k, p in
                         state.params.named_parameters()}, n)
        del state
        _free_card()
    (mk, pk, nk), (mp, pp, npl) = res["kernel"], res["plain"]
    rel = {k: abs(float(mk[k]) - float(mp[k])) / abs(float(mp[k]))
           for k in ("loss", "grad_norm")}
    param_err = max(float((pk[k] - pp[k]).abs().max()) for k in pp)
    out.update(check_loss_rel=rel["loss"], check_grad_norm_rel=rel[
        "grad_norm"], check_param_max_abs=param_err,
        check_launches_kernel={k: nk[k] for k in TRAIN_PATH},
        check_launches_plain={k: npl[k] for k in TRAIN_PATH})
    loss_k, loss_p = float(mk["loss"]), float(mp["loss"])
    _log(f"L8 one step at {TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ}, kernel vs"
         f" plain attention from one state and batch: loss {loss_k:.6f} vs "
         f"{loss_p:.6f} (rel {rel['loss']:.3g}), "
         f"grad_norm rel {rel['grad_norm']:.3g} (tolerance {TRAIN_REL}), "
         f"every updated leaf max|d| {param_err:.3g} (tolerance "
         f"{TRAIN_PARAM_TOL}); flash launches kernel step "
         f"{out['check_launches_kernel']}, plain step "
         f"{out['check_launches_plain']} {tag}")
    del res, pk, pp
    _free_card()
    if max(rel.values()) > TRAIN_REL or param_err > TRAIN_PARAM_TOL or \
            any(npl[k] for k in TRAIN_PATH):
        raise AssertionError("L8: the kernel and plain train steps differ")
    return out


def check_train_on_the_card(cfg, out) -> None:
    """L8's launch checks, which only the card can make: every step's
    forward and backward took one flash launch a global layer a
    microbatch, and the check's kernel step one each a layer."""
    n = n_flash_layers(cfg)
    want = n * TRAIN_MICROBATCHES * TRAIN_STEPS
    if out["flash_forward_launches"] != want or \
            out["flash_backward_launches"] != want or \
            any(out["check_launches_kernel"][k] != n for k in TRAIN_PATH):
        raise AssertionError(f"L8: flash launches {out['launches']}, check "
                             f"{out['check_launches_kernel']}; want {want} "
                             f"and {n}")


def check_moe_train_on_the_card(out) -> None:
    """L9's path check, which only the card can make: the telemetry's
    insert, pool and scan kernels each launched during the run."""
    if not all(out["launches"][k] for k in MOE_TRAIN_PATH):
        raise AssertionError(f"L9: a kernel of the telemetry path never "
                             f"launched: {out['launches']}")


def moe_train_phase(dev, tag) -> dict:
    """L9: the MoE trainer with telemetry (MOE_TRAIN, as the reference's
    test runs it) on the card, every launch counted from 0, and the same
    from the same seed on the CPU: losses within LOGIT_TOL, the summed
    telemetry matrices equal as int32, ``RouterTelemetry.load_vector`` and
    every capacity factor equal."""
    kw = dict(MOE_TRAIN, smoke=True, ckpt_every=0, log_every=100, seed=SEED)
    card, host = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-moe-") as tmp:
        (losses, sec), launches = count_launches((), lambda: _timed(
            lambda: train(**kw, ckpt_dir=os.path.join(tmp, "card"),
                          device=dev, stats=card)))
        t0 = time.perf_counter()
        want = train(**kw, ckpt_dir=os.path.join(tmp, "cpu"), device="cpu",
                     stats=host)
        cpu_sec = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    tele_equal = torch.equal(card["state"].telemetry.cpu(),
                             host["state"].telemetry)
    load, load_cpu = card["telemetry"].load_vector(), \
        host["telemetry"].load_vector()
    out = dict(arch=MOE_TRAIN["arch"], steps=MOE_TRAIN["steps"],
               seconds=sec, cpu_seconds=cpu_sec, losses=losses,
               loss_rel_err=rel, telemetry_equal=tele_equal,
               telemetry_sum=int(card["state"].telemetry.sum()),
               load_vector_equal=bool(np.array_equal(load, load_cpu)),
               capacity_factors=card["cf"],
               capacity_factors_equal=card["cf"] == host["cf"],
               dropped_last=card["metrics"][-1]["dropped"],
               launches=launches)
    _log(f"L9 MoE trainer {MOE_TRAIN}: card {sec:.2f} s, CPU {cpu_sec:.2f} "
         f"s; losses card vs CPU max rel {rel:.3g} (tolerance {LOGIT_TOL}); "
         f"telemetry matrices {'equal' if tele_equal else 'differ'} (sum "
         f"{out['telemetry_sum']}), load vectors "
         f"{'equal' if out['load_vector_equal'] else 'differ'}, capacity "
         f"factors {card['cf']} vs {host['cf']}; launches on the card "
         f"{ {k: launches[k] for k in MOE_TRAIN_PATH + TRAIN_PATH} } {tag}")
    del card, host
    _free_card()
    if not (rel <= LOGIT_TOL and tele_equal and out["load_vector_equal"]
            and out["capacity_factors_equal"]):
        raise AssertionError("L9: the card's MoE trainer differs from the "
                             "CPU's")
    return out


def _step_errors(got, want) -> tuple:
    """(loss rel, grad_norm rel, every parameter's max|d|) of two
    (metrics, {name: parameter}) results."""
    (mg, pg), (mw, pw) = got, want
    rel = [abs(float(mg[k]) - float(mw[k])) / abs(float(mw[k]))
           for k in ("loss", "grad_norm")]
    err = max(float((pg[k].detach() - pw[k].detach()).abs().max())
              for k in pw)
    return rel[0], rel[1], err


def _sharded_vs_unsharded(cfg, mesh, batches, dev) -> tuple:
    """The same steps, sharded over ``mesh`` and unsharded, from one
    seeded state (eps = 1e-3, as L8's check): the errors after each step
    (``_step_errors``) and the telemetry matrices equal."""
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, decay_steps=10, eps=1e-3)
    plain = step_fns.init_train_state(
        cfg, opt, torch.Generator().manual_seed(SEED), dev)
    sharded = step_fns.shard_state(cfg, opt, plain, mesh)
    s_step = step_fns.make_sharded_train_step(cfg, opt, mesh)
    p_step = step_fns.make_train_step(cfg, opt)
    errs = []
    for b in batches:
        sharded, ms = s_step(sharded, b)
        plain, mp = p_step(plain, b)
        full = step_fns.full_state_leaves(sharded)
        pg = {k[len("params."):]: v for k, v in full.items()
              if k.startswith("params.")}
        errs.append(_step_errors((ms, pg), (mp, dict(
            plain.params.named_parameters()))))
        del full, pg
    tele = torch.equal(sharded.telemetry, plain.telemetry)
    del sharded, plain
    _free_card()
    return errs, tele


def sharded_cli(dev, tmp) -> dict:
    """L10: ``launch.train --mesh 1`` as a process, at L8's shapes (its
    own spawned one-rank group); its exit, seconds and first loss."""
    root = Path(__file__).resolve().parent
    argv = ["--arch", TRAIN_ARCH, "--mesh", "1", "--steps",
            str(SHARDED_CLI_STEPS), "--batch-size", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--microbatches",
            str(TRAIN_MICROBATCHES), "--ckpt-dir", os.path.join(tmp, "cli")]
    argv += ["--device", "cpu"] if dev.type == "cpu" else []
    argv += [] if LM_REDUCED else ["--full"]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                          *argv], cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        text = p.communicate(timeout=600)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    sec = time.perf_counter() - t0
    m = re.search(r"final loss (\S+) \(first (\S+)\)", text)
    if p.returncode != 0 or m is None:
        raise AssertionError(f"L10: launch.train {' '.join(argv)} exited "
                             f"{p.returncode}:\n{text[-2000:]}")
    return dict(argv=argv, exit=p.returncode, seconds=sec,
                first_loss=float(m.group(2)), final_loss=float(m.group(1)))


def sharded_train_phase(dev, tag, l8: dict) -> dict:
    """L10 (see the module docstring): a one-rank group on this card
    (NCCL; gloo on the CPU), destroyed at the end. ``l8``: L8's numbers
    (its losses and ms a step)."""
    cfg = configs.get(TRAIN_ARCH, reduced=LM_REDUCED)
    tmp = tempfile.mkdtemp(prefix="phase-l10-")
    init_group(0, 1, os.path.join(tmp, "rendezvous"), backend_for(dev))
    try:
        mesh = make_smoke_mesh(1, 1, dev.type)
        stats = {}
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        (losses, sec), launches = count_launches((), lambda: _timed(
            lambda: train(TRAIN_ARCH, steps=SHARDED_STEPS, smoke=LM_REDUCED,
                          batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                          ckpt_dir=os.path.join(tmp, "ckpt"), ckpt_every=0,
                          microbatches=TRAIN_MICROBATCHES, log_every=5,
                          seed=SEED, lr_peak=TRAIN_LR,
                          schedule_steps=TRAIN_STEPS, device=dev,
                          stats=stats, mesh=mesh)))
        peak = torch.cuda.max_memory_allocated()
        profiled = profile_train_step(cfg, stats.pop("state"), dev, tag,
                                      mesh)
        _free_card()
        step_ms = 1e3 * float(np.median(stats["step_s"][1:]))
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(losses, l8["losses"][:SHARDED_STEPS]))
        out = dict(mesh=[1, 1], steps=SHARDED_STEPS, losses=losses,
                   loss_rel_to_l8=loss_rel, seconds=sec,
                   first_step_ms=1e3 * stats["step_s"][0], step_ms=step_ms,
                   l8_step_ms=l8["step_ms"],
                   step_ms_over_l8=step_ms / l8["step_ms"],
                   peak_memory_bytes=peak,
                   flash_forward_launches=launches["flash_attention_kernel"],
                   flash_backward_launches=launches[
                       "flash_attention_backward_kernel"],
                   launches=launches, **profiled)
        _log(f"L10 sharded train {cfg.name} on a 1 x 1 mesh (one-rank "
             f"{backend_for(dev)} group): {SHARDED_STEPS} steps of "
             f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICROBATCHES} "
             f"microbatches in {sec:.1f} s; first step "
             f"{out['first_step_ms']:.1f} ms, median of the rest "
             f"{step_ms:.1f} ms beside L8's {l8['step_ms']:.1f} ms "
             f"({out['step_ms_over_l8']:.4f}x); losses within "
             f"{loss_rel:.3g} of L8's first {SHARDED_STEPS} (tolerance "
             f"{TRAIN_REL}); peak device memory {peak} bytes; flash "
             f"launches forward {out['flash_forward_launches']}, backward "
             f"{out['flash_backward_launches']} {tag}")

        batch = _train_batch(cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, dev)
        errs, _ = _sharded_vs_unsharded(cfg, mesh, [batch], dev)
        out.update(check_loss_rel=errs[0][0], check_grad_norm_rel=errs[0][1],
                   check_param_max_abs=errs[0][2])
        _log(f"L10 one step at {TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ}, "
             f"sharded vs unsharded from one state and batch: loss rel "
             f"{errs[0][0]:.3g}, grad_norm rel {errs[0][1]:.3g} (tolerance "
             f"{TRAIN_REL}), every leaf max|d| {errs[0][2]:.3g} (tolerance "
             f"{TRAIN_PARAM_TOL}) {tag}")

        kcfg = configs.get(MOE_TRAIN["arch"], reduced=True)
        rng = np.random.default_rng(SEED + 10)
        kb = [{k: torch.from_numpy(rng.integers(
            0, kcfg.vocab_size, (MOE_TRAIN["batch_size"],
                                 MOE_TRAIN["seq_len"]), dtype=np.int32)).to(
            dev) for k in ("tokens", "labels")}
            for _ in range(SHARDED_MOE_STEPS)]
        with CollectiveLog() as clog:
            kerrs, ktele = _sharded_vs_unsharded(kcfg, mesh, kb, dev)
        calls = clog.summary()
        n_moe = sum(p.mlp == "moe" for p in lm.plans(kcfg)[0].layers)
        out["moe"] = dict(arch=kcfg.name, steps=SHARDED_MOE_STEPS,
                          errors=kerrs, telemetry_equal=ktele,
                          collectives=calls, moe_layers=n_moe)
        _log(f"L10 {kcfg.name} through the expert-parallel branch on the "
             f"1 x 1 mesh, {SHARDED_MOE_STEPS} steps against the unsharded "
             f"branch: (loss rel, grad_norm rel, max|d|) {kerrs}, telemetry "
             f"{'equal' if ktele else 'differs'}; collectives "
             f"{json.dumps(calls)} ({n_moe} MoE layers) {tag}")

        out["cli"] = sharded_cli(dev, tmp)
        cli_rel = abs(out["cli"]["first_loss"] - l8["losses"][0]) / \
            abs(l8["losses"][0])
        out["cli"]["first_loss_rel_to_l8"] = cli_rel
        _log(f"L10 launch.train {' '.join(out['cli']['argv'])}: exit "
             f"{out['cli']['exit']} in {out['cli']['seconds']:.1f} s, first "
             f"loss {out['cli']['first_loss']:.6f} (L8's "
             f"{l8['losses'][0]:.6f}, rel {cli_rel:.3g}) {tag}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [loss_rel, cli_rel] + list(errs[0][:2]) + \
        [e for k in kerrs for e in k[:2]]
    if max(bad) > TRAIN_REL or max([errs[0][2]] + [k[2] for k in kerrs]) \
            > TRAIN_PARAM_TOL or not ktele or \
            calls["all_gather"]["calls"] < 2 * n_moe * SHARDED_MOE_STEPS:
        raise AssertionError("L10: the sharded trainer differs from the "
                             "unsharded one, or the MoE's expert-parallel "
                             "branch did not run")
    return out


def check_sharded_train_on_the_card(cfg, out) -> None:
    """L10's launch check, which only the card can make: one forward and
    one backward flash launch a global layer a microbatch a step."""
    want = n_flash_layers(cfg) * TRAIN_MICROBATCHES * SHARDED_STEPS
    if out["flash_forward_launches"] != want or \
            out["flash_backward_launches"] != want:
        raise AssertionError(f"L10: flash launches {out['launches']}; want "
                             f"{want} each")


class InjectedFault(RuntimeError):
    """The fault L11 injects into the trainer."""


@contextlib.contextmanager
def inject_fault(after: int):
    """While entered, ``launch.train``'s step raises ``InjectedFault`` once,
    when it is called for the step after step ``after`` (the state has
    ``after + 1`` steps done). Yields a log: the fault's time and the
    start time of every step call, the first after the fault's
    included."""
    inner = train_mod.make_train_step
    log = {"fault_t": None, "first_after": None, "calls": []}

    def make(cfg, opt_cfg, microbatches=1):
        fn = inner(cfg, opt_cfg, microbatches)

        def step(state, batch):
            t = time.perf_counter()
            if log["fault_t"] is None and int(state.step) == after + 1:
                log["fault_t"] = t
                raise InjectedFault(f"fault injected after step {after}")
            if log["fault_t"] is not None and log["first_after"] is None:
                log["first_after"] = t
            log["calls"].append(t)
            return fn(state, batch)
        return step

    train_mod.make_train_step = make
    try:
        yield log
    finally:
        train_mod.make_train_step = inner


class _ReplayClock(HostClock):
    """A host clock that reads back recorded times."""

    t = 0.0

    def now(self) -> float:
        return self.t


def restart_run(kw: dict, ckpt_dir: str, fault_after: int = None,
                ckpt_every: int = None) -> dict:
    """``train(resume=True, **kw)`` under ``RestartLoop`` with a checkpoint
    every ``ckpt_every`` steps into ``ckpt_dir`` and a fault injected once
    after step ``fault_after``: the final step, the restarts, each
    segment's start and step seconds, the losses stitched from the
    segments (the first segment's up to its restored checkpoint), the
    seconds of the restart (from the fault to the end of the first step
    after it) and the step-call times."""
    fault_after = RESTART_FAULT_AFTER if fault_after is None else fault_after
    ckpt_every = RESTART_CKPT_EVERY if ckpt_every is None else ckpt_every
    steps = kw["steps"]
    segments = []
    manager = CheckpointManager(ckpt_dir, keep=2)

    def run_fn(start: int) -> int:
        stats = {}
        segments.append(dict(start=start, stats=stats))
        train(**kw, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, resume=True,
              stats=stats)
        return steps

    loop = RestartLoop(run_fn, lambda: manager.latest_step() or 0,
                       max_restarts=1)
    with inject_fault(fault_after) as log:
        final = loop.run()
    losses, step_s = [], []
    for seg, nxt in zip(segments, segments[1:] + [None]):
        upto = None if nxt is None else nxt["start"] - seg["start"]
        losses += [m["loss"] for m in seg["stats"]["metrics"]][:upto]
        step_s += seg["stats"]["step_s"][:upto]
    restart_s = None if log["first_after"] is None else \
        log["first_after"] - log["fault_t"] + \
        segments[1]["stats"]["step_s"][0]
    return dict(final_step=final, restarts=loop.restarts,
                starts=[seg["start"] for seg in segments],
                segment_losses=[[m["loss"] for m in seg["stats"]["metrics"]]
                                for seg in segments],
                losses=losses, step_s=step_s, restart_s=restart_s,
                call_times=log["calls"], fault_t=log["fault_t"])


def health_checks(hosts: dict, beats: list) -> dict:
    """``StragglerPolicy`` fed each host's step seconds, step by step (the
    stragglers it names after each), and a one-host ``HeartbeatMonitor``
    fed ``beats`` (times, on a replay of the run's clock; a sweep after
    each): what each reported."""
    pol = StragglerPolicy()
    flagged = []
    for i in range(min(len(v) for v in hosts.values())):
        for h, v in hosts.items():
            pol.record(h, v[i])
        flagged.append(pol.stragglers())
    clock = _ReplayClock()
    clock.t = beats[0]
    mon = HeartbeatMonitor(["card0"], clock=clock)
    sweeps = []
    for t in beats:
        clock.t = t
        mon.beat("card0")
        sweeps.append(mon.sweep())
    return dict(stragglers=sorted({h for f in flagged for h in f}),
                ewma=dict(pol.ewma), suspect=sorted(
                    {h for sw in sweeps for h in sw["suspect"]}),
                dead=sorted({h for sw in sweeps for h in sw["dead"]}),
                beats=len(beats))


def restart_phase(dev, tag, l8: dict) -> dict:
    """L11 (see RESTART_*): an unbroken run, then the crashed one under
    ``RestartLoop``; its stitched losses must be the unbroken run's bit
    for bit, its restarted first step the crashed segment's last step
    bit for bit, one restart, the last step RESTART_STEPS; the health
    policies fed its step times (beside the unbroken run's and L8's
    steady ones) report no straggler and no dead host. ``l8``: L8's
    numbers (its step seconds)."""
    cfg = configs.get(TRAIN_ARCH, reduced=LM_REDUCED)
    kw = dict(arch=TRAIN_ARCH, steps=RESTART_STEPS, smoke=LM_REDUCED,
              batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
              microbatches=TRAIN_MICROBATCHES, log_every=100, seed=SEED,
              lr_peak=TRAIN_LR, device=dev)
    _free_card()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-restart-") as tmp:
        stats = {}
        (unbroken, u_sec), u_launches = count_launches((), lambda: _timed(
            lambda: train(**kw, ckpt_dir=os.path.join(tmp, "unbroken"),
                          ckpt_every=0, stats=stats)))
        u_step_s = stats["step_s"]
        del stats
        _free_card()
        (run, sec), launches = count_launches((), lambda: _timed(
            lambda: restart_run(kw, os.path.join(tmp, "crash"))))
    _free_card()
    seg = run["segment_losses"]
    same_step = len(seg) > 1 and seg[0][RESTART_FAULT_AFTER] == seg[1][0]
    beats = [t - run["call_times"][0] for t in run["call_times"]]
    health = health_checks({"unbroken": u_step_s, "restarted": run["step_s"],
                            "L8": l8["step_s"][1:]}, beats)
    out = dict(steps=RESTART_STEPS, ckpt_every=RESTART_CKPT_EVERY,
               fault_after=RESTART_FAULT_AFTER, unbroken_losses=unbroken,
               unbroken_seconds=u_sec, seconds=sec,
               losses_equal=run["losses"] == unbroken,
               restarted_step_equal=same_step, health=health,
               **{k: run[k] for k in ("final_step", "restarts", "starts",
                                      "losses", "segment_losses",
                                      "restart_s", "step_s")},
               unbroken_step_s=u_step_s,
               flash_forward_launches=launches["flash_attention_kernel"] +
               u_launches["flash_attention_kernel"],
               flash_backward_launches=launches[
                   "flash_attention_backward_kernel"] +
               u_launches["flash_attention_backward_kernel"],
               launches={k: launches[k] + u_launches[k] for k in launches})
    _log(f"L11 crash and restore of {cfg.name} ({TRAIN_BATCH} x {TRAIN_SEQ} "
         f"in {TRAIN_MICROBATCHES} microbatches): unbroken {RESTART_STEPS} "
         f"steps in {u_sec:.1f} s; under RestartLoop a checkpoint every "
         f"{RESTART_CKPT_EVERY} steps, a fault after step "
         f"{RESTART_FAULT_AFTER}: {run['restarts']} restart, segments from "
         f"steps {run['starts']}, final step {run['final_step']} in "
         f"{sec:.1f} s; restart (restore and the first step after it) "
         f"{run['restart_s']:.3f} s; stitched losses "
         f"{'equal' if out['losses_equal'] else 'differ from'} the "
         f"unbroken run's bit for bit ({run['losses']} vs {unbroken}); the "
         f"restored step {RESTART_FAULT_AFTER} "
         f"{'repeats' if same_step else 'differs from'} the crashed one's "
         f"loss bit for bit; StragglerPolicy stragglers {health['stragglers']}"
         f" (EWMA s {json.dumps(health['ewma'])}), HeartbeatMonitor over "
         f"{health['beats']} beats suspect {health['suspect']} dead "
         f"{health['dead']}; flash launches forward "
         f"{out['flash_forward_launches']}, backward "
         f"{out['flash_backward_launches']} {tag}")
    if not (out["losses_equal"] and same_step and run["restarts"] == 1
            and run["final_step"] == RESTART_STEPS
            and run["starts"] == [0, RESTART_FAULT_AFTER]
            and not health["stragglers"] and not health["dead"]):
        raise AssertionError("L11: the restarted run differs from the "
                             "unbroken one, or the health policies flagged "
                             "a host")
    return out


def check_restart_on_the_card(cfg, out) -> None:
    """L11's launch check, which only the card can make: one forward and
    one backward flash launch a global layer a microbatch for every step
    run (the unbroken run's, the crashed segment's and the restarted
    one's)."""
    steps = 2 * RESTART_STEPS + 1  # the crashed segment ran one step twice
    want = n_flash_layers(cfg) * TRAIN_MICROBATCHES * steps
    if out["flash_forward_launches"] != want or \
            out["flash_backward_launches"] != want:
        raise AssertionError(f"L11: flash launches {out['launches']}; want "
                             f"{want} each")


class TpCommLog:
    """While entered, counts every ``torch.distributed`` ``all_reduce`` and
    ``all_gather`` call of this process, their result bytes and the host
    seconds inside them (a gloo call returns when its result has landed
    on the card)."""

    NAMES = ("all_reduce", "all_gather")

    def __enter__(self):
        self.calls = {n: 0 for n in self.NAMES}
        self.bytes = {n: 0 for n in self.NAMES}
        self.seconds = {n: 0.0 for n in self.NAMES}
        self.saved = {n: getattr(dist, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(dist, n, self._wrap(n, fn))
        return self

    def _wrap(self, name, fn):
        def call(out, *args, **kw):
            self.calls[name] += 1
            self.bytes[name] += sum(t.numel() * t.element_size() for t in (
                out if isinstance(out, (list, tuple)) else [out]))
            t0 = time.perf_counter()
            try:
                return fn(out, *args, **kw)
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return call

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(dist, n, fn)

    def summary(self) -> dict:
        return {n: dict(calls=self.calls[n], bytes=self.bytes[n],
                        seconds=self.seconds[n]) for n in self.NAMES}


def tp_rank_body(shape, dev_type: str, run: dict) -> dict:
    """One model rank of L12 (``spawn_ranks``, a gloo group): the split
    step's gradient from the seeded state (its flash calls noted), then
    ``run["steps"]`` timed split steps with the flash launches counted and
    the collectives logged, then the one-device gradient of the same state
    and batch to hold this rank's shards to. ``run``: the arch, whether
    reduced, batch, seq and steps (the module's settings: a spawned rank
    imports this script afresh). Every rank's numbers, gathered."""
    dev = torch.device(dev_type)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        build.load_library()
    cfg = configs.get(run["arch"], reduced=run["reduced"])
    opt = AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=2, decay_steps=10,
                      eps=1e-3)
    mesh = make_smoke_mesh(*shape, dev.type)
    rank = dist.get_rank()
    rng = np.random.default_rng(SEED + 12)
    batches = [{k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (run["batch"], run["seq"]),
        dtype=np.int32)).to(dev) for k in ("tokens", "labels")}
        for _ in range(run["steps"])]

    def initial():
        return step_fns.init_train_state(
            cfg, opt, torch.Generator().manual_seed(SEED), dev)

    state = step_fns.shard_state(cfg, opt, initial(), mesh)
    placements = {k: p.placements for k, p in state.params.named_parameters()}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    calls = []
    fwd = flash_ops.flash_attention_kernel

    def noted(q, k, v, causal=True, lse=False, q_offset=0):
        calls.append((tuple(q.shape), tuple(k.shape), int(q_offset)))
        return fwd(q, k, v, causal, lse, q_offset)

    flash_ops.flash_attention_kernel = noted
    try:  # the check's gradient, and the warm-up
        loss, _, grads = step_fns.sharded_grads(cfg, state, batches[0], mesh)
    finally:
        flash_ops.flash_attention_kernel = fwd
    loss = float(loss)
    held = sum(g.numel() * g.element_size() for g in grads.values())
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    step = step_fns.make_sharded_train_step(cfg, opt, mesh)
    times, metrics = [], []

    def steps():
        nonlocal state
        for b in batches:
            t0 = time.perf_counter()
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
            times.append(time.perf_counter() - t0)

    with TpCommLog() as comm:
        _, launches = count_launches((), steps)
    peak = torch.cuda.max_memory_allocated() - held if cuda else 0
    del state
    gc.collect()

    plain = initial()  # the one-device gradient of the same state and batch
    loss_p, _, want = step_fns._grads(cfg, plain.params, batches[0])
    del plain
    gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                 for g in want.values())))
    err = max(float((grads[k] - local_slice(w, placements[k], mesh)).abs()
                    .max()) / max(float(w.abs().max()), 1e-30)
              for k, w in want.items())
    mine = dict(rank=rank, flash_calls=calls, launches=launches,
                step_s=times, peak_bytes=peak, grad_err=err,
                collectives=comm.summary())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    del grads, want
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return dict(ranks=every, loss=loss, loss_plain=float(loss_p),
                metrics=metrics, grad_norm_plain=gnorm,
                backend=dist.get_backend())


def tp_expected_calls(cfg, shape, batch: int, seq: int) -> list:
    """The flash calls each rank of ``shape`` makes in one forward: the
    head-parallel layers on ``[B, H/tp, L, dh]`` (the KV heads its query
    heads read), the "sp" fallback on ``[B, H, L/tp, dh]`` at
    ``q_offset = r L/tp``; by rank."""
    tp = shape[1]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = n_flash_layers(cfg)
    out = []
    for r in range(shape[0] * tp):
        if H % tp == 0:
            # the KV heads the rank reads, whole per query head where its
            # query heads do not group over them
            _, kv, idx = tattn._kv_heads(cfg, tp, r % tp)
            kv = kv if idx is None else H // tp
            call = ((batch, H // tp, seq, dh), (batch, kv, seq, dh), 0)
        else:
            call = ((batch, H, seq // tp, dh), (batch, KV, seq, dh),
                    (r % tp) * seq // tp)
        out.append([call] * n)
    return out


def tp_phase(dev, tag, run: dict | None = None) -> dict:
    """L12 (see TP_*): each mesh of TP_MESHES as gloo ranks on this card
    (``tp_rank_body``), against the one-device step; step times, rank 0's
    peak memory, the collectives' counts and bytes and every rank's flash
    launches and shapes."""
    run = run or dict(arch=TRAIN_ARCH, reduced=LM_REDUCED, batch=TP_BATCH,
                      seq=TP_SEQ, steps=TP_STEPS)
    cfg = configs.get(run["arch"], reduced=run["reduced"])
    out, bad = {}, []
    total = {n: 0 for n in WRAPPERS}
    for shape in TP_MESHES:
        world = shape[0] * shape[1]
        tmp = tempfile.mkdtemp(prefix="phase-l12-")
        t0 = time.perf_counter()
        try:
            res = spawn_ranks(tp_rank_body, world, device=dev,
                              backend="gloo", init_file=os.path.join(
                                  tmp, "rendezvous"),
                              args=(shape, dev.type, run))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        sec = time.perf_counter() - t0
        want_calls = tp_expected_calls(cfg, shape, run["batch"], run["seq"])
        got_calls = [r["flash_calls"] for r in res["ranks"]]
        m0 = res["metrics"][0]
        loss_rel = abs(res["loss"] - res["loss_plain"]) / abs(
            res["loss_plain"])
        step_loss_rel = abs(m0["loss"] - res["loss_plain"]) / abs(
            res["loss_plain"])
        gnorm_rel = abs(m0["grad_norm"] - res["grad_norm_plain"]) / abs(
            res["grad_norm_plain"])
        grad_err = max(r["grad_err"] for r in res["ranks"])
        r0 = res["ranks"][0]
        step_ms = [1e3 * t for t in r0["step_s"]]
        launches = [{k: r["launches"][k] for k in TRAIN_PATH}
                    for r in res["ranks"]]
        for r in res["ranks"]:
            for n, c in r["launches"].items():
                total[n] += c
        name = "x".join(map(str, shape))
        out[name] = dict(
            mesh=list(shape), seconds=sec, backend=res["backend"],
            staging="gloo stages CUDA tensors through host memory",
            loss=res["loss"], loss_plain=res["loss_plain"],
            loss_rel=loss_rel, step_loss_rel=step_loss_rel,
            grad_norm_rel=gnorm_rel, grad_rel_err=grad_err,
            step_ms=step_ms, peak_memory_bytes=r0["peak_bytes"],
            collectives=r0["collectives"], launches=launches,
            flash_calls_match=got_calls == want_calls,
            flash_call_shapes=sorted({c for r in got_calls for c in r}))
        _log(f"L12 {cfg.name} tensor parallel on a {name} mesh ({world} "
             f"ranks as processes on this card, {res['backend']} group, "
             f"collectives staged through host memory by gloo): "
             f"{run['steps']} steps of {run['batch']} x {run['seq']}, "
             f"step ms {[round(t, 1) for t in step_ms]} (rank 0), spawned "
             f"and run in {sec:.1f} s; loss {res['loss']:.6f} against the "
             f"one-device {res['loss_plain']:.6f} (rel {loss_rel:.3g}, the "
             f"step's {step_loss_rel:.3g}), grad_norm rel {gnorm_rel:.3g}, "
             f"every gradient leaf within {grad_err:.3g} of its largest "
             f"magnitude (tolerance {TRAIN_REL}); rank 0's peak device "
             f"memory {r0['peak_bytes']} bytes; rank 0's collectives a run "
             f"{json.dumps(r0['collectives'])} {tag}")
        _log(f"L12 {name} flash launches by rank (forward, backward): "
             f"{[(x['flash_attention_kernel'], x['flash_attention_backward_kernel']) for x in launches]}; "  # noqa: E501
             f"call shapes (q, k, q_offset) {out[name]['flash_call_shapes']}"
             f" ({'as' if out[name]['flash_calls_match'] else 'NOT as'} "
             f"the split asks) {tag}")
        if max(loss_rel, step_loss_rel, gnorm_rel, grad_err) > TRAIN_REL \
                or not out[name]["flash_calls_match"]:
            bad.append(name)
    out["launches"] = total
    if bad:
        raise AssertionError(f"L12: the split step differs from the "
                             f"one-device step, or its flash calls from "
                             f"the split's shapes, on {bad}")
    return out


def check_tp_on_the_card(cfg, out, steps: int = TP_STEPS) -> None:
    """L12's launch check, which only the card can make: every rank launched
    one forward and one backward flash kernel a global layer a step."""
    want = n_flash_layers(cfg) * steps
    for shape in TP_MESHES:
        got = out["x".join(map(str, shape))]["launches"]
        if any(x[k] != want for x in got for k in TRAIN_PATH):
            raise AssertionError(f"L12: flash launches {got}; want {want} "
                                 f"each a rank")


def check_flash_tp_rows(dev, tag) -> dict:
    """L12's kernel rows: the flash forward (out and lse) and backward pair
    at every distinct (q shape, k shape, q_offset) L12's ranks launch
    (``tp_expected_calls`` over TP_MESHES), f32 as the trainer runs them,
    against ``flash_attention_plain`` and ``flash_attention_backward_plain``
    on the same card tensors (the backward from the forward's own out and
    lse): out at L1's tolerance (``flash_check``), lse within TP_LSE_TOL,
    dq, dk and dv at L7's (``FLASH_BWD_TOL``); CUDA-event medians of each.
    Raises on any mismatch."""
    cfg = configs.get(TRAIN_ARCH, reduced=LM_REDUCED)
    calls = []
    for shape in TP_MESHES:
        for rank in tp_expected_calls(cfg, shape, TP_BATCH, TP_SEQ):
            calls += [c for c in dict.fromkeys(rank) if c not in calls]
    fwd, bwd = [], []
    for qs, ks, off in calls:
        rng = np.random.default_rng(SEED + qs[1] + qs[2] + off)
        q, k, v, do = [torch.from_numpy(rng.standard_normal(
            s, dtype=np.float32)).to(dev) for s in (qs, ks, ks, qs)]
        out, lse = flash_attention_kernel(q, k, v, True, lse=True,
                                          q_offset=off)
        want, lse_p = flash_attention_plain(q, k, v, True, lse=True,
                                            q_offset=off)
        got = flash_attention_backward_kernel(q, k, v, out, lse, do, True,
                                              off)
        wgrad = flash_attention_backward_plain(q, k, v, out, lse, do, True,
                                               off)
        _sync()
        err, n_bad, tol = flash_check(out, want)
        lse_err = float((lse - lse_p).abs().max())
        n_lse = int(((lse - lse_p).abs() >= TP_LSE_TOL).sum())
        errs = flash_bwd_errors(got, wgrad)
        b_err = max(float((a - b).abs().max()) for a, b in zip(got, wgrad))
        del want, lse_p, got, wgrad
        times = {name: float(np.median(event_times(fn, FLASH_BWD_REPS)))
                 for name, fn in (
                     ("ms", lambda: flash_attention_kernel(
                         q, k, v, True, lse=True, q_offset=off)),
                     ("plain_ms", lambda: flash_attention_plain(
                         q, k, v, True, lse=True, q_offset=off)),
                     ("bwd_ms", lambda: flash_attention_backward_kernel(
                         q, k, v, out, lse, do, True, off)),
                     ("bwd_plain_ms", lambda: flash_attention_backward_plain(
                         q, k, v, out, lse, do, True, off)))}
        label = (f"L12 q {list(qs)} k {list(ks)} q_offset {off} float32")
        fwd.append(dict(label=label, max_abs_err=err, lse_max_abs_err=lse_err,
                        out_of_tolerance=n_bad + n_lse,
                        tolerance=f"{tol}; lse |d| < {TP_LSE_TOL}",
                        ms=times["ms"], plain_ms=times["plain_ms"]))
        bwd.append(dict(label=label, rel_err_dq_dk_dv=errs, max_abs_err=b_err,
                        tolerance=FLASH_BWD_TOL[torch.float32],
                        out_of_tolerance=int(max(errs) >= FLASH_BWD_TOL[
                            torch.float32]),
                        ms=times["bwd_ms"], plain_ms=times["bwd_plain_ms"]))
        _log(f"L12 flash rows {label}: forward out max_abs_err={err:.3g} "
             f"({tol}; {n_bad} out), lse {lse_err:.3g} (|d| < "
             f"{TP_LSE_TOL}; {n_lse} out); backward dq, dk, dv max|d| / "
             f"max|plain| {[f'{e:.3g}' for e in errs]} (tolerance "
             f"{FLASH_BWD_TOL[torch.float32]}); forward {times['ms']:.3f} "
             f"ms, plain {times['plain_ms']:.3f} ms; pair "
             f"{times['bwd_ms']:.3f} ms, plain {times['bwd_plain_ms']:.3f} "
             f"ms (medians of {FLASH_BWD_REPS}) {tag}")
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    bad = [r["label"] for r in fwd + bwd if r["out_of_tolerance"]]
    if bad:
        raise AssertionError(f"L12: the flash kernels disagree with their "
                             f"plain versions at {bad}")
    return dict(forward=fwd, backward=bwd)


# --------------------------------------------------------------------------
# L13: sharded serving
# --------------------------------------------------------------------------

def _serve_requests(cfg, serve: dict) -> list:
    """The prompts of L13's servers, seeded."""
    rng = np.random.default_rng(SEED + 13)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                          serve["prompt"])]
            for _ in range(serve["requests"])]


def _recording_server(server, logits: list, times: list):
    """``server`` with each step's logits (on the host) and seconds noted."""
    inner = server._step

    def step(params, caches, tokens):
        t0 = time.perf_counter()
        out = inner(params, caches, tokens)
        logits.append(out[0][:, 0].float().cpu())
        times.append(time.perf_counter() - t0)
        return out

    server._step = step
    return server


def cp_pos0(cfg, seq: int) -> int:
    """L13c's first decode position: near the cache's end and past the
    local rings' wrap, so that the steps' ring slots straddle the boundary
    of the two data ranks' blocks."""
    ring = min(seq, cfg.sliding_window or seq)
    return seq - ring + ring // 2 - 2


def seeded_cp_caches(cfg, seq: int, dev, mesh=None) -> list:
    """L13c's caches of one sequence of ``seq`` slots, drawn leaf by leaf
    from a seed on ``dev``, every ``pos`` at ``cp_pos0``; with ``mesh``,
    each layer's leaves as this rank's shards (``step_fns.shard_caches``),
    one whole layer at a time on the rank."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    pos0 = cp_pos0(cfg, seq)
    out = []
    for spec in step_fns.cache_specs(cfg, 1, seq):
        layer = {"mixer": {
            name: torch.full(shape, pos0, dtype=dtype, device=dev)
            if name == "pos" else torch.randn(shape, generator=gen,
                                              dtype=dtype, device=dev)
            for name, (shape, dtype) in spec["mixer"].items()}}
        if mesh is not None:
            layer = step_fns.shard_caches(cfg, [layer], mesh)[0]
        out.append(layer)
    return out


def _timed_on(cuda: bool, fn):
    """(``fn()``, its seconds), the card synchronised around it where the
    rank runs on one."""
    if cuda:
        _sync()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        _sync()
    return out, time.perf_counter() - t0


def _peak_reset(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(cuda: bool) -> int:
    if not cuda:
        return 0
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def serve_cfg(run: dict):
    """An L13 part's config: the arch's, its depth cut to ``run["layers"]``
    where given."""
    cfg = configs.get(run["arch"], reduced=run["reduced"])
    return cfg.replace(n_layers=run["layers"]) if "layers" in run else cfg


def _serve_part(run: dict, ref: dict, dev, cuda: bool) -> tuple:
    """One L13 part on this rank (see ``serve_rank_body``): (this rank's
    numbers, rank 0's comparisons)."""
    cfg = serve_cfg(run)
    mesh = make_smoke_mesh(*run["mesh"], dev.type)
    rank = dist.get_rank()
    params = step_fns.init_sharded_params(
        cfg, mesh, torch.Generator(device=dev).manual_seed(SEED))
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    mine, res = {}, {}
    calls = []
    fwd = flash_ops.flash_attention_kernel

    def noted(q, k, v, causal=True, lse=False, q_offset=0):
        calls.append((tuple(q.shape), tuple(k.shape), int(q_offset)))
        return fwd(q, k, v, causal, lse, q_offset)

    if "prefill" in run:
        tokens = ref["prefill_tokens"].to(dev)
        step = step_fns.make_sharded_prefill_step(cfg, mesh)
        flash_ops.flash_attention_kernel = noted
        try:
            with TpCommLog() as comm:
                _peak_reset(cuda)
                (logits, sec), launches = count_launches((), lambda: _timed_on(
                    cuda, lambda: step(params, {"tokens": tokens})))
                peak = _peak(cuda)
        finally:
            flash_ops.flash_attention_kernel = fwd
        mine["prefill"] = dict(launches=launches, flash_calls=calls,
                               peak_bytes=peak, seconds=sec,
                               collectives=comm.summary())
        if rank == 0:
            want = ref["prefill_logits"]
            res["prefill_logit_rel_err"] = logit_err(
                logits, want, float(want.abs().max()))
        del logits
    if "serve" in run:
        logits, times = [], []
        server = _recording_server(DecodeServer(
            cfg, params, batch_slots=run["serve"]["batch_slots"],
            max_seq=run["serve"]["max_seq"], device=dev, mesh=mesh),
            logits, times)
        reqs = [Request(prompt=p, max_new=run["serve"]["max_new"])
                for p in ref["prompts"]]
        with TpCommLog() as comm:
            _peak_reset(cuda)
            (_, sec), launches = count_launches((), lambda: _timed_on(
                cuda, lambda: server.run(reqs)))
            peak = _peak(cuda)
        mine["decode"] = dict(launches=launches, peak_bytes=peak,
                              seconds=sec, step_s=times,
                              collectives=comm.summary())
        if rank == 0:
            res["decode_tokens_equal"] = [r.out for r in reqs] == \
                ref["server_tokens"]
            res["decode_logit_rel_err"] = max(
                logit_err(g.to(dev), w, float(w.abs().max()))
                for g, w in zip(logits, ref["server_logits"])) \
                if len(logits) == len(ref["server_logits"]) else float("inf")
        del server
    if "train" in run:
        batch = {k: v.to(dev) for k, v in ref["train_batch"].items()}
        state = step_fns.TrainState(params=params, opt=None, telemetry=None,
                                    step=None)
        placements = {k: p.placements
                      for k, p in params.named_parameters()}
        with TpCommLog() as comm:
            _peak_reset(cuda)
            (got, sec), launches = count_launches((), lambda: _timed_on(
                cuda, lambda: step_fns.sharded_grads(cfg, state, batch,
                                                     mesh)))
            peak = _peak(cuda)
        loss, _, grads = got
        del state, got, params
        params = None
        mine["train"] = dict(launches=launches, peak_bytes=peak, seconds=sec,
                             collectives=comm.summary())
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        for r in range(dist.get_world_size()):  # one whole model at a time
            if r == rank:
                plain = lm.init_params(cfg, torch.Generator(
                    device=dev).manual_seed(SEED), dev).requires_grad_(True)
                loss_p, _, want = step_fns._grads(cfg, plain, batch)
                del plain
                diff = {k: grads[k] - local_slice(w, placements[k], mesh)
                        for k, w in want.items()}
                mine["train"]["grad_err"] = max(
                    float(d.abs().max()) / max(float(want[k].abs().max()),
                                               1e-30)
                    for k, d in diff.items())
                mine["train"]["grad_norm_err"] = max(
                    float(torch.linalg.vector_norm(d)) / max(float(
                        torch.linalg.vector_norm(want[k])), 1e-30)
                    for k, d in diff.items())
                del diff
                mine["train"]["loss_rel"] = abs(float(loss) - float(
                    loss_p)) / abs(float(loss_p))
                del want, grads
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
            dist.barrier()
    if "steps" in run:
        caches = seeded_cp_caches(cfg, run["seq"], dev, mesh)
        step = step_fns.make_sharded_serve_step(cfg, mesh)
        toks = ref["cp_tokens"].to(dev)
        logits, times = [], []

        def decode():
            nonlocal caches
            for i in range(run["steps"]):
                t0 = time.perf_counter()
                lg, caches = step(params, caches, toks[:, i:i + 1])
                if cuda:
                    _sync()
                times.append(time.perf_counter() - t0)
                logits.append(lg[:, 0].float().cpu())

        with TpCommLog() as comm:
            _peak_reset(cuda)
            _, launches = count_launches((), decode)
            peak = _peak(cuda)
        mine["cp"] = dict(launches=launches, peak_bytes=peak, step_s=times,
                          collectives=comm.summary())
        if rank == 0:
            res["cp_logit_rel_err"] = max(
                logit_err(g, w, float(w.abs().max()))
                for g, w in zip(logits, ref["cp_logits"]))
        del caches
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return mine, res


def serve_rank_body(dev_type: str, parts: dict, ref_paths: dict) -> dict:
    """One rank of L13 (``spawn_ranks``, a gloo group), every part in turn
    on its mesh: the parameters drawn as ``lm.init_params`` draws them,
    each rank keeping its shards (``step_fns.init_sharded_params``);
    then, by part, the split prefill, ``DecodeServer(mesh=)`` on the
    parent's requests, the split train gradient (each rank then holds its
    shards to the one-device gradient of the same state and batch, one
    rank at a time) or the context-parallel decode from the seeded
    caches. Every comparison is against the parent's one-device results
    in ``ref_paths``; timings, peaks and collectives are rank 0's, flash
    launches every rank's. Returns rank 0's comparisons and every rank's
    numbers, by part."""
    dev = torch.device(dev_type)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        build.load_library()
    out = {}
    for part, run in parts.items():
        mine, res = _serve_part(run, torch.load(ref_paths[part]), dev, cuda)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        out[part] = dict(ranks=every, **res)
    return dict(parts=out, backend=dist.get_backend())


def serve_reference(run: dict, dev) -> dict:
    """The one-device results L13's part is held to, computed on ``dev``
    from the same seeds (the weights freed at the end)."""
    cfg = serve_cfg(run)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            dev)
    rng = np.random.default_rng(SEED + 14)
    ref = {}
    with torch.no_grad():
        if "prefill" in run:
            ref["prefill_tokens"] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (1, run["prefill"]), dtype=np.int32))
            lg, _ = lm.forward(cfg, params, {
                "tokens": ref["prefill_tokens"].to(dev)})
            ref["prefill_logits"] = lg.float().cpu()
            del lg
        if "serve" in run:
            ref["prompts"] = _serve_requests(cfg, run["serve"])
            logits, times = [], []
            server = _recording_server(DecodeServer(
                cfg, params, batch_slots=run["serve"]["batch_slots"],
                max_seq=run["serve"]["max_seq"], device=dev), logits, times)
            reqs = [Request(prompt=p, max_new=run["serve"]["max_new"])
                    for p in ref["prompts"]]
            server.run(reqs)
            ref.update(server_logits=logits,
                       server_tokens=[r.out for r in reqs],
                       server_step_s=times)
            del server
        if "steps" in run:
            caches = seeded_cp_caches(cfg, run["seq"], dev)
            ref["cp_tokens"] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (1, run["steps"]), dtype=np.int32))
            toks = ref["cp_tokens"].to(dev)
            ref["cp_logits"], ref["cp_step_s"] = [], []
            for i in range(run["steps"]):
                t0 = time.perf_counter()
                lg, caches = lm.serve_step(cfg, params, caches,
                                           toks[:, i:i + 1])
                ref["cp_logits"].append(lg[:, 0].float().cpu())
                ref["cp_step_s"].append(time.perf_counter() - t0)
            del caches
    if "train" in run:
        B, L = run["train"]
        toks = rng.integers(0, cfg.vocab_size, (B, L + 1), dtype=np.int32)
        ref["train_batch"] = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                              "labels": torch.from_numpy(toks[:, 1:].copy())}
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref


def cp_seq(cfg, tag) -> tuple:
    """L13c's sequence: long_500k's CP_SEQ_MAX slots if the estimator's
    rank-0 peak at the 2 x 1 mesh plus the one-device reference's peak fit
    CP_MEMORY_SHARE of the card (and the two ranks' peaks do), else the
    largest power of two that does; (seq, its estimates)."""
    budget = CP_MEMORY_SHARE * torch.cuda.get_device_properties(
        0).total_memory
    mesh = AbstractMesh(SERVE_TP_PARTS["c"]["mesh"], ("data", "model"))
    seq = CP_SEQ_MAX
    while True:
        cell = ShapeCell("l13c", seq, 1, "decode")
        rank0 = dryrun.estimate(cfg, cell, mesh)["memory"]["peak_bytes"]
        one = dryrun.estimate(cfg, cell, AbstractMesh(
            (1, 1), ("data", "model")))["memory"]["peak_bytes"]
        if rank0 + one <= budget and 2 * rank0 <= budget or seq <= 1024:
            break
        seq //= 2
    cut = "" if seq == CP_SEQ_MAX else "cut from "
    _log(f"L13c sequence {seq} ({cut}long_500k's {CP_SEQ_MAX}): the "
         f"estimator's rank-0 peak {rank0} bytes at "
         f"2 x 1 plus the one-device {one} against {int(budget)} bytes "
         f"({CP_MEMORY_SHARE:.0%} of the card) {tag}")
    return seq, dict(rank0=rank0, one_device=one, budget=budget)


def serve_tp_phase(dev, tag, parts: dict | None = None) -> dict:
    """L13 (see SERVE_TP_PARTS): every part's one-device reference on this
    card, then one gloo group of processes on this card running the parts
    on their meshes (``serve_rank_body``); rank 0's ms a step, share of it
    inside gloo's collectives, peak memory and collectives, every rank's
    flash launches. Raises on any disagreement."""
    out, bad = {}, []
    total = {n: 0 for n in WRAPPERS}
    if parts is None:
        parts = {k: dict(v, reduced=LM_REDUCED) for k, v in
                 SERVE_TP_PARTS.items()}
        parts["c"]["seq"], out["cp_estimates"] = cp_seq(
            serve_cfg(parts["c"]), tag)
    world = max(r["mesh"][0] * r["mesh"][1] for r in parts.values())
    tmp = tempfile.mkdtemp(prefix="phase-l13-")
    t0 = time.perf_counter()
    refs, ref_paths = {}, {}
    try:
        for part, run in parts.items():
            ref = serve_reference(run, dev)
            ref_paths[part] = os.path.join(tmp, f"reference-{part}.pt")
            torch.save(ref, ref_paths[part])
            refs[part] = {k: v for k, v in ref.items()
                          if k in ("server_step_s", "cp_step_s")}
            del ref
        t_ref = time.perf_counter() - t0
        res = spawn_ranks(serve_rank_body, world, device=dev,
                          backend="gloo", init_file=os.path.join(
                              tmp, "rendezvous"),
                          args=(dev.type, parts, ref_paths))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sec = time.perf_counter() - t0
    for part, run in parts.items():
        cfg = serve_cfg(run)
        got = res["parts"][part]
        r0 = got["ranks"][0]
        o = dict(arch=cfg.name, layers=cfg.n_layers, mesh=list(run["mesh"]),
                 backend=res["backend"])
        for kind in ("prefill", "decode", "train", "cp"):
            if kind not in r0:
                continue
            x = r0[kind]
            step_s = x.get("step_s") or [x["seconds"]]
            comm_s = sum(c["seconds"] for c in x["collectives"].values())
            o[kind] = dict(
                ms_a_step=1e3 * float(np.median(step_s)),
                seconds=sum(step_s), comm_share=comm_s / max(sum(step_s),
                                                             1e-9),
                peak_memory_bytes=x["peak_bytes"],
                collectives=x["collectives"],
                flash_launches=[r[kind]["launches"]["flash_attention_kernel"]
                                for r in got["ranks"]])
            for r in got["ranks"]:
                for n, c in r[kind]["launches"].items():
                    total[n] += c
        if "prefill" in o:
            calls = sorted({c for r in got["ranks"]
                            for c in r["prefill"]["flash_calls"]})
            o["prefill"].update(logit_rel_err=got["prefill_logit_rel_err"],
                                flash_call_shapes=calls)
            if not got["prefill_logit_rel_err"] <= LOGIT_TOL:
                bad.append(f"{part} prefill")
        if "decode" in o:
            o["decode"].update(logit_rel_err=got["decode_logit_rel_err"],
                               tokens_equal=got["decode_tokens_equal"],
                               one_device_ms_a_step=1e3 * float(np.median(
                                   refs[part]["server_step_s"])))
            if not (got["decode_tokens_equal"]
                    and got["decode_logit_rel_err"] <= LOGIT_TOL):
                bad.append(f"{part} decode")
        if "train" in o:
            norm_err = max(r["train"]["grad_norm_err"] for r in got["ranks"])
            o["train"].update(
                grad_rel_err=max(r["train"]["grad_err"]
                                 for r in got["ranks"]),
                grad_norm_rel_err=norm_err, loss_rel=r0["train"]["loss_rel"])
            if norm_err > SERVE_TP_GRAD_REL or \
                    r0["train"]["loss_rel"] > TRAIN_REL:
                bad.append(f"{part} train")
        if "cp" in o:
            o["cp"].update(logit_rel_err=got["cp_logit_rel_err"],
                           seq=run["seq"], pos0=cp_pos0(cfg, run["seq"]),
                           one_device_ms_a_step=1e3 * float(np.median(
                               refs[part]["cp_step_s"])))
            if not got["cp_logit_rel_err"] <= LOGIT_TOL:
                bad.append(f"{part} context parallel")
        out[part] = o
        name = "x".join(map(str, run["mesh"]))
        ranks = run["mesh"][0] * run["mesh"][1]
        for kind in ("prefill", "decode", "train", "cp"):
            if kind not in o:
                continue
            x = o[kind]
            err = {k: x[k] for k in ("logit_rel_err", "tokens_equal",
                                     "grad_rel_err", "grad_norm_rel_err",
                                     "loss_rel") if k in x}
            _log(f"L13{part} {cfg.name} ({cfg.n_layers} layers) {kind} on a "
                 f"{name} mesh ({ranks} ranks as processes on this card, "
                 f"gloo): {x['ms_a_step']:.1f} ms a step on rank 0, "
                 f"{x['comm_share']:.3f} of it inside gloo's collectives; "
                 f"rank 0's peak device memory {x['peak_memory_bytes']} "
                 f"bytes; rank 0's collectives {json.dumps(x['collectives'])}"
                 f"; flash launches by rank {x['flash_launches']}; "
                 f"{json.dumps(err)} (tolerance {LOGIT_TOL} of the largest "
                 f"logit; a loss {TRAIN_REL}, a rank's shard of a gradient "
                 f"leaf {SERVE_TP_GRAD_REL} of the leaf's norm) {tag}")
    out.update(seconds=sec, reference_seconds=t_ref, launches=total)
    _log(f"L13 spawned and run in {sec:.1f} s, the one-device references "
         f"{t_ref:.1f} s of it {tag}")
    if bad:
        raise AssertionError(f"L13: the sharded serving disagrees with the "
                             f"one-device path at {bad}")
    return out


def check_serve_tp_on_the_card(out) -> None:
    """L13's launch check, which only the card can make: every rank of the
    split prefill launched one flash kernel a global GQA layer, and the
    decodes none."""
    for part, run in SERVE_TP_PARTS.items():
        o = out[part]
        cfg = serve_cfg(dict(run, reduced=LM_REDUCED))
        if "prefill" in o and set(o["prefill"]["flash_launches"]) != {
                n_flash_layers(cfg)}:
            raise AssertionError(f"L13{part}: flash launches "
                                 f"{o['prefill']['flash_launches']}; want "
                                 f"{n_flash_layers(cfg)} a rank")
        for kind in ("decode", "cp"):
            if kind in o and any(o[kind]["flash_launches"]):
                raise AssertionError(f"L13{part}: a decode launched the "
                                     f"flash kernel")


def check_flash_serve_rows(dev, tag, calls) -> list:
    """L13's kernel rows: the flash forward at every distinct (q shape,
    k shape, q_offset) the split prefills launch (``calls``: L13's noted
    shapes), f32, against ``flash_attention_plain`` on the same card
    tensors (out at L1's tolerance, lse within TP_LSE_TOL); CUDA-event
    medians. Raises on any mismatch."""
    rows = []
    for qs, ks, off in calls:
        rng = np.random.default_rng(SEED + qs[1] + qs[2] + off)
        q, k, v = [torch.from_numpy(rng.standard_normal(
            s, dtype=np.float32)).to(dev) for s in (qs, ks, ks)]
        out, lse = flash_attention_kernel(q, k, v, True, lse=True,
                                          q_offset=off)
        want, lse_p = flash_attention_plain(q, k, v, True, lse=True,
                                            q_offset=off)
        _sync()
        err, n_bad, tol = flash_check(out, want)
        lse_err = float((lse - lse_p).abs().max())
        n_lse = int(((lse - lse_p).abs() >= TP_LSE_TOL).sum())
        del want, lse_p
        times = {name: float(np.median(event_times(fn, FLASH_BWD_REPS)))
                 for name, fn in (
                     ("ms", lambda: flash_attention_kernel(
                         q, k, v, True, q_offset=off)),
                     ("plain_ms", lambda: flash_attention_plain(
                         q, k, v, True, q_offset=off)))}
        label = f"L13 q {list(qs)} k {list(ks)} q_offset {off} float32"
        rows.append(dict(label=label, max_abs_err=err,
                         lse_max_abs_err=lse_err,
                         out_of_tolerance=n_bad + n_lse,
                         tolerance=f"{tol}; lse |d| < {TP_LSE_TOL}",
                         ms=times["ms"], plain_ms=times["plain_ms"]))
        _log(f"L13 flash rows {label}: out max_abs_err={err:.3g} ({tol}; "
             f"{n_bad} out), lse {lse_err:.3g} ({n_lse} out); "
             f"{times['ms']:.3f} ms, plain {times['plain_ms']:.3f} ms "
             f"(medians of {FLASH_BWD_REPS}) {tag}")
        del q, k, v, out, lse
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    bad = [r["label"] for r in rows if r["out_of_tolerance"]]
    if bad:
        raise AssertionError(f"L13: the flash kernel disagrees with its "
                             f"plain version at {bad}")
    return rows


def estimate_phase(l8: dict, l2: dict, tag, l12: dict | None = None,
                   l13: dict | None = None, parts: dict | None = None
                   ) -> dict:
    """E1: the cell estimator (``launch.dryrun.estimate``, on the host's
    meta tensors) at L8's cell (a 1 x 1 mesh), L2's prefill and L3's
    decode step (``l2`` holds L2's and L3's measurements), with ``l12``
    L12's first mesh (a model row of three) and with ``l13`` L13's
    prefill and decode cells on their meshes (``parts``: L13's, as
    SERVE_TP_PARTS), beside their measurements in this run: the peak
    memory against the estimate's (it must fall within
    ESTIMATE_MEMORY_MARGIN) and its split, the FLOPs against the run's
    own counts, L8's ms a step against the roofline's lower bound."""
    mesh = AbstractMesh((1, 1), ("data", "model"))
    cfg = configs.get(TRAIN_ARCH, reduced=LM_REDUCED)
    opt = AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=max(2, TRAIN_STEPS // 20),
                      decay_steps=TRAIN_STEPS)
    tr = dryrun.estimate(cfg, ShapeCell("l8", TRAIN_SEQ, TRAIN_BATCH,
                                        "train"), mesh, TRAIN_MICROBATCHES,
                         opt)
    qcfg = configs.get(LM_ARCH, reduced=LM_REDUCED)
    pf = dryrun.estimate(qcfg, ShapeCell("l2", PREFILL_LEN, 1, "prefill"),
                         mesh)
    B = SERVE["batch_slots"]
    dc = dryrun.estimate(qcfg, ShapeCell("l3", SERVE["max_seq"], B,
                                         "decode"), mesh)
    # a decode step's weight products: every weight but the input table
    # once a row (the attention over the cache comes on top)
    weight_flops = 2 * B * (qcfg.param_count() -
                            qcfg.vocab_size * qcfg.d_model)
    rl = tr["roofline"]
    bound_ms = 1e3 * max(rl["compute_s"], rl["memory_s"],
                         rl["collective_s"])
    tf = tr["flops_per_device"]
    useful = tf["matmul"] + 3 * tf["flash_forward"]
    out = dict(
        train=dict(
            measured_peak_bytes=l8["peak_memory_bytes"],
            estimate_peak_bytes=tr["memory"]["peak_bytes"],
            peak_rel_err=tr["memory"]["peak_bytes"] /
            l8["peak_memory_bytes"] - 1,
            split=tr["memory_split"], flops=tf,
            useful_flops=useful, l8_model_flops=l8["model_flops_per_step"],
            flops_rel_err=useful / l8["model_flops_per_step"] - 1,
            step_ms=l8["step_ms"], bound_ms=bound_ms,
            bound_share=bound_ms / l8["step_ms"], roofline=rl,
            estimate_s=tr["estimate_s"]),
        prefill=dict(
            measured_peak_bytes=l2["lm_peak_memory_bytes"],
            estimate_peak_bytes=pf["memory"]["peak_bytes"],
            peak_rel_err=pf["memory"]["peak_bytes"] /
            l2["lm_peak_memory_bytes"] - 1,
            split=pf["memory_split"], flops=pf["flops_per_device"],
            matmul_rel_err=pf["flops_per_device"]["matmul"] /
            l2["prefill_matmul_flops"] - 1,
            attention_rel_err=pf["flops_per_device"]["flash_forward"] /
            l2["prefill_attention_flops"] - 1,
            estimate_s=pf["estimate_s"]),
        decode=dict(
            measured_peak_bytes=l2["decode_peak_memory_bytes"],
            estimate_peak_bytes=dc["memory"]["peak_bytes"],
            peak_rel_err=dc["memory"]["peak_bytes"] /
            l2["decode_peak_memory_bytes"] - 1,
            split=dc["memory_split"], flops=dc["flops_per_device"],
            weight_flops=weight_flops,
            matmul_over_weight_flops=dc["flops_per_device"]["matmul"] /
            weight_flops,
            estimate_s=dc["estimate_s"]),
        margin=ESTIMATE_MEMORY_MARGIN)
    checked = [out["train"], out["prefill"], out["decode"]]
    if l12 is not None:
        shape = TP_MESHES[0]
        name = "x".join(map(str, shape))
        tp = dryrun.estimate(
            cfg, ShapeCell("l12", TP_SEQ, TP_BATCH, "train"),
            AbstractMesh(shape, ("data", "model")), 1,
            AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=2, decay_steps=10,
                        eps=1e-3))
        measured = l12[name]["peak_memory_bytes"]
        out["split_train"] = dict(
            mesh=list(shape), measured_peak_bytes=measured,
            estimate_peak_bytes=tp["memory"]["peak_bytes"],
            peak_rel_err=tp["memory"]["peak_bytes"] / measured - 1,
            split=tp["memory_split"], flops=tp["flops_per_device"],
            useful_flops_ratio=tp["roofline"]["useful_flops_ratio"],
            collective_bytes=tp["collective_bytes_per_device"],
            estimate_s=tp["estimate_s"])
        checked.append(out["split_train"])
        x = out["split_train"]
        _log(f"E1 estimator at L12's {name} cell ({cfg.name}, {TP_BATCH} x "
             f"{TP_SEQ}, rank 0): peak {x['estimate_peak_bytes']} bytes "
             f"against the measured {measured} ({x['peak_rel_err']:+.4%}; "
             f"margin {ESTIMATE_MEMORY_MARGIN:.0%}), split "
             f"{json.dumps(x['split'])}; useful FLOP ratio "
             f"{x['useful_flops_ratio']:.4f}; collective bytes a step "
             f"{json.dumps(x['collective_bytes'])} against rank 0's "
             f"measured {json.dumps(l12[name]['collectives'])} (two "
             f"steps) {tag}")
    if l13 is not None:
        out["serving"] = serving_estimates(l13, parts, tag)
        checked += list(out["serving"].values())
    t, p, d = out["train"], out["prefill"], out["decode"]
    _log(f"E1 estimator at L8's cell ({cfg.name}, {TRAIN_BATCH} x "
         f"{TRAIN_SEQ}, {TRAIN_MICROBATCHES} microbatches, 1 x 1): peak "
         f"{t['estimate_peak_bytes']} bytes against the measured "
         f"{t['measured_peak_bytes']} ({t['peak_rel_err']:+.4%}; margin "
         f"{ESTIMATE_MEMORY_MARGIN:.0%}), split {json.dumps(t['split'])}; "
         f"FLOPs a step {tf['matmul']} matmul + 3 x {tf['flash_forward']} "
         f"flash forward = {useful} against L8's {t['l8_model_flops']} "
         f"({t['flops_rel_err']:+.4%}); roofline bound {bound_ms:.1f} ms "
         f"({rl['dominant']}) against the measured {t['step_ms']:.1f} ms a "
         f"step ({t['bound_share']:.3f}); estimated in "
         f"{t['estimate_s']:.1f} s {tag}")
    _log(f"E1 estimator at L2's prefill ({qcfg.name}, {PREFILL_LEN} "
         f"tokens): peak {p['estimate_peak_bytes']} bytes against the "
         f"measured {p['measured_peak_bytes']} ({p['peak_rel_err']:+.4%}), "
         f"split {json.dumps(p['split'])}; FLOPs matmul "
         f"{p['flops']['matmul']} ({p['matmul_rel_err']:+.4%} of L2's), "
         f"flash {p['flops']['flash_forward']} "
         f"({p['attention_rel_err']:+.4%}) {tag}")
    _log(f"E1 estimator at L3's decode step ({qcfg.name}, {B} slots x "
         f"{SERVE['max_seq']} positions): peak {d['estimate_peak_bytes']} "
         f"bytes against the measured {d['measured_peak_bytes']} "
         f"({d['peak_rel_err']:+.4%}), split {json.dumps(d['split'])}; "
         f"FLOPs matmul {d['flops']['matmul']}, "
         f"{d['matmul_over_weight_flops']:.4f} of the weights' "
         f"{weight_flops} {tag}")
    if not all(abs(x["peak_rel_err"]) <= ESTIMATE_MEMORY_MARGIN
               for x in checked):
        raise AssertionError(f"E1: a memory estimate falls outside "
                             f"{ESTIMATE_MEMORY_MARGIN:.0%} of the "
                             f"measured peak")
    return out


def serving_estimates(l13: dict, parts: dict | None, tag) -> dict:
    """E1 at L13's cells: each part's prefill (batch 1) and decode cell
    (the server's slots and cache, or L13c's one sequence) on its mesh,
    rank 0's estimated peak against rank 0's measured one; the gathered
    copies, collective bytes and useful FLOP ratio beside."""
    parts = parts or {k: dict(v, reduced=LM_REDUCED)
                      for k, v in SERVE_TP_PARTS.items()}
    out = {}
    for part, run in parts.items():
        cfg = serve_cfg(run)
        mesh = AbstractMesh(run["mesh"], ("data", "model"))
        cells = []
        if "prefill" in run:
            cells.append(("prefill", ShapeCell(f"l13{part}-prefill",
                                               run["prefill"], 1,
                                               "prefill")))
        if "serve" in run:
            cells.append(("decode", ShapeCell(
                f"l13{part}-decode", run["serve"]["max_seq"],
                run["serve"]["batch_slots"], "decode")))
        if "steps" in run:
            cells.append(("cp", ShapeCell(f"l13{part}-cp",
                                          l13[part]["cp"]["seq"], 1,
                                          "decode")))
        for kind, cell in cells:
            est = dryrun.estimate(cfg, cell, mesh)
            measured = l13[part][kind]["peak_memory_bytes"]
            x = dict(mesh=list(run["mesh"]), measured_peak_bytes=measured,
                     estimate_peak_bytes=est["memory"]["peak_bytes"],
                     peak_rel_err=est["memory"]["peak_bytes"] /
                     max(measured, 1) - 1, split=est["memory_split"],
                     collective_bytes=est["collective_bytes_per_device"],
                     useful_flops_ratio=est["roofline"][
                         "useful_flops_ratio"],
                     estimate_s=est["estimate_s"])
            out[f"{part}_{kind}"] = x
            _log(f"E1 estimator at L13{part}'s {kind} cell ({cfg.name}, "
                 f"{cell.global_batch} x {cell.seq_len}, "
                 f"{'x'.join(map(str, run['mesh']))}, rank 0): peak "
                 f"{x['estimate_peak_bytes']} bytes against the measured "
                 f"{measured} ({x['peak_rel_err']:+.4%}; margin "
                 f"{ESTIMATE_MEMORY_MARGIN:.0%}), split "
                 f"{json.dumps(x['split'])}; collective bytes "
                 f"{json.dumps(x['collective_bytes'])}; useful FLOP ratio "
                 f"{x['useful_flops_ratio']:.4f} {tag}")
    return out


# --------------------------------------------------------------------------
# phase C: the mesh-resident collective path
# --------------------------------------------------------------------------

class CollectiveLog:
    """While entered, counts every ``torch.distributed`` ``all_reduce`` and
    ``all_gather`` call and brackets it with CUDA events; ``summary()``
    gives the counts and the summed event milliseconds of each."""

    NAMES = ("all_reduce", "all_gather")

    def __enter__(self):
        self.events = {n: [] for n in self.NAMES}
        self.saved = {n: getattr(dist, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(dist, n, self._wrap(n, fn))
        return self

    def _wrap(self, name, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events[name].append((start, end))
            return out
        return call

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(dist, n, fn)

    def summary(self) -> dict:
        _sync()
        return {n: dict(calls=len(ev), ms=sum(s.elapsed_time(e)
                                               for s, e in ev))
                for n, ev in self.events.items()}


def collective_queries(spec, placed, state, qi, answers, tag) -> dict:
    """C1: phase 5's batches (every kind x edge label x horizon, and each
    kind's horizon sweep) on the collective path of the placed handle,
    each equal to phase 5's answer; each batch's collectives counted and
    timed. Returns the calls and seconds by batch."""
    out = {}
    for kind in KINDS:
        for with_le in (False, True):
            for last in list(HORIZONS) + [list(HORIZONS)]:
                q = query_batch(qi, kind, with_le, last)
                if isinstance(last, list):  # plane build: set-up
                    skt.query_planes_multi(spec, placed, last,
                                           collective=True)
                    want = torch.stack([answers[(kind, with_le, h)]
                                        for h in HORIZONS])
                else:
                    skt.query_planes(spec, placed, last, collective=True)
                    want = answers[(kind, with_le, last)]
                with CollectiveLog() as log:
                    got, sec = _timed(lambda: skt.query(
                        spec, placed, q, path="collective"))
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"phase C1: collective {kind} "
                                         f"le={with_le} last={last} differs "
                                         f"from phase 5")
                out[(kind, with_le, str(last))] = dict(
                    s=sec, **log.summary())
    return out


def collective_topk(spec, placed, got, tag) -> dict:
    """C2: phase 6b's top-k calls on the collective path, each equal to
    phase 6b's; seconds and collectives by call."""
    out = {}
    for label, name, k, kw in _analytics_calls():
        with CollectiveLog() as log:
            res, sec = _timed(lambda: getattr(skt, name)(
                spec, placed, k, path="collective", **kw))
        if not all(torch.equal(a.cpu(), b) for a, b in zip(res, got[label])):
            raise AssertionError(f"phase C2: collective {label} differs "
                                 f"from phase 6b")
        out[label] = dict(s=sec, **log.summary())
    return out


def collective_ingest(spec, stream, flushes, qi, ctx, dev, tag):
    """C3: phase 4's stream in phase 4's flushes into a fresh placed
    handle (each flush synchronised and timed); after each of the last
    COLLECTIVE_TAIL flushes a collective edge batch, whose planes (a fold
    of the flush's delta, or a build where the flush moved the ring) must
    equal a cold build. Returns (the handle, seconds of ingest, folds,
    builds)."""
    placed = skt.place(spec, skt.create(spec, device=dev), ctx)
    q = query_batch(qi, "edge", False, None)
    counts = skt.PLANES_BUILD_COUNTS
    tail = len(flushes) - COLLECTIVE_TAIL
    ingest_s, folds, builds = 0.0, 0, 0
    for i, (a, z) in enumerate(flushes):
        placed, sec = _timed(lambda: skt.ingest(
            spec, placed, stream.slice(a, z), path="cuda"))
        ingest_s += sec
        if i < tail - 1:
            continue
        before = dict(counts)
        skt.query(spec, placed, q, path="collective")  # warms, then folds
        if i < tail:
            continue
        folds += counts["delta"] - before["delta"]
        builds += counts["build"] - before["build"]
        inc = skt.query_planes(spec, placed, collective=True)
        skt.clear_plane_cache(placed)
        cold = skt.query_planes(spec, placed, collective=True)
        bad = [f for f in ("key", "cw", "pw", "pool_key", "pool_cw",
                           "pool_pw")
               if not torch.equal(getattr(inc, f), getattr(cold, f))]
        if bad:
            raise AssertionError(f"phase C3 flush {i}: the collective "
                                 f"planes differ from a cold build in {bad}")
        del inc, cold
    if skt.mesh_context(placed) is not ctx:
        raise AssertionError("phase C3: ingest dropped the MeshContext")
    return placed, ingest_s, folds, builds


def collective_server(spec, stream, flushes, qi, ctx, dev):
    """C4: ``SketchServer(mesh=ctx, query_path="collective")`` fed phase 4's
    stream, then phase V's mixed requests in one flush. Returns (the
    server, its request handles, ingest seconds, flush seconds, the
    flush's collectives)."""
    server = SketchServer(spec, mesh=ctx, query_path="collective",
                          horizons=list(SERVER_HORIZONS), device=dev)
    _sync()
    t0 = time.perf_counter()
    for a, z in flushes:
        server.ingest(stream.slice(a, z))
    server.state  # drains the pipeline
    _sync()
    ingest_s = time.perf_counter() - t0
    with CollectiveLog() as log:
        handles, sec, _ = serve_requests(
            server, server_requests(qi, SERVER_REQUESTS))
    return server, handles, ingest_s, sec, log.summary()


def start_cli_mesh(dev):
    """C5: ``serve --mode sketch --shards 4 --mesh 1 --collective`` and the
    same at ``--mesh 2`` as processes (started now, read by
    ``check_cli_mesh``)."""
    root = Path(__file__).resolve().parent
    extra = list(CLI_ARGS) + (["--device", "cpu"] if dev.type == "cpu"
                              else [])
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    runs = [["--shards", "4", "--mesh", str(n), "--collective"]
            for n in (1, 2)]
    return [(a + extra, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "sketch", *a, *extra], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for a in runs]


def check_cli_mesh(runs, dev, tag) -> list:
    """C5: ``--mesh 1`` exits 0; ``--mesh 2`` exits 0 on the CPU (two gloo
    ranks) and, on a box with fewer cards, non-zero with the reference's
    message."""
    out = []
    for argv, p in runs:
        try:
            text = p.communicate(timeout=600)[0]
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        n = int(argv[argv.index("--mesh") + 1])
        refuse = dev.type == "cuda" and n > torch.cuda.device_count()
        msg = f"--mesh {n}: only {torch.cuda.device_count()} devices " \
            "available"
        keep = [x for x in text.splitlines()
                if x.startswith(("ingested", "answered", "--mesh"))]
        _log(f"phase C5 serve --mode sketch {' '.join(argv)}: exit "
             f"{p.returncode}: {' | '.join(keep)} {tag}")
        ok = (p.returncode != 0 and msg in text) if refuse else \
            p.returncode == 0
        if not ok:
            raise AssertionError(f"phase C5: {argv} exited {p.returncode}:"
                                 f"\n{text[-2000:]}")
        out.append(dict(argv=argv, exit=p.returncode))
    return out


def routing_counts(step: int, dev) -> np.ndarray:
    """One MoE routing step of C6, seeded by the step: TELEMETRY_TOKENS
    tokens, each in one of the 256 buckets, routed to its top
    TELEMETRY_TOP_K of the experts by Gumbel-perturbed Zipf logits whose
    hot experts rotate every TELEMETRY_CHECK steps. Returns the
    ``[n_buckets, n_experts]`` count matrix."""
    E, B = TELEMETRY["n_experts"], TELEMETRY["n_buckets"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1000 + step)
    rank = (torch.arange(E, device=dev) +
            17 * (step // TELEMETRY_CHECK)) % E
    logits = -1.1 * torch.log1p(rank.double())
    u = torch.rand((TELEMETRY_TOKENS, E), generator=gen, device=dev,
                   dtype=torch.float64)
    top = torch.topk(logits - torch.log(-torch.log(u)), TELEMETRY_TOP_K,
                     dim=1).indices
    bucket = torch.randint(0, B, (TELEMETRY_TOKENS,), generator=gen,
                           device=dev)
    cell = (bucket[:, None] * E + top).reshape(-1)
    return torch.bincount(cell, minlength=B * E).view(B, E).cpu().numpy()


def collective_telemetry(ctx, dev):
    """C6, the card's half: ``RouterTelemetry(mesh=ctx)`` fed
    TELEMETRY_STEPS routing steps with a ``CapacityController.update``
    after each; every TELEMETRY_CHECK steps ``load_vector()`` and
    ``load_vector(last=2)`` and a CPU copy of the state. Returns the
    telemetry, the counts, the checkpoints and the seconds of each
    part."""
    tele = RouterTelemetry(**TELEMETRY, mesh=ctx, device=dev)
    if tele.query_path != "collective":
        raise AssertionError("phase C6: a dividing mesh must read through "
                             "the collective path")
    ctrl = CapacityController(tele)
    cf, counts, checks = 1.25, [], []
    secs = {"ingest": [], "update": [], "load_vector": []}
    for step in range(TELEMETRY_STEPS):
        c = routing_counts(step, dev)
        counts.append(c)
        _, s = _timed(lambda: tele.ingest(c, step))
        secs["ingest"].append(s)
        cf, s = _timed(lambda: ctrl.update(cf))
        secs["update"].append(s)
        if (step + 1) % TELEMETRY_CHECK == 0:
            loads, s = _timed(lambda: tele.load_vector())
            secs["load_vector"].append(s)
            checks.append(dict(step=step, cf=cf, load=loads,
                               load2=tele.load_vector(last=2),
                               state=_to_cpu(skt.fleet_shards(
                                   tele.spec, tele.state))))
    return tele, counts, checks, secs


def check_telemetry(tele, counts, checks, dev, tag) -> dict:
    """C6 comparisons: at every checkpoint the collective loads equal the
    CPU copy's on the scan path; a host-resident telemetry on the card fed
    the same counts ends with the placed one's state leaf for leaf, and
    its controller takes the same capacity factors."""
    spec = tele.spec
    mism = 0
    for ck in checks:
        cpu = skt.ShardedState(ck["state"])
        for last, got in ((None, ck["load"]), (2, ck["load2"])):
            q = skt.QueryBatch.vertices(
                tele.n_buckets + np.arange(tele.n_experts, dtype=np.int32),
                3, direction="in", last=last)
            mism += int((skt.query(spec, cpu, q, path="scan").numpy()
                         != got).sum())
    twin = RouterTelemetry(**TELEMETRY, device=dev)
    ctrl, cf, cfs = CapacityController(twin), 1.25, {}
    for step, c in enumerate(counts):
        twin.ingest(c, step)
        cf = ctrl.update(cf)
        cfs[step] = cf
    mism += sum(int(cfs[ck["step"]] != ck["cf"]) for ck in checks)
    bad = [n for n, x, y in zip(LEAVES, skt.fleet_shards(
        spec, tele.state).leaves(), twin.state.live().leaves())
        if not torch.equal(x, y)]
    _log(f"phase C6 RouterTelemetry({TELEMETRY}) over {len(counts)} steps "
         f"of {TELEMETRY_TOKENS} tokens x top-{TELEMETRY_TOP_K}: "
         f"collective loads at {len(checks)} checkpoints (last None and 2) "
         f"vs the CPU copy on the scan path and the controller vs a "
         f"host-resident twin: mismatches={mism}; final state vs the "
         f"twin's, leaf for leaf: {'equal' if not bad else bad}; last "
         f"capacity factor {checks[-1]['cf']:.4f}, imbalance(last=2) "
         f"{tele.imbalance(last=2):.4f} {tag}")
    if mism or bad:
        raise AssertionError("phase C6: the placed telemetry differs")
    return dict(mismatches=mism, checkpoints=len(checks))


def collective_phase(spec, stream, flushes, state, qi, answers, got,
                     edges_per_s, dev, tag):
    """Phase C (see the module docstring): a one-rank group on this card
    (NCCL; gloo on the CPU), the collective path's runs counted from 0
    (C1-C4, C6's card half), then their comparisons and C5's processes.
    Returns (launches, the numbers)."""
    cli = start_cli_mesh(dev)
    tmp = tempfile.mkdtemp(prefix="phase-c-")
    init_group(0, 1, os.path.join(tmp, "rendezvous"), backend_for(dev))
    try:
        ctx = skt.MeshContext()
        torch.cuda.reset_peak_memory_stats()
        names = COLLECTIVE_PATH if dev.type == "cuda" else ()

        def path():
            placed = skt.place(spec, state, ctx)
            out = dict(queries=collective_queries(spec, placed, state, qi,
                                                  answers, tag),
                       topk=collective_topk(spec, placed, got, tag))
            del placed
            h, ingest_s, folds, builds = collective_ingest(
                spec, stream, flushes, qi, ctx, dev, tag)
            out.update(ingest_s=ingest_s, folds=folds, builds=builds,
                       n_edges=len(stream))
            bad = [n for n, x, y in zip(LEAVES, h.live().leaves(),
                                        state.live().leaves())
                   if not torch.equal(x, y)]
            if bad:
                raise AssertionError(f"phase C3: placed ingest differs from "
                                     f"phase 4 in {bad}")
            del h
            torch.cuda.empty_cache()
            out["server"] = collective_server(spec, stream, flushes, qi,
                                              ctx, dev)
            out["telemetry"] = collective_telemetry(ctx, dev)
            return out

        res, launches = count_launches(names, path)
        peak = torch.cuda.max_memory_allocated()
        c_out = report_collective(spec, state, qi, res, edges_per_s, dev,
                                  tag)
        c_out.update(peak_memory_bytes=peak, launches=launches,
                     cli=check_cli_mesh(cli, dev, tag))
        _log(f"phase C launches: {launches}; peak device memory {peak} "
             f"bytes {tag}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        for _, p in cli:
            if p.poll() is None:
                p.kill()
                p.wait()
    return launches, c_out


def _by_kind(rows: dict) -> dict:
    """µs a query and the all_reduce and all_gather calls and CUDA-event
    ms a batch of C1's rows, by query kind (a sweep apart)."""
    out = {}
    for (kind, _, last), r in rows.items():
        k = kind + (" sweep" if last.startswith("[") else "")
        out.setdefault(k, []).append(r)
    return {k: dict(us_per_query=1e6 * np.mean([r["s"] for r in rs]) /
                    N_QUERIES,
                    all_reduce_per_batch=np.mean(
                        [r["all_reduce"]["calls"] for r in rs]),
                    all_reduce_ms_per_batch=np.mean(
                        [r["all_reduce"]["ms"] for r in rs]),
                    all_gather_per_batch=np.mean(
                        [r["all_gather"]["calls"] for r in rs]),
                    all_gather_ms_per_batch=np.mean(
                        [r["all_gather"]["ms"] for r in rs]))
            for k, rs in out.items()}


def report_collective(spec, state, qi, res, edges_per_s, dev, tag) -> dict:
    """C1-C4 and C6's comparisons against phase 4's state and their log
    lines; the "collective" object of the JSON line."""
    kinds = _by_kind(res["queries"])
    cuda_us = {}
    for kind in KINDS:  # the same batches on the cuda path, for scale
        secs = []
        for with_le in (False, True):
            for last in HORIZONS:
                skt.query_planes(spec, state, last)
                _, s = _timed(lambda: skt.query(
                    spec, state, query_batch(qi, kind, with_le, last),
                    path="cuda"))
                secs.append(s)
        cuda_us[kind] = 1e6 * np.mean(secs) / N_QUERIES
        kinds[kind]["cuda_us_per_query"] = cuda_us[kind]
    skt.clear_plane_cache(state)
    _log(f"phase C1 phase 5's {len(res['queries'])} batches of {N_QUERIES} "
         f"on the collective path: equal to phase 5's answers; by kind "
         f"(us a query collective vs cuda, all_reduce calls and ms a "
         f"batch): {json.dumps(kinds)} {tag}")
    topk = res["topk"]
    _log(f"phase C2 phase 6b's {len(topk)} top-k calls on the collective "
         f"path: equal; ms and collectives by call "
         f"{json.dumps({k: dict(ms=1e3 * v['s'], all_gather=v['all_gather']) for k, v in topk.items()})} "
         f"{tag}")
    n = res["n_edges"]
    placed_rate = n / res["ingest_s"]
    _log(f"phase C3 placed ingest of phase 4's {n} edges: "
         f"{placed_rate:.0f} edges/s (phase 4: {edges_per_s:.0f}); final "
         f"state equal to phase 4's leaf for leaf, MeshContext kept; the "
         f"last {COLLECTIVE_TAIL} flushes: {res['folds']} folded, "
         f"{res['builds']} built, each equal to a cold build {tag}")
    server, handles, s_ingest, s_flush, s_log = res["server"]
    groups = _groups(server, handles)
    mism = 0
    for (kind, with_le, last, direction), rs in groups.items():
        q = server._group_batch(kind, rs, with_le, last, direction)
        want = skt.query(spec, state, q, path="cuda").cpu()
        mism += int((want != torch.tensor([r.answer for r in rs],
                                          dtype=torch.int32)).sum())
    skt.clear_plane_cache(state)
    _log(f"phase C4 SketchServer(mesh, query_path='collective', horizons="
         f"{list(SERVER_HORIZONS)}): ingest {n} edges in {s_ingest:.3f} s "
         f"= {n / s_ingest:.0f} edges/s; {len(handles)} mixed requests in "
         f"{len(groups)} groups, one flush: {s_flush:.4f} s = "
         f"{1e6 * s_flush / len(handles):.3f} us a request, collectives "
         f"{json.dumps(s_log)}; answers vs skt.query(path='cuda') on phase "
         f"4's state: mismatches={mism} {tag}")
    if mism:
        raise AssertionError("phase C4: a served answer differs")
    served = dict(ingest_edges_per_s=n / s_ingest, requests=len(handles),
                  groups=len(groups),
                  us_per_request=1e6 * s_flush / len(handles),
                  collectives=s_log, mismatches=mism)
    del server, handles, groups, res["server"]
    torch.cuda.empty_cache()
    tele, counts, checks, secs = res["telemetry"]
    t_out = check_telemetry(tele, counts, checks, dev, tag)
    t_out.update({f"{k}_us": 1e6 * float(np.mean(v))
                  for k, v in secs.items()})
    _log(f"phase C6 us a step: ingest {t_out['ingest_us']:.1f}, controller "
         f"update {t_out['update_us']:.1f}, load_vector "
         f"{t_out['load_vector_us']:.1f} {tag}")
    return dict(by_kind=kinds,
                topk={k: dict(ms=1e3 * v["s"], all_gather=v["all_gather"])
                      for k, v in topk.items()},
                ingest_edges_per_s=placed_rate,
                phase4_edges_per_s=edges_per_s, folds=res["folds"],
                builds=res["builds"],
                server=served, telemetry=t_out, card=card_line() if dev.type == "cuda"
                else "cpu")


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


# --------------------------------------------------------------------------
# phase S: the streaming loop
# --------------------------------------------------------------------------

def stream_batches(cfg, stream):
    """Phase S's batches: cut at every subwindow boundary and every
    STREAM_FLUSH edges within a subwindow. Returns (batches, the indices
    of the batches that enter a new subwindow: their flushes move the
    ring, so the planes after them must be built)."""
    bounds = _subwindow_bounds(stream.time, cfg.subwindow_size)
    cuts = _chunked([0] + bounds + [len(stream)], STREAM_FLUSH)
    starts = set([0] + bounds)
    return ([stream.slice(a, z) for a, z in zip(cuts[:-1], cuts[1:])],
            [i for i, a in enumerate(cuts[:-1]) if a in starts])


def _plane_leaves(p) -> list:
    return [p.key, p.cw, p.pw, p.pool_key, p.pool_cw, p.pool_pw]


def _leaf_bytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _link_bytes(st) -> int:
    """The bytes of the newest link of a handle's pending delta chain (a
    function of its own, so that no reference to the chain outlives the
    call)."""
    attr = importlib.import_module("repro_torch.sketch.query")._PENDING_ATTR
    d = getattr(st, attr)[1][-1]
    return _leaf_bytes([d.ok, d.slot, d.d_c, d.d_p, d.d_pool_c, d.d_pool_p])


def check_round(spec, st, qs, answers) -> tuple:
    """Phase S2 at one round: the handle's planes (folded or built) leaf
    for leaf against a cold build on the same tensors (a fresh handle over
    them), and the round's answers against the cold planes' answers.
    Returns (mismatches, the cold builds' ms)."""
    cold = skt.ShardedState(st.live())
    (c1, (cm, _)), sec = _timed(lambda: (
        skt.query_planes(spec, cold, None),
        skt.query_planes_multi(spec, cold, list(SWEEP))))
    f1 = skt.query_planes(spec, st, None)
    fm, _ = skt.query_planes_multi(spec, st, list(SWEEP))
    pairs = list(zip(_plane_leaves(f1), _plane_leaves(c1))) + \
        list(zip(_plane_leaves(fm), _plane_leaves(cm)))
    pairs += [(skt.query(spec, cold, q, path="cuda"), a)
              for q, a in zip(qs, answers)]
    bad, _ = diff(pairs)
    return bad, 1e3 * sec


def stream_loop(spec, batches, qs, dev, tag) -> dict:
    """Phase S1-S2: ``AsyncIngestor`` (kernel route) fed the batches; after
    each dispatched batch (``ing.dispatched``, the pipeline kept) and after
    the final flush, the planes of ``last=None`` and of the sweep are
    fetched (a fold of the flush's delta, or a build) and the two query
    batches answered on them; every CHECK_EVERY-th round and the last
    are held to cold builds. Returns the final handle and the rounds."""
    rounds, link_bytes, checks = [], 0, []
    peaks = dict(ingest=0, planes=0, queries=0, check=0)

    def peak(stage):  # the stage's peak device memory, then a fresh count
        peaks[stage] = max(peaks[stage], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    ing = skt.AsyncIngestor(spec, path="cuda", device=dev)
    t_loop = time.perf_counter()
    for i in range(len(batches) + 1):
        if i < len(batches):
            _, sec_in = _timed(lambda: ing.submit(batches[i]))
            peak("ingest")
            if i == 0:
                continue  # staged: nothing dispatched yet
            st = ing.dispatched
        else:
            st, sec_in = _timed(ing.flush)
            peak("ingest")
        r = len(rounds)
        before = dict(skt.PLANES_BUILD_COUNTS)
        _, sec_pl = _timed(lambda: (
            skt.query_planes(spec, st, None),
            skt.query_planes_multi(spec, st, list(SWEEP))))
        peak("planes")
        moved = {k: skt.PLANES_BUILD_COUNTS[k] - v
                 for k, v in before.items()}
        answers, sec_q = _timed(lambda: [
            skt.query(spec, st, q, path="cuda") for q in qs])
        peak("queries")
        kind = "delta" if moved["delta"] == 2 and not moved["build"] \
            else "build" if moved["build"] == 2 and not moved["delta"] \
            else f"mixed {moved}"
        if kind == "delta" and not link_bytes:
            link_bytes = _link_bytes(st)
        rounds.append(dict(kind=kind, ingest_ms=1e3 * sec_in,
                           planes_ms=1e3 * sec_pl,
                           query_ms=1e3 * sec_q))
        if r % CHECK_EVERY == 0 or i == len(batches):
            bad, cold_ms = check_round(spec, st, qs, answers)
            peak("check")
            checks.append(dict(round=r, kind=kind, mismatches=bad,
                               cold_build_ms=cold_ms))
            _log(f"phase S2 round {r} ({kind}): planes and answers vs "
                 f"a cold build: mismatches={bad}; cold build of "
                 f"last=None and the sweep {cold_ms:.2f} ms, this "
                 f"round's planes {1e3 * sec_pl:.2f} ms {tag}")
    loop_s = time.perf_counter() - t_loop
    return dict(final=st, answers=answers, rounds=rounds, checks=checks,
                link_bytes=link_bytes, loop_s=loop_s, peaks=peaks)


def ingest_pass(spec, batches, dev, pipelined: bool, profiled: bool):
    """One pure-ingest pass of the batches into a fresh handle (made
    before the timed region): ``AsyncIngestor`` (submit each, flush at the
    end) or synchronous ``ingest``. Returns (the handle, seconds, the
    card's busy share under the profiler, or None)."""
    from torch.profiler import ProfilerActivity, profile

    state = skt.create(spec, device=dev)

    def run():
        if pipelined:
            ing = skt.AsyncIngestor(spec, state, path="cuda")
            for b in batches:
                ing.submit(b)
            return ing.flush()
        st = state
        for b in batches:
            st = skt.ingest(spec, st, b, path="cuda")
        return st

    if not profiled:
        return (*_timed(run), None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, sec = _timed(run)
    return out, sec, device_us(prof.key_averages()) / 1e6 / sec


def _leaves_differ(a, b) -> list:
    """Leaf names where two handles differ (``b``'s leaves compared on
    ``a``'s device)."""
    xs, ys = a.live().leaves(), b.live().leaves()
    names = LGS_LEAVES if len(xs) == len(LGS_LEAVES) else LEAVES
    return [n for n, x, y in zip(names, xs, ys)
            if x.shape != y.shape or not torch.equal(x, y.to(x.device))]


def stream_phase(cfg, spec, dev, tag):
    """Phase S: the streaming loop on a fresh handle of the deployment
    (S1-S2, launches counted from 0 over it), the exact truth (S3: the
    final state against synchronous ingest of the same batches, and the
    final answers one-sided against ``GroundTruth``), and pure-ingest
    passes of ``AsyncIngestor`` against ``ingest`` (S4: timed in the
    order sync, async, async, sync, then one profiled pass of each).
    Returns (the launches, the numbers)."""
    stream = generate(dataclasses.replace(COMFS, n_edges=STREAM_EDGES),
                      seed=SEED, weighted=True)
    batches, enters = stream_batches(cfg, stream)
    qi = query_inputs(cfg, stream)
    qs = (query_batch(qi, "edge", False, None),
          query_batch(qi, "edge", False, list(SWEEP)))
    n = len(stream)
    want = ["build" if i in enters else "delta" for i in range(len(batches))]
    _log(f"phase S: {n} edges in {len(batches)} batches of <= "
         f"{STREAM_FLUSH}, {len(enters)} entering a new subwindow: expect "
         f"{want.count('build')} rounds built and {want.count('delta')} "
         f"folded (2 planes a round: last=None and the sweep {SWEEP})")
    at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    names = STREAM_PATH if dev.type == "cuda" else ()
    loop, launches = count_launches(names, lambda: stream_loop(
        spec, batches, qs, dev, tag))
    peak = max(loop["peaks"].values())
    got = [r["kind"] for r in loop["rounds"]]
    bad = sum(c["mismatches"] for c in loop["checks"])
    med = lambda xs: float(np.median(xs)) if xs else float("nan")  # noqa
    by = {k: [r for r in loop["rounds"] if r["kind"] == k]
          for k in ("delta", "build")}
    out = dict(
        edges=n, batches=len(batches), rounds_delta=len(by["delta"]),
        rounds_build=len(by["build"]), check_mismatches=bad,
        checked_rounds=[c["round"] for c in loop["checks"]],
        fold_ms=med([r["planes_ms"] for r in by["delta"]]),
        build_in_loop_ms=med([r["planes_ms"] for r in by["build"]]),
        cold_build_ms=med([c["cold_build_ms"] for c in loop["checks"]]),
        query_ms=med([r["query_ms"] for r in loop["rounds"]]),
        ingest_ms=med([r["ingest_ms"] for r in loop["rounds"]]),
        link_bytes=loop["link_bytes"], peak_memory_bytes=peak,
        peak_memory_by_stage=loop["peaks"], memory_at_start=at_start,
        loop_edges_per_s=n / loop["loop_s"], launches=launches)
    _log(f"phase S1 loop: {n} edges, {len(batches)} rounds in "
         f"{loop['loop_s']:.3f} s ({out['loop_edges_per_s']:.0f} edges/s "
         f"with the queries); rounds folded {out['rounds_delta']}, built "
         f"{out['rounds_build']}; planes per round (last=None and the "
         f"sweep): fold {out['fold_ms']:.3f} ms, build in the loop "
         f"{out['build_in_loop_ms']:.3f} ms, cold build at the checks "
         f"{out['cold_build_ms']:.3f} ms (medians); the two query batches "
         f"{out['query_ms']:.3f} ms, a submit {out['ingest_ms']:.3f} ms; "
         f"one delta link {out['link_bytes']} bytes; peak device memory "
         f"{peak} bytes (by stage {loop['peaks']}; {at_start} bytes "
         f"allocated at the start); launches {launches} {tag}")
    if got != want or not out["rounds_delta"]:
        raise AssertionError(f"phase S rounds {got} != predicted {want}")
    if bad:
        raise AssertionError(f"phase S: {bad} mismatches against cold "
                             f"builds")

    final, (w, W) = loop["final"], loop["answers"]
    lost = int(final.live().pool_lost.sum())
    gt = GroundTruth(stream.spec, cfg.k).insert_stream(stream)
    if not torch.equal(w, W[SWEEP.index(None)]):
        raise AssertionError("phase S3: last=None and its sweep row differ")
    under = 0
    for row, last in zip(W, SWEEP):
        truth = torch.tensor([gt.edge_weight(int(a), int(b), None, last)
                              for a, b in zip(qi["src"], qi["dst"])])
        est = row.cpu().long()
        under += int((est < truth - lost).sum())
        exact = float((est == truth).float().mean())
        _log(f"phase S3 last={last}: {len(truth)} edge answers vs "
             f"GroundTruth: est >= truth - pool_lost ({lost}) fails "
             f"{int((est < truth - lost).sum())}; exact {exact:.4f}, mean "
             f"over-count {float((est - truth).float().mean()):.4f}")
    out.update(truth_violations=under, pool_lost=lost)
    if under:
        raise AssertionError("phase S3: an estimate under-counts the truth")
    skt.clear_plane_cache(final)
    torch.cuda.empty_cache()

    times = {"sync": [], "async": []}
    for label in ("sync", "async", "async", "sync", "async*", "sync*"):
        st, sec, busy = ingest_pass(spec, batches, dev,
                                    pipelined=label.startswith("async"),
                                    profiled=label.endswith("*"))
        differ = _leaves_differ(final, st)
        busy_txt = "" if busy is None else f" (profiled: card busy {busy:.4f})"
        _log(f"phase S4 {label.rstrip('*')} pass{busy_txt}: {n / sec:.0f} "
             f"edges/s ({1e3 * sec:.1f} ms); final state vs the loop's, "
             f"leaf for leaf: "
             f"{'equal' if not differ else 'DIFFER ' + str(differ)} {tag}")
        if differ:
            raise AssertionError(f"phase S4: the {label} pass differs in "
                                 f"{differ}")
        if busy is None:
            times[label].append(n / sec)
        else:
            out[f"{label.rstrip('*')}_busy_share"] = busy
        del st
        torch.cuda.empty_cache()
    out.update(async_edges_per_s=times["async"],
               sync_edges_per_s=times["sync"])
    return out


# --------------------------------------------------------------------------
# phase R: skew-aware routing at the main deployment
# --------------------------------------------------------------------------

def _pool_use(state) -> dict:
    """Per-shard pool occupancy and pool_lost of a handle."""
    sh = state.live()
    return dict(pool_used=(sh.pool_key[..., 0] != -1).sum(1).tolist(),
                pool_lost=sh.pool_lost.tolist())


def _vertex_truth(stream, k: int, vertices) -> np.ndarray:
    """Exact windowed out-weight of each vertex (``GroundTruth``'s window
    rule over the stream's columns: one pass, not one a query)."""
    ws = max(1, stream.spec.window_size // k)
    widx = stream.time.astype(np.int64) // ws
    live = widx > widx.max() - k
    tot = np.bincount(stream.src[live], weights=stream.weight[live],
                      minlength=int(stream.src.max()) + 1)
    return tot[np.asarray(vertices)].astype(np.int64)


def route_phase(cfg, spec, stream, flushes, p4, dev, tag):
    """Phase R: phase 4's stream and flushes through ``AsyncIngestor``
    with the heavy-key detector (HEAT_THRESHOLD, SPLIT_REPLICAS), launches
    counted from 0 over the ingest and the queries. Logs the splits with
    the batch each came in, ``PARTITION_STATS`` beside the unrouted
    partition of the same batches, the per-shard pool use beside phase
    4's, and edges/s. Holds the final state, leaf for leaf, to synchronous
    ``ingest`` of the same batches, each under the spec it was partitioned
    with, and N_QUERIES edge and vertex-out answers one-sided against the
    exact truth. Returns (the launches, the numbers)."""
    batches = [stream.slice(a, z) for a, z in flushes]
    PARTITION_STATS.reset()
    for b in batches:  # the unrouted partition of the same batches
        _partition_stack(spec, b)
    plain_stats = PARTITION_STATS.snapshot()
    PARTITION_STATS.reset()
    qi = query_inputs(cfg, stream)
    qs = (query_batch(qi, "edge", False, None),
          query_batch(qi, "vertex-out", False, None))

    def path():
        ing = skt.AsyncIngestor(spec, path="cuda", device=dev,
                                heat_threshold=HEAT_THRESHOLD,
                                split_replicas=SPLIT_REPLICAS)
        specs, splits, prev = [], [], set()
        _sync()
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            ing.submit(b)  # partitioned under ing.spec after the detector
            cur = set(ing.spec.routing.splits) if ing.spec.routing else set()
            splits += [(list(e), i) for e in sorted(cur - prev)]
            prev = cur
            specs.append(ing.spec)
        final = ing.flush()
        _sync()
        sec = time.perf_counter() - t0
        return final, specs, splits, sec, [skt.query(spec, final, q,
                                                     path="cuda")
                                           for q in qs]

    names = MAIN_PATH if dev.type == "cuda" else ()
    (final, specs, splits, sec, answers), launches = count_launches(
        names, path)
    routed_stats = PARTITION_STATS.snapshot()
    use = _pool_use(final)
    n = len(stream)
    det = skt.HeavyKeyDetector()  # the detector's share: its updates alone
    _, det_s = _timed(lambda: [det.update(b.src, b.src_label)
                               for b in batches])
    _log(f"phase R: {n} edges in {len(batches)} flushes through "
         f"AsyncIngestor(heat_threshold={HEAT_THRESHOLD}, split_replicas="
         f"{SPLIT_REPLICAS}) in {sec:.3f} s = {n / sec:.0f} edges/s, of "
         f"which the detector's updates alone take {det_s:.3f} s (host "
         f"clock); launches {launches} {tag}")
    _log(f"phase R splits (src, src_label, replicas) and the batch each "
         f"came in: {json.dumps(splits)}")
    _log(f"phase R PARTITION_STATS routed {json.dumps(routed_stats)}; "
         f"unrouted, the same batches {json.dumps(plain_stats)}")
    _log(f"phase R pool use per shard {json.dumps(use)}; phase 4 "
         f"(unrouted) {json.dumps(p4)}")
    if not splits:
        raise AssertionError("phase R: the detector split no key")

    replay = skt.create(spec, device=dev)
    for b, sp in zip(batches, specs):
        replay = skt.ingest(sp, replay, b, path="cuda")
    differ = _leaves_differ(final, replay)
    _log(f"phase R final state vs synchronous ingest of the same batches "
         f"under the spec each was partitioned with, leaf for leaf: "
         f"{'equal' if not differ else 'DIFFER ' + str(differ)} {tag}")
    if differ:
        raise AssertionError(f"phase R: the routed state differs in "
                             f"{differ}")
    del replay
    torch.cuda.empty_cache()

    lost = int(final.live().pool_lost.sum())
    gt = GroundTruth(stream.spec, cfg.k).insert_stream(stream)
    truth = {"edge": np.array([gt.edge_weight(int(a), int(b))
                               for a, b in zip(qi["src"], qi["dst"])]),
             "vertex-out": _vertex_truth(stream, cfg.k, qi["v"])}
    for j in range(4):  # the one-pass truth is GroundTruth's
        v = int(qi["v"][j])
        if truth["vertex-out"][j] != gt.vertex_weight(v):
            raise AssertionError("phase R: the vertex truth differs from "
                                 "GroundTruth")
    under = {}
    for (kind, t), est in zip(truth.items(), answers):
        est = est.cpu().numpy().astype(np.int64)
        under[kind] = int((est < t - lost).sum())
        _log(f"phase R {kind}: {len(t)} answers vs the exact truth: est >= "
             f"truth - pool_lost ({lost}) fails {under[kind]}; exact "
             f"{float((est == t).mean()):.4f}, mean over-count "
             f"{float((est - t).mean()):.4f}")
    if any(under.values()):
        raise AssertionError("phase R: an estimate under-counts the truth")
    return launches, dict(edges=n, batches=len(batches), edges_per_s=n / sec,
                          detector_s=det_s, splits=splits, partition_routed=routed_stats,
                          partition_unrouted=plain_stats, pool=use,
                          pool_phase4=p4, truth_violations=under)


# --------------------------------------------------------------------------
# phase T: the tenant pool
# --------------------------------------------------------------------------

def tenant_streams(cfg):
    """Each tenant's stream (the COMFS analog from seed t, TENANT_EDGES
    long, its clock offset by TENANT_OFFSET * t subwindows), its batches
    cut at its own subwindow boundaries, and its query inputs."""
    out = []
    for t in range(TENANTS):
        st = generate(dataclasses.replace(COMFS, n_edges=TENANT_EDGES),
                      seed=t, weighted=True)
        st = dataclasses.replace(st, time=st.time + np.int32(
            TENANT_OFFSET * t * cfg.subwindow_size))
        batches, _ = stream_batches(cfg, st)
        out.append((st, batches, query_inputs(cfg, st)))
    return out


def _tenant_queries(qi):
    """Phase T2's query batches of one tenant, by (kind, last, label)."""
    sl = slice(0, TENANT_QUERIES)
    return {(kind, last, le): query_batch(qi, kind, le, last, sl)
            for kind in KINDS for last in (None, 1) for le in (False, True)}


def _tenant_topk(spec, state, pool=None):
    """Phase T2's top-k calls: k=16 vertex out and in, edge and label at
    last=None, and a heavy_vertices sweep at SWEEP, on a standalone
    handle or (``pool``) through ``top_k_many`` for every tenant."""
    calls = {"vertex-out": ("heavy_vertices", "vertex", {"direction": "out"}),
             "vertex-in": ("heavy_vertices", "vertex", {"direction": "in"}),
             "edge": ("heavy_edges", "edge", {}),
             "label": ("top_labels", "label", {"direction": "out"}),
             "sweep": ("heavy_vertices", "vertex",
                       {"direction": "out", "horizons": list(SWEEP)})}
    out = {}
    for label, (fn, kind, kw) in calls.items():
        if pool is None:
            out[label] = [x.cpu() for x in getattr(skt, fn)(
                spec, state, 16, path="cuda", **kw)]
        else:
            before = cell_decode_kernel_sharded.launches
            got = pool.top_k_many(range(TENANTS), kind=kind, k=16, **kw)
            decodes = cell_decode_kernel_sharded.launches - before
            if pool.device.type == "cuda" and decodes != 1:
                raise AssertionError(f"phase T3: top_k_many {label} took "
                                     f"{decodes} decode launches, not 1")
            out[label] = [[x.cpu() for x in g] for g in got]
    return out


def grouped_nbytes(cfg, planes, q, groups, kind, H=1, direction="out"):
    """Bytes a grouped launch must move: each group's bytes as its rows
    alone would (``probe_nbytes`` / ``scan_nbytes``), the edge probe's
    block table counted once."""
    S = planes.key.shape[0]
    per, Lq = S // groups, q[0].shape[0] // groups
    total = 0
    for g in range(groups):
        rows, qs = slice(g * per, (g + 1) * per), slice(g * Lq, (g + 1) * Lq)
        if kind == "edge":
            src, la, dst, lb, le = (x[qs] for x in q)
            pr = edge_probes(cfg, precompute(cfg, src, la),
                             precompute(cfg, dst, lb))
            le_idx = hsh.edge_label_bucket(le, cfg.c, cfg.seed)
            total += probe_nbytes(cfg, pr, le_idx, planes.key[rows], H,
                                  (planes.pool_key[rows], cfg.pool_probes))
        else:
            lines, f, le_idx = (x[qs] for x in q)
            total += scan_nbytes(cfg, lines, f, le_idx, planes.key[rows],
                                 direction)
    if kind == "edge":
        total -= (groups - 1) * 2 * cfg.n_blocks * 4
    return total


def check_grouped_kernels(cfg, spec, pool, tq, dev, tag) -> dict:
    """Phase T4: the grouped entries of the edge probe (H = 1 and the
    SWEEP stack) and the vertex scan (out and in) against their plain
    versions on the pool's planes and the tenants' queries, exactly;
    CUDA-event medians, the plain version's time and the byte bound."""
    G = pool.n_slots
    state = pool.state
    planes = skt.query_planes(spec, state, None, groups=G)
    multi, uniq = skt.query_planes_multi(spec, state, list(SWEEP), groups=G)
    t = lambda k: torch.from_numpy(np.concatenate(  # noqa: E731
        [qi[k][:TENANT_QUERIES] for qi in tq])).to(dev)
    q = [t(k) for k in ("src", "src_label", "dst", "dst_label", "le")]
    pairs = []
    for pl in (planes, multi):
        for le in (q[4], None):
            got = edge_query_kernel(cfg, pl, *q[:4], le, groups=G)
            want = edge_query_plain(cfg, pl, *q[:4], le, groups=G)
            pairs += list(zip(got, want))
    _sync()
    mism, err = diff(pairs)
    del pairs
    one, sweep = (cfg, planes, *q), (cfg, multi, *q)
    times = event_times(lambda: edge_query_kernel(*one, groups=G), 20)
    sweep_t = event_times(lambda: edge_query_kernel(*sweep, groups=G), 20)
    plain_ms = event_ms(lambda: edge_query_plain(*one, groups=G), 3)
    nbytes = grouped_nbytes(cfg, planes, q, G, "edge")
    sweep_bytes = grouped_nbytes(cfg, planes, q, G, "edge", H=len(uniq))
    _log(f"phase T4 edge probe, grouped entry (G={G}, {TENANT_QUERIES} "
         f"queries a group) vs plain: mismatches={mism} (H=1 and the "
         f"H={len(uniq)} sweep, with and without the label); H=1 median "
         f"{np.median(times):.4f} ms (CUDA events, 20 launches), plain "
         f"{plain_ms:.3f} ms, byte bound {1e3 * nbytes / HBM_BYTES_PER_S:.7f}"
         f" ms; sweep median {np.median(sweep_t):.4f} ms, byte bound "
         f"{1e3 * sweep_bytes / HBM_BYTES_PER_S:.7f} ms {tag}")
    rows = {"sketch_query_kernel_sharded (grouped)": dict(
        mismatches=mism, max_abs_err=err, ms=float(np.median(times)),
        plain_ms=plain_ms, nbytes=nbytes,
        sweep_ms=float(np.median(sweep_t)),
        bound_ms_sweep=1e3 * sweep_bytes / HBM_BYTES_PER_S,
        shape=f"S={planes.key.shape[0]} G={G} Lq={TENANT_QUERIES}")}

    v = torch.from_numpy(np.concatenate([qi["v"][:TENANT_QUERIES]
                                         for qi in tq])).to(dev)
    lv = torch.from_numpy(np.concatenate([qi["lv"][:TENANT_QUERIES]
                                          for qi in tq])).to(dev)
    pre, lines = scan_lines(cfg, v, lv)
    le_idx = hsh.edge_label_bucket(q[4], cfg.c, cfg.seed)
    v_args = (lines, pre.f.contiguous(), le_idx, planes.key, planes.cw,
              planes.pw)
    res = {}
    for direction in ("out", "in"):
        kw = dict(r=cfg.r, F=cfg.F, direction=direction, groups=G)
        pairs = []
        for lab in (le_idx, None):
            a = (lines, v_args[1], lab) + v_args[3:]
            pairs += list(zip(vertex_scan_kernel_sharded(*a, **kw),
                              vertex_scan_plain(*a, **kw)))
        _sync()
        m, e = diff(pairs)
        del pairs
        ts = event_times(lambda: vertex_scan_kernel_sharded(*v_args, **kw),
                         20)
        p_ms = event_ms(lambda: vertex_scan_plain(*v_args, **kw), 3)
        nb = grouped_nbytes(cfg, planes, (lines, pre.f, le_idx), G, "scan",
                            direction=direction)
        res[direction] = (m, e, float(np.median(ts)), p_ms, nb)
        _log(f"phase T4 vertex scan[{direction}], grouped entry (G={G}) vs "
             f"plain: mismatches={m}; median {np.median(ts):.4f} ms (CUDA "
             f"events, 20 launches), plain {p_ms:.3f} ms, byte bound "
             f"{1e3 * nb / HBM_BYTES_PER_S:.4f} ms {tag}")
    vo, vn = res["out"], res["in"]
    rows["vertex_scan_kernel_sharded (grouped)"] = dict(
        mismatches=vo[0] + vn[0], max_abs_err=max(vo[1], vn[1]), ms=vo[2],
        plain_ms=vo[3], nbytes=vo[4], direction="out", ms_in=vn[2],
        plain_ms_in=vn[3], bound_ms_in=1e3 * vn[4] / HBM_BYTES_PER_S,
        shape=f"S={planes.key.shape[0]} G={G} Lq={TENANT_QUERIES}")
    if any(r["mismatches"] for r in rows.values()):
        raise AssertionError("phase T4: a grouped entry disagrees with its "
                             "plain version")
    return rows


def tenant_path(spec, streams, pool, dev, tag):
    """Phase T1-T3 (launches counted from 0 over them): the pooled ingest,
    every tenant's ``query_many`` batches and ``top_k_many`` calls."""
    n_rounds = max(len(b) for _, b, _ in streams)
    scan_before = eng.ROUTE_EDGES["scan"]
    round_ms = []
    t_all = time.perf_counter()
    for r in range(n_rounds):
        rnd = {t: b[r] for t, (_, b, _) in enumerate(streams) if r < len(b)}
        _, sec = _timed(lambda: pool.submit(rnd))
        round_ms.append(1e3 * sec)
    _, sec = _timed(pool.flush)
    round_ms[-1] += 1e3 * sec
    ingest_s = time.perf_counter() - t_all
    n = sum(len(s) for s, _, _ in streams)
    scan = eng.ROUTE_EDGES["scan"] - scan_before
    _log(f"phase T1 pooled ingest: {n} edges of {TENANTS} tenants in "
         f"{n_rounds} rounds, {ingest_s:.3f} s = {n / ingest_s:.0f} edges/s;"
         f" scan-route edges {scan}; a round (submit, synchronised) median "
         f"{np.median(round_ms):.3f} ms {tag}")
    if scan:
        raise AssertionError("phase T1: a pooled round took the scan route")
    answers, launched = {}, {}
    tqs = [_tenant_queries(qi) for _, _, qi in streams]
    for key in tqs[0]:
        pairs = [(t, tq[key]) for t, tq in enumerate(tqs)]
        pool.query_many(pairs, path="cuda")  # the planes: set-up
        before = {k: WRAPPERS[k].launches for k in MAIN_PATH[2:]}
        got, sec = _timed(lambda: pool.query_many(pairs, path="cuda"))
        launched[key] = {k: WRAPPERS[k].launches - v
                         for k, v in before.items()}
        answers[key] = ([g.cpu() for g in got], sec)
    for (kind, _, _), moved in launched.items():
        want = {"edge": (1, 0), "vertex-out": (0, 1), "vertex-in": (0, 1),
                "label": (0, 0)}[kind]
        got = (moved["sketch_query_kernel_sharded"],
               moved["vertex_scan_kernel_sharded"])
        if dev.type == "cuda" and got != want:
            raise AssertionError(f"phase T3: a pooled {kind} dispatch "
                                 f"launched {got} (probe, scan), not {want}")
    _log(f"phase T3 a pooled dispatch's launches (edge probe, vertex scan):"
         f" edge {tuple(launched[('edge', None, False)].values())}, vertex "
         f"{tuple(launched[('vertex-out', None, False)].values())}, label "
         f"{tuple(launched[('label', None, False)].values())} {tag}")
    topk = _tenant_topk(spec, None, pool)
    return dict(round_ms=round_ms, ingest_s=ingest_s, edges=n,
                rounds=n_rounds, answers=answers, topk=topk, tqs=tqs)


def tenant_phase(dev, tag):
    """Phase T: TENANTS tenants of TENANT_CFG at TENANT_SHARDS shards in a
    ``TenantPool`` of TENANTS slots, each on its own clock; the tenant
    spec routed by the detector over the first round. T1-T3 counted
    (``tenant_path``), T2 every tenant against a standalone handle fed
    the same batches, T4 the grouped kernel entries, T5 an eviction and a
    readmission through checkpoints, T6 pooled against standalone costs.
    Returns (the grouped kernel rows, the launches, the numbers)."""
    import tempfile

    cfg = TENANT_CFG
    streams = tenant_streams(cfg)
    spec, budget, hot = tenant_spec(cfg, streams)
    _log(f"phase T: {TENANTS} tenants x {TENANT_SHARDS} shards of {cfg} "
         f"({state_bytes(cfg) * TENANTS * TENANT_SHARDS} bytes pooled); "
         f"streams of {TENANT_EDGES} edges, clocks offset by "
         f"{TENANT_OFFSET} subwindows a tenant, batches <= {STREAM_FLUSH} "
         f"cut at each tenant's own boundaries; recommend_budget over the "
         f"first round: {json.dumps(budget.to_json())}; the detector's "
         f"keys past {HEAT_THRESHOLD}: {hot}; tenant routing "
         f"{spec.routing.splits}")
    if not spec.routing:
        raise AssertionError("phase T: the tenant spec holds no split")
    with tempfile.TemporaryDirectory() as tmp:
        pool = skt.TenantPool(spec, n_slots=TENANTS, directory=tmp,
                              path="cuda", device=dev)
        for t in range(TENANTS):
            pool.attach(t)
        names = ("sketch_insert_kernel_sharded", "pool_pass_kernel_sharded",
                 "sketch_query_kernel_sharded", "vertex_scan_kernel_sharded",
                 "cell_decode_kernel_sharded") if dev.type == "cuda" else ()
        out, launches = count_launches(names, lambda: tenant_path(
            spec, streams, pool, dev, tag))
        _log(f"phase T pool-path launches: {launches} {tag}")
        out.update(tenant_checks(spec, streams, pool, out, dev, tag))
        rows = check_grouped_kernels(cfg, spec, pool,
                                     [qi for _, _, qi in streams], dev, tag)
        out.update(tenant_evict(spec, pool, out["tqs"], tmp, dev, tag))
        del pool
    torch.cuda.empty_cache()
    out.pop("answers"), out.pop("topk"), out.pop("tqs")
    return rows, launches, out


def tenant_checks(spec, streams, pool, out, dev, tag) -> dict:
    """Phase T2 and T6: each tenant in turn against a standalone handle
    fed the same batches (ingest timed a batch), leaf for leaf, every
    pooled answer and top-k against the standalone ones; then freed."""
    single_ms = {}  # round -> standalone ingest ms summed over tenants
    single_q = []
    bad = []
    for t, (st, batches, _) in enumerate(streams):
        h = skt.create(spec, device=dev)
        for r, b in enumerate(batches):
            _sync()
            t0 = time.perf_counter()
            h = skt.ingest(spec, h, b, path="cuda")
            _sync()
            single_ms[r] = single_ms.get(r, 0.0) + \
                1e3 * (time.perf_counter() - t0)
        _, mine = pool.handle_of(t)
        differ = _leaves_differ(h, mine)
        del mine
        if differ:
            bad.append((t, "state", differ))
        for key, q in out["tqs"][t].items():
            want = skt.query(spec, h, q, path="cuda")
            if key == ("edge", None, False):  # T6: a standalone call, timed
                _, sec = _timed(lambda: skt.query(spec, h, q, path="cuda"))
                single_q.append(sec)
            if not torch.equal(out["answers"][key][0][t], want.cpu()):
                bad.append((t, key))
        for label, got in _tenant_topk(spec, h).items():
            if not all(torch.equal(a, b) for a, b in zip(
                    out["topk"][label][t], got)):
                bad.append((t, "top-k " + label))
        del h
        torch.cuda.empty_cache()
    _log(f"phase T2 every tenant vs a standalone {TENANT_SHARDS}-shard "
         f"handle fed the same batches: handle_of leaf for leaf, "
         f"{len(out['tqs'][0])} query_many batches of {TENANT_QUERIES} a "
         f"tenant and 5 top-k calls (k=16; one sweep {list(SWEEP)}): "
         f"{'all equal' if not bad else 'DIFFER ' + str(bad[:8])} {tag}")
    if bad:
        raise AssertionError(f"phase T2: {len(bad)} differences")
    pooled_q = out["answers"][("edge", None, False)][1]
    nq = TENANTS * TENANT_QUERIES
    rounds = sorted(single_ms)
    ratio = [single_ms[r] / out["round_ms"][r] for r in rounds]
    _log(f"phase T6 (recorded, not claimed): an edge query_many of {nq} "
         f"queries {1e6 * pooled_q / nq:.3f} us/query against "
         f"{TENANTS} standalone query calls {1e6 * sum(single_q) / nq:.3f} "
         f"us/query; a pooled ingest round median "
         f"{np.median(out['round_ms']):.3f} ms against {TENANTS} "
         f"standalone ingests of the same batches median "
         f"{np.median([single_ms[r] for r in rounds]):.3f} ms (standalone "
         f"/ pooled by round, median {np.median(ratio):.3f}) {tag}")
    return dict(pooled_query_us=1e6 * pooled_q / nq,
                standalone_query_us=1e6 * sum(single_q) / nq,
                pooled_round_ms=float(np.median(out["round_ms"])),
                standalone_round_ms=float(np.median(
                    [single_ms[r] for r in rounds])),
                pooled_edges_per_s=out["edges"] / out["ingest_s"])


def tenant_evict(spec, pool, tqs, tmp, dev, tag) -> dict:
    """Phase T5: attaching one tenant more than the pool holds evicts the
    least recently used one through a checkpoint; querying it again
    readmits it into another slot, with the same answers."""
    import os

    lru, slot = 0, pool.slot_of(0)
    keys = [("edge", None, True), ("vertex-out", 1, True),
            ("label", None, False)]
    before = [pool.query(lru, tqs[lru][k], path="cuda").cpu() for k in keys]
    pool.query_many([(t, tqs[t][keys[1]]) for t in range(TENANTS)],
                    path="cuda")  # touched first: tenant 0 is the LRU
    _, save_s = _timed(lambda: pool.attach("extra"))
    if lru in pool.tenants or pool.slot_of("extra") != slot:
        raise AssertionError("phase T5: the LRU tenant was not evicted")
    where = os.path.join(tmp, f"tenant-{lru}")
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(where) for f in fs)
    extra = skt.saved_extra(where)
    _, restore_s = _timed(lambda: skt.restore(spec, where, device=dev))
    torch.cuda.empty_cache()
    after = [pool.query(lru, tqs[lru][k], path="cuda").cpu() for k in keys]
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    _log(f"phase T5 attach of a {TENANTS + 1}th tenant evicted tenant "
         f"{lru} (slot {slot}; manifest extra {extra}) in {save_s:.3f} s "
         f"(the checkpoint's save and the slot's clearing); its checkpoint "
         f"{nbytes} bytes; a restore alone {restore_s:.3f} s; readmitted "
         f"into slot {pool.slot_of(lru)}: answers "
         f"{'equal' if same else 'DIFFER'} to those before eviction {tag}")
    if not same or pool.slot_of(lru) == slot or \
            extra != {"tenant_id": str(lru)}:
        raise AssertionError("phase T5: the readmitted tenant differs")
    return dict(checkpoint_bytes=nbytes, evict_s=save_s, restore_s=restore_s)


# --------------------------------------------------------------------------
# phase V: the sketch server
# --------------------------------------------------------------------------

def server_requests(qi, n: int) -> list:
    """``n`` interleaved requests ``(kind, args)``: request i is kind
    ``KINDS[i % 4]``, with the edge label when ``(i // 4)`` is odd, at
    ``last = SERVER_LASTS[(i // 8) % 3]``, on query input ``i % N``."""
    out = []
    for i in range(n):
        kind, j = KINDS[i % 4], i % len(qi["src"])
        a = {"last": SERVER_LASTS[(i // 8) % 3]}
        if (i // 4) % 2:
            a["le"] = int(qi["le"][j])
        if kind == "edge":
            a.update(src=int(qi["src"][j]), la=int(qi["src_label"][j]),
                     dst=int(qi["dst"][j]), lb=int(qi["dst_label"][j]))
        elif kind == "label":
            a.update(lv=int(qi["labels"][j]))
        else:
            a.update(v=int(qi["v"][j]), lv=int(qi["lv"][j]),
                     direction=kind[7:])
        out.append(("edge" if kind == "edge" else kind[:6], a))
    return out


def _groups(server, handles) -> dict:
    """The server's request groups of ``handles``: group key -> requests,
    in submission order."""
    groups = {}
    for r in handles:
        groups.setdefault(server._group_key(r), []).append(r)
    return groups


def serve_requests(server, reqs):
    """Submit ``reqs`` and flush, synchronised; returns (the request
    handles, seconds, the wrappers' launches over it)."""
    before = {n: w.launches for n, w in WRAPPERS.items()}
    _sync()
    t0 = time.perf_counter()
    handles = [server.submit(kind, **a) for kind, a in reqs]
    server.flush()
    _sync()
    sec = time.perf_counter() - t0
    return handles, sec, {n: w.launches - before[n]
                          for n, w in WRAPPERS.items()}


def _check_group_launches(groups, moved, what, k=None) -> None:
    """One edge-probe launch per edge group and one vertex-scan launch per
    vertex group (label groups reduce planes: none); with ``k``, a single
    handle's passes: one edge-probe launch a flush with edge groups and
    one vertex-scan launch a (direction, horizon ``min(last or k, k)``)
    of its vertex groups."""
    if k is None:
        want = (sum(g[0] == "edge" for g in groups),
                sum(g[0] == "vertex" for g in groups))
    else:
        want = (int(any(g[0] == "edge" for g in groups)),
                len({(g[3], min(g[2] or k, k)) for g in groups
                     if g[0] == "vertex"}))
    got = (moved["sketch_query_kernel_sharded"],
           moved["vertex_scan_kernel_sharded"])
    if got != want:
        raise AssertionError(f"{what}: {got} (probe, scan) launches for "
                             f"{want} (edge, vertex) groups")


def server_single(spec, stream, flushes, qi, dev, tag):
    """Phases V1-V2 (launches counted from 0 over them): phase 4's
    batches through the server's ingest, the mixed requests in one flush
    and again kind by kind, and the analytics."""
    server = SketchServer(spec, heat_threshold=HEAT_THRESHOLD,
                          split_replicas=SPLIT_REPLICAS,
                          horizons=list(SERVER_HORIZONS), device=dev)
    batches = [stream.slice(a, z) for a, z in flushes]
    _sync()
    t0 = time.perf_counter()
    for b in batches:
        server.ingest(b)
    server.state  # drains the pipeline
    _sync()
    ingest_s = time.perf_counter() - t0
    n = len(stream)
    reqs = server_requests(qi, SERVER_REQUESTS)
    handles, sec, moved = serve_requests(server, reqs)
    groups = _groups(server, handles)
    if dev.type == "cuda":
        _check_group_launches(groups, moved, "phase V2 mixed flush",
                              spec.config.effective_k)
    by_kind = {}
    for kind in KINDS:
        sub = [r for i, r in enumerate(reqs) if KINDS[i % 4] == kind]
        hs, s, mv = serve_requests(server, sub)
        if dev.type == "cuda":
            _check_group_launches(_groups(server, hs), mv,
                                  f"phase V2 {kind} flush",
                                  spec.config.effective_k)
        by_kind[kind] = dict(requests=len(sub), us=1e6 * s / len(sub))
    topk = {kind: [x.cpu() for x in server.top_k(kind, SERVER_TOPK)]
            for kind in ("vertex", "edge", "label")}
    _log(f"phase V1 server ingest: {n} edges in {len(batches)} batches "
         f"through SketchServer(heat_threshold={HEAT_THRESHOLD}, "
         f"split_replicas={SPLIT_REPLICAS}, horizons="
         f"{list(SERVER_HORIZONS)}) in {ingest_s:.3f} s = "
         f"{n / ingest_s:.0f} edges/s (host clock, synchronised; the "
         f"detector and the prewarm of every horizon after each batch "
         f"included) {tag}")
    _log(f"phase V2 {len(handles)} mixed requests in {len(groups)} groups, "
         f"one flush: {sec:.4f} s = {1e6 * sec / len(handles):.3f} us a "
         f"request; launches {moved}; by kind alone (us a request): "
         f"{json.dumps({k: round(v['us'], 3) for k, v in by_kind.items()})}"
         f" {tag}")
    return server, dict(ingest_s=ingest_s, edges_per_s=n / ingest_s,
                        mixed_s=sec, mixed_us=1e6 * sec / len(handles),
                        groups=len(groups), mixed_launches=moved,
                        by_kind=by_kind), handles, groups, topk


def server_checks(spec, server, handles, groups, topk, qi, tag) -> dict:
    """Phase V3: every answer equal to ``skt.query`` on ``server.state``
    for its group (timed: the bare batched query), the first
    N_SCAN_SAMPLE of each group equal to the scan path's, top-k equal to
    ``skt.heavy_*`` on the scan path, and reachability of sampled
    in-window edges."""
    state = server.state
    mism, bare = 0, {}
    for (kind, with_le, last, direction), rs in groups.items():
        q = server._group_batch(kind, rs, with_le, last, direction)
        got = torch.tensor([r.answer for r in rs], dtype=torch.int32)
        want, sec = _timed(lambda: skt.query(spec, state, q, path="cuda"))
        bare.setdefault(kind if kind != "vertex" else "vertex-" + direction,
                        []).append((sec, len(rs)))
        mism += int((want.cpu() != got).sum())
        qs = server._group_batch(kind, rs[:N_SCAN_SAMPLE], with_le, last,
                                 direction)
        mism += int((skt.query(spec, state, qs, path="scan").cpu() !=
                     got[:N_SCAN_SAMPLE]).sum())
    calls = {"vertex": ("heavy_vertices", {"direction": "out"}),
             "edge": ("heavy_edges", {}),
             "label": ("top_labels", {"direction": "out"})}
    for kind, (fn, kw) in calls.items():
        want = getattr(skt, fn)(spec, state, SERVER_TOPK, path="scan", **kw)
        mism += sum(int((a != b.cpu()).sum()) for a, b in zip(topk[kind],
                                                               want))
    bare_us = {k: 1e6 * sum(s for s, _ in v) / sum(n for _, n in v)
               for k, v in bare.items()}
    edge = [r for r in groups[("edge", False, None, "out")] if r.answer > 0]
    pick = edge[:N_REACH]
    reach, reach_s = _timed(lambda: server.reachable(
        *[np.array([r.args[f] for r in pick], np.int32)
          for f in ("src", "la", "dst", "lb")], max_hops=REACH_HOPS))
    _log(f"phase V3 every answer vs skt.query on server.state by group, "
         f"the first {N_SCAN_SAMPLE} of each vs the scan path, top_k "
         f"(vertex, edge, label; k={SERVER_TOPK}) vs skt.heavy_* on the scan "
         f"path: mismatches={mism}; the bare batched query (us a query, "
         f"cached planes) {json.dumps({k: round(v, 3) for k, v in bare_us.items()})}; "
         f"reachable on {len(pick)} sampled in-window edges "
         f"(max_hops={REACH_HOPS}): {int(reach.sum())} in "
         f"{1e3 * reach_s:.3f} ms {tag}")
    if mism or not reach.all() or not pick:
        raise AssertionError("phase V3: a served answer differs")
    return dict(mismatches=mism, bare_us=bare_us, reach=len(pick),
                reach_ms=1e3 * reach_s)


def tenant_spec(cfg, streams):
    """Phase T's tenant spec: the detector over every tenant's first
    batch, ``recommend_budget``'s table and the keys past HEAT_THRESHOLD
    split over TENANT_SHARDS. Returns (the spec, the budget report, the
    detector's hot keys)."""
    base = skt.make_spec("lsketch", n_shards=TENANT_SHARDS, config=cfg)
    det = skt.HeavyKeyDetector()
    for _, batches, _ in streams:
        det.update(batches[0].src, batches[0].src_label)
    budget = skt.recommend_budget(base, det)
    hot = [(s, l, TENANT_SHARDS) for s, l, _ in det.hot_keys(HEAT_THRESHOLD)]
    return base.replace(routing=budget.routing.merged(hot)), budget, hot


def server_pool(dev, tag):
    """Phase V4: phase T's tenants through a pool-mode server, interleaved
    requests of every tenant in one flush (launches counted from 0 over
    the ingest and the flush), each answer equal to a per-tenant
    ``query_many`` call. Returns (the launches, the numbers)."""
    cfg = TENANT_CFG
    streams = tenant_streams(cfg)
    spec, _, _ = tenant_spec(cfg, streams)
    pool = skt.TenantPool(spec, n_slots=TENANTS, path="cuda", device=dev)
    server = SketchServer(pool=pool, horizons=list(SERVER_HORIZONS))
    n_rounds = max(len(b) for _, b, _ in streams)
    n = sum(len(s) for s, _, _ in streams)
    reqs = []
    for t, (_, _, qi) in enumerate(streams):
        sub = server_requests({k: v[:TENANT_QUERIES] for k, v in qi.items()},
                              3 * TENANT_QUERIES)
        reqs += [(kind, dict(a, tenant=t)) for kind, a in sub]
    order = np.random.default_rng(SEED + 3).permutation(len(reqs))
    reqs = [reqs[i] for i in order]  # tenants interleaved

    def path():
        _sync()
        t0 = time.perf_counter()
        for r in range(n_rounds):
            server.ingest_many({t: b[r] for t, (_, b, _) in
                                enumerate(streams) if r < len(b)})
        server.state  # drains the pipeline
        _sync()
        return time.perf_counter() - t0, serve_requests(server, reqs)

    names = MAIN_PATH if dev.type == "cuda" else ()
    (ingest_s, (handles, sec, moved)), launches = count_launches(names, path)
    groups = _groups(server, handles)
    mism = 0
    for (kind, with_le, last, direction), rs in groups.items():
        for t in range(TENANTS):
            mine = [r for r in rs if r.tenant == t]
            if not mine:
                continue
            q = server._group_batch(kind, mine, with_le, last, direction)
            want = pool.query_many([(t, q)], path="cuda")[0].cpu()
            got = torch.tensor([r.answer for r in mine], dtype=torch.int32)
            mism += int((want != got).sum())
    if dev.type == "cuda":
        _check_group_launches(groups, moved, "phase V4 pooled flush")
    _log(f"phase V4 pool mode: {TENANTS} tenants x {TENANT_SHARDS} shards of "
         f"d={cfg.d}, {n} edges in {n_rounds} rounds of ingest_many, "
         f"{ingest_s:.3f} s = {n / ingest_s:.0f} edges/s; {len(handles)} "
         f"interleaved requests in {len(groups)} groups, one flush "
         f"{1e6 * sec / len(handles):.3f} us a request, launches {moved}; "
         f"every answer vs a per-tenant TenantPool.query_many call: "
         f"mismatches={mism} {tag}")
    if mism:
        raise AssertionError("phase V4: a pooled answer differs")
    del server, pool
    return launches, dict(edges=n, rounds=n_rounds, edges_per_s=n / ingest_s,
                          requests=len(handles), groups=len(groups),
                          us=1e6 * sec / len(handles), mismatches=mism)


def server_cli(dev, tag) -> int:
    """Phase V5: ``repro_torch.launch.serve --mode sketch`` with CLI_ARGS
    for every kind, and once in pool mode with a sweep, as concurrent
    processes; each must exit 0."""
    root = Path(__file__).resolve().parent
    runs = [["--sketch", k] for k in ("lsketch", "gss", "lgs")]
    runs.append(["--tenants", "4", "--horizons", "1,2,4"])
    extra = list(CLI_ARGS) + (["--device", "cpu"] if dev.type == "cpu"
                              else [])
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "sketch", *a, *extra], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for a in runs]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    sec = time.perf_counter() - t0
    for a, p, out in zip(runs, procs, outs):
        keep = [x for x in out.splitlines()
                if x.startswith(("ingested", "answered", "horizon"))]
        _log(f"phase V5 serve --mode sketch {' '.join(a + extra)}: exit "
             f"{p.returncode}: {' | '.join(keep)} {tag}")
        if p.returncode != 0:
            raise AssertionError(f"phase V5: {a} exited {p.returncode}:\n"
                                 f"{out[-2000:]}")
    _log(f"phase V5 {len(runs)} CLI runs side by side in {sec:.1f} s {tag}")
    return len(runs)


def server_bigram(dev, tag) -> tuple:
    """Phase V6 (launches counted from 0 over its card half):
    ``BigramSketch`` on the card fed BIGRAM_STEPS batches of the
    synthetic corpus, held to a CPU twin: the state leaf for leaf, sampled
    bigram weights (last in {None, 2}) and every band's volume and
    drift."""
    corpus = SyntheticCorpus(TokenPipelineConfig(
        vocab_size=DEFAULT_BAND_VOCAB, batch_size=BIGRAM_BATCH[0],
        seq_len=BIGRAM_BATCH[1], seed=SEED))
    toks = [corpus.batch_at(s) for s in range(BIGRAM_STEPS)]

    def card():
        big = BigramSketch(device=dev)
        for t in toks:
            big.ingest_tokens(t)
        flat = toks[-1].reshape(-1)
        pairs = [(int(flat[i]), int(flat[i + 1])) for i in range(0, 64)]
        return big, [big.bigram_weight(a, b, last=h)
                     for a, b in pairs for h in (None, 2)], pairs

    names = ("sketch_insert_kernel_sharded", "sketch_query_kernel_sharded") \
        if dev.type == "cuda" else ()
    (big, got, pairs), launches = count_launches(names, card)
    twin = BigramSketch(device="cpu")
    for t in toks:
        twin.ingest_tokens(t)
    want = [twin.bigram_weight(a, b, last=h) for a, b in pairs
            for h in (None, 2)]
    differ = _differs(twin.sketch.state, big.sketch.state)
    bands = [(big.band_volume(b), big.drift(b)) for b in range(big.n_bands)]
    same = got == want and not differ and bands == [
        (twin.band_volume(b), twin.drift(b)) for b in range(twin.n_bands)]
    _log(f"phase V6 BigramSketch: {BIGRAM_STEPS} steps of {toks[0].size} "
         f"tokens on the card vs a CPU twin: state "
         f"{'equal' if not differ else 'DIFFER ' + str(differ)}, "
         f"{len(got)} bigram weights and {len(bands)} band volumes and "
         f"drifts {'equal' if same else 'DIFFER'}; launches {launches} "
         f"{tag}")
    if not same:
        raise AssertionError("phase V6: BigramSketch differs from its twin")
    return launches, dict(steps=BIGRAM_STEPS, weights=len(got))


def server_phase(spec, stream, flushes, dev, tag):
    """Phase V: the sketch server at the deployment (V1-V3), in pool mode
    at phase T's tenants (V4), its CLI (V5) and ``BigramSketch`` (V6).
    Returns (launches by path, the numbers, and for phase M the served
    handle with its live spec and ``budget_report()``)."""
    qi = query_inputs(CFG, stream)
    names = MAIN_PATH + ("cell_decode_kernel_sharded",) \
        if dev.type == "cuda" else ()
    (server, out, handles, groups, topk), launches = count_launches(
        names, lambda: server_single(spec, stream, flushes, qi, dev, tag))
    out.update(server_checks(spec, server, handles, groups, topk, qi, tag))
    report = server.budget_report()
    out.update(budget=report.to_json(), summary=server.serving_summary())
    _log(f"phase V3 budget_report(): {json.dumps(out['budget'])}; "
         f"serving_summary(): {out['summary']} {tag}")
    state, live = server.state, server.live_spec
    skt.clear_plane_cache(state)
    del server, handles, groups
    torch.cuda.empty_cache()
    p_launches, out["pool"] = server_pool(dev, tag)
    torch.cuda.empty_cache()
    out["cli_runs"] = server_cli(dev, tag)
    b_launches, out["bigram"] = server_bigram(dev, tag)
    torch.cuda.empty_cache()
    paths = {"server": launches, "server_pool": p_launches,
             "bigram": b_launches}
    out["launches"] = paths
    return paths, out, (state, live, report.routing)


# --------------------------------------------------------------------------
# phase M: merge, reshard and restore
# --------------------------------------------------------------------------

def _occupancy(state) -> dict:
    """Per-shard occupied matrix cells and pool entries, and pool_lost."""
    sh = state.live()
    return dict(cells=(sh.key != -1).flatten(1).sum(1).tolist(),
                **_pool_use(state))


def _cpu_handle(state):
    return skt.ShardedState(_to_cpu(state.live()))


RESHARD_PATH = ("sketch_insert_kernel_sharded", "pool_pass_kernel_sharded",
                "cell_decode_kernel_sharded")


def _add_launches(total: dict, more: dict) -> dict:
    return {n: total.get(n, 0) + more[n] for n in more}


def merge_tenant(dev, tag):
    """Phase M1: one tenant at phase T's size (tenant 0's stream into
    TENANT_SHARDS shards under phase T's routing), resharded on the card
    2 -> 4, 2 -> 1 and 2 -> 4 with the prune (``detector=`` over the
    tenant's whole stream, ``heat_threshold=`` just above its coolest
    split key's share), each leaf for leaf against the plain replay of a
    CPU copy. Returns (the launches, numbers, the handle, the spec, the
    card results by case)."""
    cfg = TENANT_CFG
    streams = tenant_streams(cfg)
    spec, _, _ = tenant_spec(cfg, streams)
    stream, batches, _ = streams[0]
    del streams
    h = skt.create(spec, device=dev)
    for b in batches:
        h = skt.ingest(spec, h, b)
    cpu = _cpu_handle(h)
    det = skt.HeavyKeyDetector()
    det.update(stream.src, stream.src_label)
    counts = sorted(det.counts.get((s, l), 0) for s, l, _ in
                    spec.routing.splits)
    cut = (counts[0] + 1) / max(det.total, 1)
    pruned = skt.prune_routing(spec.routing, det, cut)
    cases = {"2->4": (4, {}), "2->1": (1, {}),
             "2->4 pruned": (4, dict(detector=det, heat_threshold=cut))}

    def card():
        out = {}
        for name, (m, kw) in cases.items():
            res, sec = _timed(lambda: skt.reshard(spec, h, m, **kw))
            out[name] = (res, sec, dict(RESHARD_SPLIT))
        return out

    names = RESHARD_PATH if dev.type == "cuda" else ()
    got, launches = count_launches(names, card)
    nums = {}
    for name, (m, kw) in cases.items():
        res, sec, split = got[name]
        want, plain_s = _timed(lambda: skt.reshard(spec, cpu, m, **kw))
        differ = _leaves_differ(res, want)
        del want
        _log(f"phase M1 reshard {name} of a {TENANT_SHARDS}-shard tenant "
             f"(d={cfg.d}, {len(stream)} edges, {split['records']} records) "
             f"on the card {sec:.4f} s (decode {split['decode_s']:.4f}, "
             f"claim {split['claim_s']:.4f}, scatter "
             f"{split['scatter_s']:.4f}) vs the plain replay on a CPU copy, "
             f"leaf for leaf: {'equal' if not differ else 'DIFFER ' + str(differ)}"
             f" ({plain_s:.3f} s) {tag}")
        if differ:
            raise AssertionError(f"phase M1: reshard {name} differs from "
                                 f"the plain replay in {differ}")
        nums[name] = dict(card_s=sec, plain_s=plain_s, **split)
    _log(f"phase M1 the prune (threshold {cut:.3g}): routing "
         f"{len(spec.routing.splits)} -> {len(pruned.splits)} split keys; "
         f"launches {launches} {tag}")
    if len(pruned.splits) >= len(spec.routing.splits):
        raise AssertionError("phase M1: the prune removed no split")
    res = {name: got[name][0] for name in cases}
    return launches, nums, h, cpu, spec, batches, res


def merge_deployment(spec, stream, state, routing, dev, tag):
    """Phase M2: phase V's 4-shard state resharded on the card to 4 shards
    under ``budget_report().routing`` and to 2: per-shard occupancy before
    and after, vertex and label answers (last in SERVER_LASTS) equal where
    the reshard drops nothing (else within what it dropped), edge answers
    one-sided against ``GroundTruth``. Returns (launches, numbers)."""
    cfg = spec.config
    qi = query_inputs(cfg, stream)
    kinds = [k for k in KINDS if k != "edge"]

    def answers(st, sp):
        out = {(k, h): skt.query(sp, st, query_batch(qi, k, False, h),
                                 path="cuda").cpu()
               for k in kinds for h in SERVER_LASTS}
        out["edge"] = skt.query(sp, st, query_batch(qi, "edge", False, None),
                                path="cuda").cpu()
        skt.clear_plane_cache(st)
        return out

    before = answers(state, spec)
    occ0 = _occupancy(state)
    lost0 = int(state.live().pool_lost.sum())
    gt = GroundTruth(stream.spec, cfg.k).insert_stream(stream)
    truth = np.array([gt.edge_weight(int(a), int(b))
                      for a, b in zip(qi["src"], qi["dst"])])
    nums, launches, bad, under = {}, {}, 0, 0
    for name, m, rt in (("4->4 routed", 4, routing), ("4->2", 2, None)):
        sp = spec.replace(n_shards=m, routing=rt if rt is not None
                          else spec.routing)
        names = RESHARD_PATH if dev.type == "cuda" else ()
        (res, sec), moved = count_launches(names, lambda: _timed(
            lambda: skt.reshard(spec, state, m, routing=rt)))
        launches = _add_launches(launches, moved)
        split = dict(RESHARD_SPLIT)
        after = answers(res, sp)
        lost = int(res.live().pool_lost.sum())
        added = lost - lost0
        for key, a in after.items():
            if key == "edge":
                est = a.numpy().astype(np.int64)
                under = int((est < truth - lost).sum())
                bad += under
                continue
            b = before[key]
            if added == 0:
                bad += int((a != b).sum())
            else:
                bad += int(((a > b) | (a < b - added)).sum())
        occ = _occupancy(res)
        nums[name] = dict(card_s=sec, occupancy=occ, pool_lost_added=added,
                          edge_under=under, **split)
        _log(f"phase M2 reshard {name} of phase V's state ({split['records']}"
             f" records): {sec:.4f} s on the card = decode "
             f"{split['decode_s']:.4f} + claim {split['claim_s']:.4f} + "
             f"scatter {split['scatter_s']:.4f} s; occupancy before "
             f"{json.dumps(occ0)}, after {json.dumps(occ)}; pool_lost "
             f"added {added}; vertex and label answers at last in "
             f"{list(SERVER_LASTS)} and edge answers vs GroundTruth (est >= "
             f"truth - pool_lost): violations so far {bad} {tag}")
        del res
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"phase M2: {bad} answers break conservation "
                             f"or one-sidedness")
    return launches, dict(cases=nums, occupancy_before=occ0, violations=bad)


def merge_checkpoints(h, cpu, spec, batches, res, dev, tag):
    """Phase M3 (the restores and the GSS reshard counted from 0): M1's
    tenant saved at its shard count and restored at 4 and at 1 (each
    equal to M1's reshard); GSS at GSS_CFG resharded 1 -> 2 against the
    plain replay; LGS at LGS_CFG restored 2 -> 1 (equal to ``merge_all``)
    and 2 -> 3 (the saved shards and an empty one); ``merge_all`` of M1's
    tenant against its CPU copy's and, where ``shards_compatible``, a
    one-shard ingest of the same batches."""
    import tempfile

    stream = generate(dataclasses.replace(COMFS, n_edges=TENANT_EDGES),
                      seed=SEED, weighted=True)
    gspec = skt.make_spec("gss", n_shards=1, config=GSS_CFG)
    lspec = skt.make_spec("lgs", n_shards=2, config=LGS_CFG)
    cuts = list(range(0, len(stream), MAX_FLUSH)) + [len(stream)]
    parts = [stream.slice(a, z) for a, z in zip(cuts[:-1], cuts[1:])]
    g = skt.create(gspec, device=dev)
    lg = skt.create(lspec, device=dev)
    for b in parts:
        g = skt.ingest(gspec, g, b)
        lg = skt.ingest(lspec, lg, b)
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        skt.save(spec, h, f"{tmp}/tenant")
        skt.save(lspec, lg, f"{tmp}/lgs")

        def card():
            out = {m: _timed(lambda: skt.restore(spec.replace(n_shards=m),
                                                 f"{tmp}/tenant",
                                                 device=dev))
                   for m in (4, 1)}
            out["gss"] = _timed(lambda: skt.reshard(gspec, g, 2))
            out["lgs1"] = skt.restore(lspec.replace(n_shards=1),
                                      f"{tmp}/lgs", device=dev)
            out["lgs3"] = skt.restore(lspec.replace(n_shards=3),
                                      f"{tmp}/lgs", device=dev)
            return out

        names = RESHARD_PATH if dev.type == "cuda" else ()
        got, launches = count_launches(names, card)
    for m, name in ((4, "2->4"), (1, "2->1")):
        d = _leaves_differ(got[m][0], res[name])
        if d:
            bad.append((f"restore at {m}", d))
    gplain, gplain_s = _timed(lambda: skt.reshard(gspec, _cpu_handle(g), 2))
    gsplit = dict(RESHARD_SPLIT)
    d = _leaves_differ(got["gss"][0], gplain)
    _log(f"phase M3 gss reshard 1->2 at {GSS_CFG} ({gsplit['records']} "
         f"records, one bin a shard) on the card {got['gss'][1]:.4f} s vs "
         f"the plain replay on a CPU copy, leaf for leaf: "
         f"{'equal' if not d else 'DIFFER ' + str(d)} ({gplain_s:.3f} s) "
         f"{tag}")
    if d:
        bad.append(("gss", d))
    merged = skt.merge_all(lspec, lg)
    one = got["lgs1"].live()
    if not all(torch.equal(x[0], y) for x, y in zip(one.leaves(),
                                                    merged.leaves())):
        bad.append(("lgs 2->1", "differs from merge_all"))
    three = got["lgs3"].live()
    empty = skt.create(lspec.replace(n_shards=1), device=dev).live()
    if not all(torch.equal(x[:2], y) and torch.equal(x[2:], z)
               for x, y, z in zip(three.leaves(), lg.live().leaves(),
                                  empty.leaves())):
        bad.append(("lgs 2->3", "differs from the saved shards + 1 empty"))
    tm, tc = skt.merge_all(spec, h), skt.merge_all(spec, cpu)
    if not all(torch.equal(x.cpu(), y) for x, y in zip(tm.leaves(),
                                                       tc.leaves())):
        bad.append(("merge_all", "card differs from its CPU copy"))
    compatible = bool(skt.shards_compatible(spec, h))
    if compatible:
        one_spec = spec.replace(n_shards=1, routing=None)
        single = skt.create(one_spec, device=dev)
        for b in batches:
            single = skt.ingest(one_spec, single, b)
        if _leaves_differ(skt.ShardedState.lift(tm), single):
            bad.append(("merge_all", "differs from a one-shard ingest"))
    _log(f"phase M3 checkpoints: the tenant saved at {TENANT_SHARDS} shards "
         f"restored at 4 ({got[4][1]:.3f} s) and at 1 ({got[1][1]:.3f} s) "
         f"vs M1's reshards; lgs at {LGS_CFG} restored 2->1 vs merge_all "
         f"and 2->3 vs the saved shards and an empty one; merge_all of the "
         f"tenant vs its CPU copy's; shards_compatible={compatible}"
         f"{' (merge_all vs a one-shard ingest too)' if compatible else ''}"
         f": {'all equal' if not bad else 'DIFFER ' + str(bad)}; launches "
         f"{launches} {tag}")
    if bad:
        raise AssertionError(f"phase M3: {bad}")
    return launches, dict(restore4_s=got[4][1], restore1_s=got[1][1],
                          gss_card_s=got["gss"][1], gss_plain_s=gplain_s,
                          gss_records=gsplit["records"],
                          shards_compatible=compatible)


def merge_phase(stream, served, dev, tag):
    """Phase M: M1 (a tenant resharded on the card vs the plain replay),
    M2 (phase V's state resharded: conservation and one-sidedness) and M3
    (restores across shard counts, GSS, LGS and ``merge_all``). Returns
    (the launches of the reshard path, summed over its counted runs, and
    the numbers)."""
    state, live, routing = served
    l1, m1, h, cpu, tspec, batches, res = merge_tenant(dev, tag)
    l3, m3 = merge_checkpoints(h, cpu, tspec, batches, res, dev, tag)
    del h, cpu, res
    torch.cuda.empty_cache()
    l2, m2 = merge_deployment(live, stream, state, routing, dev, tag)
    launches = _add_launches(_add_launches(l1, l2), l3)
    return launches, dict(m1=m1, m2=m2, m3=m3, launches=launches,
                          m2_violations=m2["violations"])


def deployment():
    """The spec, the seeded stream and its flushes ``[(a, z)]``, with the
    index of the boundary-spanning flush."""
    spec = skt.make_spec("lsketch", n_shards=N_SHARDS, config=CFG)
    stream = generate(dataclasses.replace(COMFS, n_edges=N_EDGES), seed=SEED,
                      weighted=True)
    cuts, span_i = flush_cuts(stream.time, CFG.subwindow_size)
    return spec, stream, list(zip(cuts[:-1], cuts[1:])), span_i


def _row_paths(name: str) -> tuple:
    """The paths of phases V, M and C whose launches a kernel row counts:
    the grouped entries on the pool-mode server, the single-sketch entries
    in ``BigramSketch``, the sharded query kernels on the single-handle
    server and the collective path, and the write path and the decode on
    every server path, the reshard and the collective path."""
    if name in GROUPED_KERNELS:
        return ("server_pool",)
    if name in OBJECT_KERNELS:
        return ("bigram",)
    if name in ("sketch_query_kernel_sharded", "vertex_scan_kernel_sharded"):
        return ("server", "collective")
    if name in ("flash_attention_kernel", "flash_attention_backward_kernel"):
        return ()
    return ("server", "server_pool", "reshard", "collective")


def kernel_entries(results: dict, launches: dict,
                   new_paths: dict | None = None,
                   train_paths: dict | None = None) -> list:
    """The ``kernels`` list of the JSON line. Each bound is the larger of
    the bytes the check counted over HBM_BYTES_PER_S and the time of the
    operations it counted, where it counted any (``ops_ms``, at the rate
    ``ops_rate`` names); ``library_ms`` is null where no single PyTorch
    call computes the kernel's function. ``launches_new_paths`` gives each
    row's wrapper launches on the paths of phases V and M
    (``_row_paths``), ``launches_train`` on the training paths of L8 and
    L9."""
    out = []
    for kname, r in results.items():
        bytes_ms = 1e3 * r["nbytes"] / HBM_BYTES_PER_S
        ops_ms = r.get("ops_ms", 0.0)
        wrapper = GROUPED_KERNELS.get(kname, OBJECT_KERNELS.get(kname, kname))
        out.append(dict(
            name=kname, route="cuda", **KERNELS[kname],
            launches=launches[kname],
            **{k: v for k, v in r.items()
               if k not in ("nbytes", "ops_ms", "library_ms")},
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="operations" if ops_ms > bytes_ms else "bytes",
            library_ms=r.get("library_ms"),
            launches_new_paths={p: new_paths[p][wrapper]
                                for p in _row_paths(kname)}
            if new_paths else {},
            launches_train={p: n[wrapper] for p, n in train_paths.items()}
            if train_paths else {}))
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
    flash_build, flash_bwd_build = flash_build_report()

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
    p4 = _pool_use(state)  # beside phase R's
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

    c_launches, collective_out = collective_phase(  # phase C
        spec, stream, flushes, state, qi, answers, got, edges_per_s, dev,
        tag)
    torch.cuda.empty_cache()

    profile = profile_ingest(spec, state, stream, flushes, tag)
    del state  # phases S, O and the LM phases start from an empty card
    torch.cuda.empty_cache()

    stream_out = stream_phase(cfg, spec, dev, tag)  # phase S
    torch.cuda.empty_cache()

    r_launches, route_out = route_phase(cfg, spec, stream, flushes, p4, dev,
                                        tag)  # phase R
    route_out["launches"] = r_launches
    torch.cuda.empty_cache()

    t_rows, t_launches, tenant_out = tenant_phase(dev, tag)  # phase T
    results.update(t_rows)
    launches.update({k: t_launches[w] for k, w in GROUPED_KERNELS.items()})
    tenant_out["launches"] = t_launches
    torch.cuda.empty_cache()

    v_launches, server_out, served = server_phase(
        spec, stream, flushes, dev, tag)  # phase V
    m_launches, merge_out = merge_phase(stream, served, dev, tag)  # phase M
    del served
    torch.cuda.empty_cache()
    new_paths = dict(v_launches, reshard=m_launches, collective=c_launches)

    obj_rows, o_launches, obj_out = object_phase(dev, tag)  # phase O
    results.update(obj_rows)
    launches.update({k: o_launches[w] for k, w in OBJECT_KERNELS.items()})
    torch.cuda.empty_cache()

    with torch.no_grad():  # serving: L1-L6 build no graph
        results.update(check_flash_kernel(dev, tag))  # L1
        results["flash_attention_kernel"]["build"] = flash_build
        cfg_lm, params = lm_model(dev, tag)  # L2
        lm_out, tokens, head = prefill_phase(cfg_lm, params, dev, tag)
        check_prefill_on_the_card(cfg_lm, lm_out)
        launches["flash_attention_kernel"] = lm_out["prefill_flash_launches"]
        lm_out.update(serve_phase(cfg_lm, params, tokens, head, dev,
                                  tag))  # L3
        del params, head
        torch.cuda.empty_cache()
        arch_out, arch_launches = arch_phases(dev, tag)  # L4-L6
    results["flash_attention_kernel"]["launches_lm_archs"] = arch_launches

    results.update(check_flash_backward(  # L7
        dev, tag, results["flash_attention_kernel"]["ms"]))
    results["flash_attention_backward_kernel"]["build"] = flash_bwd_build
    train_out = train_phase(dev, tag)  # L8
    check_train_on_the_card(configs.get(TRAIN_ARCH, reduced=LM_REDUCED),
                            train_out)
    launches["flash_attention_backward_kernel"] = \
        train_out["flash_backward_launches"]
    moe_out = moe_train_phase(dev, tag)  # L9
    check_moe_train_on_the_card(moe_out)
    sharded_out = sharded_train_phase(dev, tag, train_out)  # L10
    check_sharded_train_on_the_card(
        configs.get(TRAIN_ARCH, reduced=LM_REDUCED), sharded_out)
    restart_out = restart_phase(dev, tag, train_out)  # L11
    check_restart_on_the_card(configs.get(TRAIN_ARCH, reduced=LM_REDUCED),
                              restart_out)
    tp_out = tp_phase(dev, tag)  # L12
    check_tp_on_the_card(configs.get(TRAIN_ARCH, reduced=LM_REDUCED), tp_out)
    tp_rows = check_flash_tp_rows(dev, tag)  # L12's shapes against plain
    results["flash_attention_kernel"]["cases"] += tp_rows["forward"]
    results["flash_attention_backward_kernel"]["cases"] += tp_rows["backward"]
    serve_out = serve_tp_phase(dev, tag)  # L13
    check_serve_tp_on_the_card(serve_out)
    results["flash_attention_kernel"]["cases"] += check_flash_serve_rows(
        dev, tag, serve_out["a"]["prefill"]["flash_call_shapes"])
    estimate_out = estimate_phase(train_out, lm_out, tag, tp_out,
                                  serve_out)  # E1
    train_paths = {"L8": train_out["launches"], "L9": moe_out["launches"],
                   "L10": sharded_out["launches"],
                   "L11": restart_out["launches"],
                   "L12": tp_out["launches"], "L13": serve_out["launches"]}

    seconds = time.perf_counter() - t_start
    _log(f"total {seconds:.1f} s")
    print(json.dumps({"kernels": kernel_entries(results, launches,
                                                new_paths, train_paths),
                      "card": card, "peak_memory_bytes": peak,
                      "analytics_peak_memory_bytes": a_peak,
                      "ingest_edges_per_s": edges_per_s,
                      "ingest_kernel_route_edges_per_s": kernel_edges_per_s,
                      "stream": stream_out, "route": route_out,
                      "tenant": tenant_out, "server": server_out,
                      "merge": merge_out, "object": obj_out,
                      "collective": collective_out,
                      **profile, **lm_out, "archs": arch_out,
                      "train": train_out, "moe_train": moe_out,
                      "sharded_train": sharded_out,
                      "restart": restart_out, "tensor_parallel": tp_out,
                      "sharded_serving": serve_out,
                      "estimate": estimate_out,
                      "seconds": seconds}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
