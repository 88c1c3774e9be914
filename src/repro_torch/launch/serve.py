"""Serving loop: continuous batched decode with KV caches (counterpart
of ``repro.launch.serve``).

A request queue feeds a fixed-size decode batch; finished slots are
refilled (continuous batching); per-slot caches (KV, ring buffers, MLA's
compressed cache, recurrent states) live on the device and are updated in
place. Sampling is greedy or by temperature, on the host, from
``numpy.random.default_rng(seed)``. For an encoder-decoder each request
carries its frame embeddings (``Request.frame_emb``), encoded once when
the request takes its slot into that slot's row of the memory every step
reads; the JAX server has no such input.

With ``mesh`` (a ``DeviceMesh`` over every rank of the group, each rank
running the same server on the same requests), the server is the
reference's jitted one on placed inputs: the parameters come from
``step_fns.shard_params``, the caches rest sharded
(``step_fns.shard_caches``), each data rank decodes its block of the
slots (all of them, the caches' sequence split over "data", where the
slots do not divide the data ranks) through
``step_fns.make_sharded_serve_step``, and every rank samples from the
logits of every slot, gathered over "data".

Usage: python -m repro_torch.launch.serve --arch smollm-135m --requests 8
       [--device cpu]   (any of ``configs.ARCHS``, reduced; an
       encoder-decoder's requests get seeded frame embeddings)
       python -m repro_torch.launch.serve --mode sketch [serve_sketch flags]
(on the card unless ``--device cpu``; ``--mode sketch`` hands every other
flag to the graph-stream server, ``launch/serve_sketch.py``.)
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding_ctx import ShardingCtx
from repro_torch.launch import step_fns
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models import lm

CLI_FRAMES = 16  # frames a request of the CLI gives an encoder-decoder


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    pending: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    frame_emb: Optional[np.ndarray] = None  # [Se, D]: encoder-decoder only


class DecodeServer:
    def __init__(self, cfg, params, batch_slots: int = 4,
                 max_seq: int = 256, temperature: float = 0.0, seed: int = 0,
                 device=None, mesh=None):
        # "cuda" names the current card: compare as tensors place it
        self.device = torch.empty(0, device=resolve_device(device)).device
        if params.device != self.device:
            raise ValueError(f"parameters lie on {params.device}, the server "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.S = max_seq
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)
        self.mesh = mesh
        self.rows = range(self.B)  # the slots this rank decodes
        if mesh is None:
            self.caches = lm.init_cache(cfg, self.B, self.S, self.device)
        else:
            self.caches = step_fns.shard_caches(
                cfg, step_fns.cache_specs(cfg, self.B, self.S), mesh)
            self._sharded = step_fns.make_sharded_serve_step(cfg, mesh)
            ctx = ShardingCtx(mesh)
            self._data = ctx.group("data"), mesh_shape(mesh)["data"]
            n = self._data[1]
            if self.B % n == 0:
                a = ctx.coordinate("data") * (self.B // n)
                self.rows = range(a, a + self.B // n)
        self.slots: List[Optional[Request]] = [None] * self.B
        self.tokens = np.zeros((self.B, 1), np.int32)
        self.memory = None  # encoder-decoder: [B, Se, D] on the device

    def _step(self, params, caches, tokens):
        if self.mesh is None:
            return lm.serve_step(self.cfg, params, caches, tokens,
                                 memory=self.memory)
        rows = slice(self.rows.start, self.rows.stop)
        logits, caches = self._sharded(params, caches, tokens[rows],
                                       self.memory)
        if len(self.rows) < self.B:  # every slot's logits on every rank
            parts = [torch.empty_like(logits) for _ in range(self._data[1])]
            dist.all_gather(parts, logits.contiguous(), group=self._data[0])
            logits = torch.cat(parts)
        return logits, caches

    def _reset_slot(self, i: int):
        """Zero slot i's cache state (every leaf indexed by batch), where
        this rank holds that slot's row."""
        if i not in self.rows:
            return
        for cache in self.caches:
            for x in cache["mixer"].values():
                x = x if self.mesh is None else x.to_local()
                x[i - self.rows.start].zero_()

    def _encode(self, i: int, req: Request):
        """Encoder-decoder: the request's frames through the encoder, into
        memory row i (every request of a server has one frame count)."""
        if not self.cfg.is_encdec:
            if req.frame_emb is not None:
                raise ValueError(f"{self.cfg.name} takes no frame_emb")
            return
        if req.frame_emb is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: each "
                             f"request needs frame_emb [Se, D]")
        frames = torch.as_tensor(np.asarray(req.frame_emb, np.float32),
                                 device=self.device)[None]
        with torch.no_grad():
            mem = lm.encode_memory(self.cfg, self.params, frames) \
                if self.mesh is None else step_fns.sharded_encode_memory(
                    self.cfg, self.mesh, self.params, frames)
        if self.memory is None:
            self.memory = torch.zeros((len(self.rows),) + mem.shape[1:],
                                      dtype=mem.dtype, device=self.device)
        if mem.shape[1:] != self.memory.shape[1:]:
            raise ValueError(f"frame_emb of {mem.shape[1]} frames; this "
                             f"server's requests have "
                             f"{self.memory.shape[1]}")
        if i in self.rows:
            self.memory[i - self.rows.start] = mem[0]

    def submit(self, req: Request) -> bool:
        """Claim a free slot; the prompt streams through subsequent steps
        (continuous batching: other slots keep decoding meanwhile)."""
        for i, s in enumerate(self.slots):
            if s is None:
                self._encode(i, req)
                self.slots[i] = req
                self._reset_slot(i)
                req.pending = list(req.prompt)
                self.tokens[i, 0] = req.pending.pop(0)
                return True
        return False

    def step(self):
        """One fused decode step for every slot. Slots still consuming
        their prompt feed the next prompt token (logits discarded); slots
        in decode phase sample and append."""
        logits, self.caches = self._step(
            self.params, self.caches,
            torch.from_numpy(self.tokens).to(self.device))
        logits = logits[:, 0].float().cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            if req.pending:  # prompt phase
                self.tokens[i, 0] = req.pending.pop(0)
                continue
            if self.temperature > 0:
                p = np.exp(logits[i] / self.temperature)
                p /= p.sum()
                nxt = int(self.rng.choice(len(p), p=p))
            else:
                nxt = int(np.argmax(logits[i]))
            req.out.append(nxt)
            self.tokens[i, 0] = nxt
            if len(req.out) >= req.max_new:
                req.done = True
                self.slots[i] = None

    def run(self, requests: List[Request], max_steps: int = 4096):
        pending = list(requests)
        for _ in range(max_steps):
            while pending and self.submit(pending[0]):
                pending.pop(0)
            live = [r for r in self.slots if r is not None]
            if not live and not pending:
                break
            self.step()
        return requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="lm", choices=["lm", "sketch"])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=None,
                    help="lm default: 4; sketch default: serve_sketch's own")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args, rest = ap.parse_known_args(argv)
    if args.mode == "sketch":
        from .serve_sketch import main as sketch_main
        if args.requests is not None:
            rest += ["--requests", str(args.requests)]
        if args.device is not None:
            rest += ["--device", args.device]
        sketch_main(rest)
        return
    if args.requests is None:
        args.requests = 4
    if rest:  # unknown flags are only forwarded in sketch mode
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, reduced=True)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    server = DecodeServer(cfg, params, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=list(rng.integers(0, cfg.vocab_size, 8)),
                    max_new=args.max_new) for _ in range(args.requests)]
    if cfg.is_encdec:  # stub frontend: seeded frame embeddings
        for r in reqs:
            r.frame_emb = rng.standard_normal(
                (CLI_FRAMES, cfg.d_model)).astype(np.float32)
    t0 = time.time()
    server.run(reqs)
    dt = time.time() - t0
    tok = sum(len(r.out) for r in reqs)
    print(f"decoded {tok} tokens for {len(reqs)} requests "
          f"in {dt:.2f}s ({tok/dt:.1f} tok/s) on {dev}")
    for i, r in enumerate(reqs):
        print(f"  req{i}: {r.out[:8]}...")


if __name__ == "__main__":
    main()
