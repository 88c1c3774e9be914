"""Serving loop: continuous batched decode with KV caches (counterpart
of ``repro.launch.serve``).

A request queue feeds a fixed-size decode batch; finished slots are
refilled (continuous batching); per-slot KV caches live on the device and
are updated in place. Sampling is greedy or by temperature, on the host,
from ``numpy.random.default_rng(seed)``.

Usage: python -m repro_torch.launch.serve --arch smollm-135m --requests 8
       [--device cpu]
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

import repro_torch.configs as configs
from repro_torch.core.types import resolve_device
from repro_torch.models import lm


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    pending: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeServer:
    def __init__(self, cfg, params, batch_slots: int = 4,
                 max_seq: int = 256, temperature: float = 0.0, seed: int = 0,
                 device=None):
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
        self.caches = lm.init_cache(cfg, self.B, self.S, self.device)
        self.slots: List[Optional[Request]] = [None] * self.B
        self.tokens = np.zeros((self.B, 1), np.int32)
        self._step = lambda p, c, t: lm.serve_step(cfg, p, c, t)

    def _reset_slot(self, i: int):
        """Zero slot i's cache state (every leaf indexed by batch)."""
        for cache in self.caches:
            for x in cache["mixer"].values():
                x[i].zero_()

    def submit(self, req: Request) -> bool:
        """Claim a free slot; the prompt streams through subsequent steps
        (continuous batching: other slots keep decoding meanwhile)."""
        for i, s in enumerate(self.slots):
            if s is None:
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
