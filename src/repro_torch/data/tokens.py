"""Deterministic, resumable LM token pipeline (port of
``repro.data.tokens``; numpy, as the reference's, copied so that the port
imports nothing of ``repro``).

Production shape without external deps: an infinite synthetic corpus
(seeded Zipf unigram + Markov bigram structure so models have learnable
signal), sharded by (host, data-parallel rank), cursor-resumable (the
checkpoint stores ``cursor`` and the stream continues exactly), with
double-buffered prefetch.

The bigram chain is also the *graph stream* LSketch summarizes in the
telemetry integration: (prev_token -> token) edges labeled by frequency
band (``telemetry.stream_stats.BigramSketch``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    batch_size: int  # per-host batch
    seq_len: int
    seed: int = 0
    n_shards: int = 1
    shard_id: int = 0
    zipf_a: float = 1.1
    markov_strength: float = 0.7  # P(next token from bigram table)
    n_bigram_states: int = 4096


def zipf_unigram(vocab_size: int, a: float) -> np.ndarray:
    """Normalized Zipf(a) unigram over ``vocab_size`` ranks (rank 1 is the
    head). The one power-law both the synthetic corpus and the skewed
    ingest benchmarks sample from — at ``a=1.5`` the head rank alone
    carries ~39% of the stream, the heavy-key regime the skew-aware
    shard routing targets."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = ranks ** -a
    return p / p.sum()


class SyntheticCorpus:
    """Seeded infinite corpus; position-addressable => exactly resumable."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # stationary zipf unigram
        self.unigram = zipf_unigram(V, cfg.zipf_a)
        # bigram table: each state prefers a small successor set
        S = min(cfg.n_bigram_states, V)
        self.succ = rng.integers(0, V, size=(S, 8)).astype(np.int32)
        self.n_states = S

    def batch_at(self, cursor: int) -> np.ndarray:
        """[batch, seq+1] tokens for a global cursor (deterministic)."""
        cfg = self.cfg
        out = np.empty((cfg.batch_size, cfg.seq_len + 1), np.int32)
        for b in range(cfg.batch_size):
            seq_id = cursor * cfg.n_shards * cfg.batch_size \
                + cfg.shard_id * cfg.batch_size + b
            rng = np.random.default_rng((cfg.seed, seq_id))
            toks = rng.choice(len(self.unigram), size=cfg.seq_len + 1,
                              p=self.unigram).astype(np.int32)
            use_bigram = rng.random(cfg.seq_len) < cfg.markov_strength
            pick = rng.integers(0, self.succ.shape[1], cfg.seq_len)
            for t in range(1, cfg.seq_len + 1):
                if use_bigram[t - 1]:
                    state = toks[t - 1] % self.n_states
                    toks[t] = self.succ[state, pick[t - 1]]
            out[b] = toks
        return out


class TokenPipeline:
    """Double-buffered prefetching iterator with an exact cursor."""

    def __init__(self, cfg: TokenPipelineConfig, cursor: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        self.cursor = cursor
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        c = self.cursor
        while not self._stop.is_set():
            toks = self.corpus.batch_at(c)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                     "cursor": c}
            try:
                self._q.put(batch, timeout=0.5)
                c += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = self._q.get()
        self.cursor = batch["cursor"] + 1
        return batch

    def close(self):
        self._stop.set()

    def state(self) -> dict:
        return {"cursor": self.cursor}


# fixed vocab reference for frequency banding when the caller has no
# pipeline config in hand (GPT-2-family vocab width)
DEFAULT_BAND_VOCAB = 50304


def token_band(t, n_bands: int, vocab_size: int) -> np.ndarray:
    """Frequency band of a token id against a *fixed* vocab reference.

    The one banding function shared by ``bigram_stream`` ingest and
    ``BigramSketch.bigram_weight`` queries: both sides must derive the
    identical vertex label or edge-weight telemetry probes the wrong rows.
    Keyed on ``vocab_size`` — never on a per-batch ``tokens.max()``, which
    would make a token's band drift with whatever else shared its batch.
    Log-spaced: band = floor(log1p(t) / log1p(vocab) * n_bands), clipped.
    Accepts scalars or arrays; returns int32.
    """
    t = np.asarray(t)
    raw = (np.log1p(t.astype(np.float64)) / np.log1p(float(vocab_size))
           * n_bands).astype(np.int32)
    return np.minimum(np.int32(n_bands - 1), raw).astype(np.int32)


def bigram_stream(tokens: np.ndarray, n_bands: int = 4,
                  vocab_size: int = DEFAULT_BAND_VOCAB):
    """Token bigrams as a labeled graph stream (telemetry for dense LMs):
    vertices = tokens, vertex label = frequency band (``token_band`` on the
    fixed ``vocab_size`` reference), edge label = position bucket. Returns
    dict of stream arrays."""
    flat = tokens.reshape(-1)
    src, dst = flat[:-1], flat[1:]
    pos = np.arange(len(src), dtype=np.int32)
    return {
        "src": src.astype(np.int32), "dst": dst.astype(np.int32),
        "src_label": token_band(src, n_bands, vocab_size),
        "dst_label": token_band(dst, n_bands, vocab_size),
        "edge_label": (pos % 8).astype(np.int32),
        "weight": np.ones(len(src), np.int32),
        "time": (pos // max(1, len(src) // 64)).astype(np.int32),
    }
