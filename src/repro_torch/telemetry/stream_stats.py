"""Stream statistics (port of ``repro.telemetry.stream_stats``:
``PartitionLoadStats``, ``PARTITION_STATS`` and ``BigramSketch``).

``sketch.ingest._partition_stack`` records every round's shard counts and
pad bucket in the process-wide ``PARTITION_STATS``: the counter that shows
what skew costs a stacked dispatch and what routing wins back.
``BigramSketch`` sketches a corpus's token-bigram stream (data-quality
monitoring: heavy bigrams, band volumes, windowed drift).
"""

from __future__ import annotations

import threading

import numpy as np

from repro_torch.core import EdgeBatch, LSketch, LSketchConfig, insert_batch
from repro_torch.data.tokens import (DEFAULT_BAND_VOCAB, bigram_stream,
                                     token_band)


class PartitionLoadStats:
    """Per-shard load-imbalance counters over ingest partition rounds.

    Each round contributes its shard counts and pad bucket ``L``:

      * ``max_fill`` / ``mean_fill`` — hottest / average shard count as a
        fraction of the bucket every shard pads to;
      * ``pad_ratio`` — fraction of dispatched rows that are padding
        (``1 - sum(counts) / (n_shards * L)``);
      * ``imbalance`` — max/mean shard count (1.0 = level).

    ``snapshot()`` averages over the rounds since the last ``reset()``.
    Thread-safe.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.rounds = 0
            self._max_fill = 0.0
            self._mean_fill = 0.0
            self._pad_ratio = 0.0
            self._imbalance = 0.0

    def record(self, counts, bucket: int) -> None:
        counts = np.asarray(counts, np.float64)
        n_sh = counts.shape[0]
        mx, mean = float(counts.max()), float(counts.mean())
        with self._lock:
            self.rounds += 1
            self._max_fill += mx / bucket
            self._mean_fill += mean / bucket
            self._pad_ratio += 1.0 - float(counts.sum()) / (n_sh * bucket)
            self._imbalance += mx / max(mean, 1e-9)

    def snapshot(self) -> dict:
        with self._lock:
            n = max(self.rounds, 1)
            return {"rounds": self.rounds,
                    "max_fill": self._max_fill / n,
                    "mean_fill": self._mean_fill / n,
                    "pad_ratio": self._pad_ratio / n,
                    "imbalance": self._imbalance / n}


PARTITION_STATS = PartitionLoadStats()


class BigramSketch:
    """The token-bigram stream of a corpus in one ``LSketch`` (port of
    ``repro.telemetry.stream_stats.BigramSketch``): heavy bigrams, per-band
    volumes and windowed drift. Vertices are tokens labelled by frequency
    band (``data.tokens.token_band`` on a fixed vocab reference, the same
    function on both sides), edges labelled by position bucket; a call of
    ``ingest_tokens`` is one time step. The sketch lives on ``device``
    (the card unless the caller names the CPU)."""

    def __init__(self, window_steps: int = 64, subwindows: int = 8,
                 d: int = 256, n_bands: int = 4,
                 vocab_size: int = DEFAULT_BAND_VOCAB, device=None):
        self.n_bands = n_bands
        self.vocab_size = vocab_size
        self.cfg = LSketchConfig(
            d=d, n_blocks=n_bands, F=1024, r=4, s=8, c=8, k=subwindows,
            window_size=window_steps, pool_capacity=8192, seed=77)
        self.sketch = LSketch(self.cfg, device=device)
        self._step = 0

    def ingest_tokens(self, tokens: np.ndarray, step: int | None = None):
        st = bigram_stream(tokens, n_bands=self.n_bands,
                           vocab_size=self.vocab_size)
        t = self._step if step is None else step
        batch = EdgeBatch(
            src=st["src"], dst=st["dst"], src_label=st["src_label"],
            dst_label=st["dst_label"], edge_label=st["edge_label"],
            weight=st["weight"],
            time=np.full(len(st["src"]), t, np.int32))
        self.sketch.state = insert_batch(self.cfg, self.sketch.state, batch)
        self._step = t + 1
        return self

    def bigram_weight(self, a: int, b: int, last=None) -> int:
        # the query-side band must be the ingest side's: one function on
        # the fixed vocab reference
        band = lambda t: int(token_band(t, self.n_bands, self.vocab_size))  # noqa: E731
        return self.sketch.edge_weight(a, band(a), b, band(b), last=last)

    def band_volume(self, band: int, last=None) -> int:
        return self.sketch.label_aggregate(band, last=last)

    def drift(self, band: int, recent: int = 2) -> float:
        """Recent-vs-window volume ratio for a band (1.0 = stationary)."""
        whole = self.band_volume(band)
        if whole == 0:
            return 1.0
        rec = self.band_volume(band, last=recent)
        expected = whole * recent / self.cfg.k
        return float(rec / max(expected, 1e-9))
