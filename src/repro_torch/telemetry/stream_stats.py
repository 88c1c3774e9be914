"""Shard-load counters of the ingest partition (port of
``repro.telemetry.stream_stats``: ``PartitionLoadStats`` and
``PARTITION_STATS``; numpy, as the reference's).

``sketch.ingest._partition_stack`` records every round's shard counts and
pad bucket in the process-wide ``PARTITION_STATS``: the counter that shows
what skew costs a stacked dispatch and what routing wins back.
"""

from __future__ import annotations

import threading

import numpy as np


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
