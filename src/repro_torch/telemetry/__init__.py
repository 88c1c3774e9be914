"""repro_torch.telemetry — host-side counters and stream statistics of
the port."""

from .stream_stats import PARTITION_STATS, BigramSketch, PartitionLoadStats

__all__ = ["PARTITION_STATS", "BigramSketch", "PartitionLoadStats"]
