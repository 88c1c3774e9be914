"""repro_torch.telemetry — host-side counters and stream statistics of
the port, and the MoE router telemetry (``RouterTelemetry``,
``CapacityController``)."""

from .router_sketch import CapacityController, RouterTelemetry
from .stream_stats import PARTITION_STATS, BigramSketch, PartitionLoadStats

__all__ = ["PARTITION_STATS", "BigramSketch", "CapacityController",
           "PartitionLoadStats", "RouterTelemetry"]
