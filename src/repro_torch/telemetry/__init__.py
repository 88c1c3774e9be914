"""repro_torch.telemetry — host-side counters and stream statistics of
the port, the MoE router telemetry (``RouterTelemetry``,
``CapacityController``) and the profiler ranges of the program's stages
(``spans.span``).

The package's names load on first use: the engine and the kernels'
wrappers import ``telemetry.spans`` while the sketch package, which the
router telemetry imports, is still loading."""

import importlib

_HOMES = {"CapacityController": "router_sketch",
          "RouterTelemetry": "router_sketch",
          "PARTITION_STATS": "stream_stats",
          "BigramSketch": "stream_stats",
          "PartitionLoadStats": "stream_stats"}

__all__ = sorted(_HOMES)


def __getattr__(name):
    if name not in _HOMES:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f".{_HOMES[name]}", __name__),
                   name)
