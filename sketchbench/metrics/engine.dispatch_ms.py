"""Mean host milliseconds of an ingest's stacked insert in the profiled
part (``lsketch.ingest.dispatch``: the staging copy of the partitioned
columns to the device, the engine's stages, the plane delta's hand-over),
its waits on the device included."""

from sketchbench.metrics import _ranges


def read(obs):
    return _ranges.mean_ms(obs, "lsketch.ingest.dispatch")
