"""Mean host milliseconds of a batch's hash partition in the profiled
part (``lsketch.ingest.partition``)."""

from sketchbench.metrics import _ranges


def read(obs):
    return _ranges.mean_ms(obs, "lsketch.ingest.partition")
