"""Mean host milliseconds of one flush delta folded into the cached
planes in the profiled part (``lsketch.planes.fold``, one link), its
device read included."""

from sketchbench.metrics import _ranges


def read(obs):
    return _ranges.mean_ms(obs, "lsketch.planes.fold")
