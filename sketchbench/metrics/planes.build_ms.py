"""Mean host milliseconds of one plane build in the profiled part
(``lsketch.planes.build``), its device reads included."""

from sketchbench.metrics import _ranges


def read(obs):
    return _ranges.mean_ms(obs, "lsketch.planes.build")
