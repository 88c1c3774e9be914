"""Request groups per server flush in the profiled part: the
``lsketch.server.group`` ranges over the ``lsketch.server.flush`` ranges
(one batched query dispatch a group)."""

from sketchbench.metrics import _ranges


def read(obs):
    flushes = len(_ranges.spans(obs, "lsketch.server.flush"))
    if not flushes:
        return None
    return len(_ranges.spans(obs, "lsketch.server.group")) / flushes
