"""Plane builds as a percentage of the plane-cache misses the window
served (``sketch.PLANES_BUILD_COUNTS``: builds / (builds + delta
folds))."""


def read(obs):
    b, f = obs.counters.get("planes_build", 0), obs.counters.get(
        "planes_delta", 0)
    return 100.0 * b / (b + f) if b + f else None
