"""Percent of the profiled part in which no operation ran on the device
(1 - the union of the trace's device intervals over the part's wall
seconds); nothing where the trace saw no device operation."""


def read(obs):
    if obs.trace is None or obs.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - obs.trace["busy_s"] / obs.trace["window_s"])
