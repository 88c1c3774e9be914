"""The program's host ranges in the profiled part (``trace.reduce``'s
``host_ranges``: name -> (start, end) seconds), as the span readers take
them. A range's duration holds the device reads it waits on."""


def spans(obs, name: str) -> list:
    """The ranges named ``name``; empty without a trace, and where the
    program marks no such range."""
    if obs.trace is None:
        return []
    return obs.trace["host_ranges"].get(name, [])


def mean_ms(obs, name: str):
    """Mean milliseconds of the ranges named ``name``, or None where there
    is none."""
    got = spans(obs, name)
    return 1e3 * sum(b - a for a, b in got) / len(got) if got else None
