"""Host milliseconds inside the engine's ``lsketch.*`` ranges per engine
flush (a ``lsketch.window_plan`` range each), in the profiled part."""


def read(obs):
    if obs.trace is None:
        return None
    ranges = obs.trace["host_ranges"]
    n = len(ranges.get("lsketch.window_plan", ()))
    if not n:
        return None
    tot = sum(b - a for name, spans in ranges.items()
              if name.startswith("lsketch.") for a, b in spans)
    return 1e3 * tot / n
