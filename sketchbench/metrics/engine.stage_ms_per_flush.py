"""Host milliseconds inside the engine's seven stage ranges per engine
flush (a ``lsketch.window_plan`` range each), in the profiled part. The
stages do not nest in one another; ``engine.host_ms_per_flush`` sums
every ``lsketch.*`` range, the server's, the ingest's and the plane
cache's around them too."""

from sketchbench.metrics import _ranges

STAGES = tuple("lsketch." + s for s in (
    "window_plan", "addressing", "bin_plan", "insert_kernel", "pool_pass",
    "scan_insert", "planes_delta"))


def read(obs):
    n = len(_ranges.spans(obs, "lsketch.window_plan"))
    if not n:
        return None
    return 1e3 * sum(b - a for name in STAGES
                     for a, b in _ranges.spans(obs, name)) / n
