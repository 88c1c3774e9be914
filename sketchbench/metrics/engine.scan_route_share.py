"""Percent of the window's ingested edges that took the engine's scan
route (``engine.insert.ROUTE_EDGES``); batches cut at subwindow
boundaries keep it 0, and this guards that."""


def read(obs):
    k, s = obs.counters.get("route_kernel", 0), obs.counters.get(
        "route_scan", 0)
    return 100.0 * s / (k + s) if k + s else None
