"""Percent of the profiled part's idle device time that no stage below
the server's entry points explains: the ``breakdown.idle_gaps`` seconds
named by the harness's ranges (``sketchbench.*``), by no range
(``host``) or by a server call's own time (``lsketch.server.flush``,
``lsketch.server.ingest``), over ``window_s - busy_s``. ``idle_gaps``
holds the ten names with the most idle time, so a name it leaves out
holds less than its tenth. Nothing where the trace saw no device
operation."""

OWN = ("host", "lsketch.server.flush", "lsketch.server.ingest")


def read(obs):
    t = obs.trace
    if t is None or t["busy_s"] <= 0 or t["window_s"] <= t["busy_s"]:
        return None
    own = sum(s for name, s in t["breakdown"]["idle_gaps"]
              if name in OWN or name.startswith("sketchbench."))
    return 100.0 * own / (t["window_s"] - t["busy_s"])
