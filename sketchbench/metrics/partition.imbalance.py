"""Largest over mean shard fill of the window's partition rounds
(``telemetry.stream_stats.PARTITION_STATS``, averaged over the rounds)."""


def read(obs):
    snap = obs.counters.get("partition")
    if not snap or not snap.get("rounds"):
        return None
    return snap["imbalance"]
