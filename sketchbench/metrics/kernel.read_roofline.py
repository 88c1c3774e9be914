"""The edge-probe and vertex-scan kernels' share of their bandwidth
bound: the bytes of every launch in the profiled part (each group of a
grouped launch counted apart; ``_bytes.read_bytes``) over 3.35 TB/s,
divided by the kernels' device seconds in the trace."""

from sketchbench.metrics import _bytes

KERNELS = ("lsk_probe", "lsk_scan")


def read(obs):
    if obs.trace is None or not (obs.captures.get("probe") or
                                 obs.captures.get("scan")):
        return None
    dev = sum(s for name, s in obs.trace["device_s"].items()
              if name.startswith(KERNELS))
    return _bytes.share(_bytes.read_bytes(obs.cfg, obs.captures,
                                          obs.pool_key_after), dev)
