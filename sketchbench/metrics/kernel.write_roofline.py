"""The insert and pool-pass kernels' share of their bandwidth bound: the
bytes of every launch in the profiled part (``_bytes.write_bytes``) over
3.35 TB/s, divided by the kernels' device seconds in the trace."""

from sketchbench.metrics import _bytes

KERNELS = ("lsk_insert", "lsk_pool")


def read(obs):
    if obs.trace is None or not obs.captures.get("insert"):
        return None
    dev = sum(s for name, s in obs.trace["device_s"].items()
              if name.startswith(KERNELS))
    return _bytes.share(_bytes.write_bytes(
        obs.cfg, obs.captures, obs.key_later, obs.pool_key_before,
        obs.pool_key_after), dev)
