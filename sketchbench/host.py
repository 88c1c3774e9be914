"""What the host did while the window ran, read from ``/proc`` and
``/sys`` and the process's own resource use: one log line a run, so that
runs that read apart can be told apart by their host (the machine's CPU
shares, steal included, its clock, the process's page faults, context
switches and CPU seconds, and where its CPUs, memory and card sit)."""

from __future__ import annotations

import os
import resource
import time

STAT = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
        "steal")


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _cpu_jiffies() -> list:
    line = _read("/proc/stat").split("\n", 1)[0].split()
    return [int(x) for x in line[1:1 + len(STAT)]] if line else []


def _mhz() -> list:
    cur = []
    for cpu in sorted(os.sched_getaffinity(0)):
        v = _read(f"/sys/devices/system/cpu/cpu{cpu}/cpufreq/"
                  "scaling_cur_freq").strip()
        if v:
            cur.append(int(v) / 1e3)
    if cur:
        return cur
    return [float(ln.split(":")[1]) for ln in _read("/proc/cpuinfo")
            .splitlines() if ln.startswith("cpu MHz")]


def _status(*keys) -> dict:
    out = {}
    for ln in _read("/proc/self/status").splitlines():
        k, _, v = ln.partition(":")
        if k in keys:
            out[k] = v.strip()
    return out


def placement(pci_bus_id: str | None = None) -> dict:
    """NUMA nodes, the CPUs and memory nodes this process may use, and
    the card's node (``-1``: the platform does not say)."""
    nodes = sorted(n for n in os.listdir("/sys/devices/system/node")
                   if n.startswith("node")) \
        if os.path.isdir("/sys/devices/system/node") else []
    out = {"numa_nodes": len(nodes),
           "cpus": len(os.sched_getaffinity(0)),
           **_status("Cpus_allowed_list", "Mems_allowed_list")}
    if pci_bus_id:
        bus = pci_bus_id.lower()
        for cand in (bus, bus[4:] if bus.count(":") == 2 and
                     len(bus.split(":")[0]) == 8 else bus):
            v = _read(f"/sys/bus/pci/devices/{cand}/numa_node").strip()
            if v:
                out["card_node"] = int(v)
                break
    return out


class HostMeter:
    """Opened at the window's start; ``read()`` gives what changed."""

    def __init__(self):
        self.t = time.perf_counter()
        self.cpu = _cpu_jiffies()
        self.ru = resource.getrusage(resource.RUSAGE_SELF)

    def read(self) -> dict:
        wall = time.perf_counter() - self.t
        cpu = _cpu_jiffies()
        ru = resource.getrusage(resource.RUSAGE_SELF)
        d = [b - a for a, b in zip(self.cpu, cpu)]
        tot = max(sum(d), 1)
        mhz = _mhz()
        out = {f"{k}_share": round(v / tot, 4) for k, v in zip(STAT, d)}
        out.update(
            wall_s=round(wall, 3),
            proc_user_s=round(ru.ru_utime - self.ru.ru_utime, 3),
            proc_sys_s=round(ru.ru_stime - self.ru.ru_stime, 3),
            minflt=ru.ru_minflt - self.ru.ru_minflt,
            majflt=ru.ru_majflt - self.ru.ru_majflt,
            nvcsw=ru.ru_nvcsw - self.ru.ru_nvcsw,
            nivcsw=ru.ru_nivcsw - self.ru.ru_nivcsw,
            maxrss_mb=round(ru.ru_maxrss / 1024, 1),
            threads=int(_status("Threads").get("Threads", 0) or 0),
            loadavg=_read("/proc/loadavg").split()[:3],
            mhz_min=round(min(mhz), 1) if mhz else None,
            mhz_mean=round(sum(mhz) / len(mhz), 1) if mhz else None,
            last_cpu=int(_read("/proc/self/stat").rsplit(")", 1)[-1]
                         .split()[36] or -1))
        return out
