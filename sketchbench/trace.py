"""What a traced run records, and the reduction of the profiler's trace.

``Observer`` keeps the harness's spans (host seconds of each call into the
server), the program's counters read at the window's ends, and, over a
short steady part of the window, a ``torch.profiler`` trace and the
inputs of each kernel launch the byte counts need (``captures``: the
wrappers where the program's layers call the insert, pool-pass, edge-probe
and vertex-scan kernels are wrapped for that part only, and the wrappers
keep references, so nothing is copied or launched for them). ``reduce``
turns the trace into what the metric readers take: device busy seconds
(the union of every device operation's interval), device seconds by
kernel, the host ranges (``lsketch.*`` from the program, ``sketchbench.*``
from the harness) and the launch calls, and the breakdown.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

RANGES = ("lsketch.", "sketchbench.")  # host ranges: the program's, ours
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
# (module, attribute) of each kernel wrapper as its caller looks it up
CAPTURED = {
    "insert": ("repro_torch.kernels.sketch_insert.ops",
               "sketch_insert_kernel_sharded"),
    "pool": ("repro_torch.kernels.sketch_insert.ops",
             "pool_pass_kernel_sharded"),
    "probe": ("repro_torch.kernels.sketch_query.ops", "edge_query_kernel"),
    "scan": ("repro_torch.kernels.vertex_scan.ops",
             "vertex_scan_kernel_sharded"),
}


class Observer:
    """Spans, counters and (traced runs) the profiled part of a window."""

    def __init__(self, traced: bool, profile_from_s: float = 0.0,
                 profile_s: float = 0.0):
        self.traced = traced
        self.spans = defaultdict(list)
        self.counters = {}
        self.captures = defaultdict(list)
        self.profile_from_s, self.profile_s = profile_from_s, profile_s
        self.prof = None
        self.profiled = None  # (wall seconds, flushes) of the profiled part
        # the pool's keys before the first and after the last captured
        # pool pass (the tensor the state updates in place)
        self.pool_key_before = self.pool_key_after = None
        self._pool_key = None
        self._patched = []
        self._t = None
        self.state = "before"  # -> "profiling" -> "after"

    @contextlib.contextmanager
    def span(self, name: str):
        """Host seconds of a call into the system (traced runs only), as a
        ``sketchbench.<name>`` range of the trace."""
        if not self.traced:
            yield
            return
        t = time.perf_counter()
        with record_function("sketchbench." + name):
            yield
        self.spans[name].append(time.perf_counter() - t)

    def tick(self, now_s: float, sync) -> None:
        """At an iteration boundary of the window: start or stop the
        profiled part (the device synchronised at both ends)."""
        if not self.traced:
            return
        if self.state == "before" and now_s >= self.profile_from_s:
            sync()
            self._start()
        elif self.state == "profiling" and \
                time.perf_counter() - self._t >= self.profile_s:
            self.stop(sync)

    def _start(self) -> None:
        import importlib
        for what, (mod, attr) in CAPTURED.items():
            m = importlib.import_module(mod)
            inner = getattr(m, attr)
            setattr(m, attr, self._wrap(what, inner))
            self._patched.append((m, attr, inner))
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._flushes0 = len(self.spans["flush"])
        self._t = time.perf_counter()
        self.state = "profiling"

    def stop(self, sync) -> None:
        if self.state != "profiling":
            return
        sync()
        wall = time.perf_counter() - self._t
        self.prof.__exit__(None, None, None)
        for m, attr, inner in self._patched:
            setattr(m, attr, inner)
        self._patched = []
        self.profiled = (wall, len(self.spans["flush"]) - self._flushes0)
        if self._pool_key is not None:
            self.pool_key_after = self._pool_key.clone()
        self.state = "after"

    def _wrap(self, what: str, inner):
        captures = self.captures[what]

        def wrapper(*args, **kw):
            if what == "pool" and self._pool_key is None:
                self._pool_key = args[7]
                self.pool_key_before = args[7].clone()
            captures.append((_kept(what, args), kw))
            return inner(*args, **kw)
        return wrapper


def _kept(what: str, args: tuple) -> tuple:
    """What the byte counts need of a launch's arguments: the edge probe's
    key planes rather than the whole planes (their counter planes are
    gigabytes), the scan's key plane alone."""
    if what == "probe":
        cfg, planes = args[:2]
        multi = planes.cw.dim() == 5
        key = planes.key[0] if multi else planes.key
        return (cfg, key, planes.cw.shape[0] if multi else 1) + args[2:]
    if what == "scan":
        return args[:4]
    return args


def _short(name: str) -> str:
    name = name.removeprefix("void ")
    for stop in ("(", "<"):
        name = name.split(stop)[0]
    return name[:100]


def reduce(prof, wall_s: float) -> dict:
    """The profiled part's trace as the readers take it: ``busy_s``,
    ``window_s``, ``device_s`` (seconds by kernel name), ``host_ranges``
    (name -> list of (start, end) seconds), ``launches`` (start seconds of
    each launch call) and ``breakdown``. An empty trace of the device
    gives ``busy_s`` 0."""
    dev, host, launches = [], defaultdict(list), []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type != torch.autograd.DeviceType.CPU:
            # a host range's mirror on the device timeline is no operation
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(RANGES)):
                dev.append((a, b, e.name))
        elif e.name in LAUNCHES:
            launches.append(a)
        elif e.name.startswith(RANGES):
            host[e.name].append((a, b))
    device_s = defaultdict(float)
    for a, b, n in dev:
        device_s[_short(n)] += b - a
    busy, gaps = _union(dev)
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, _enclosing(host, [0.5 * (a + b)
                                                   for a, b in gaps])):
        idle[name] += b - a
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy, window_s=wall_s, device_s=dict(device_s),
                host_ranges=dict(host), launches=sorted(launches),
                breakdown=dict(device_ops=top(device_s), idle_gaps=top(idle)))


def _union(intervals) -> tuple:
    """(total seconds covered, the gaps between covered stretches)."""
    iv = sorted((a, b) for a, b, _ in intervals)
    busy, gaps, cur = 0.0, [], None
    for a, b in iv:
        if cur is None:
            cur = [a, b]
        elif a > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def _enclosing(host: dict, times) -> list:
    """For each of the ascending ``times``, the innermost host range open
    then (the shortest one that covers it), or ``host`` when none is."""
    ranges = sorted((a, b, name) for name, spans in host.items()
                    for a, b in spans)
    out, active, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            active.append(ranges[i])
            i += 1
        active = [r for r in active if r[1] >= t]
        out.append(min(active, key=lambda r: r[1] - r[0])[2]
                   if active else "host")
    return out


def inside(times, ranges) -> int:
    """How many of the sorted ``times`` fall inside any of ``ranges``."""
    return sum(bisect.bisect_right(times, b) - bisect.bisect_left(times, a)
               for a, b in ranges)
