"""Fault tolerance and straggler mitigation (counterpart of
``repro.distributed.fault_tolerance``; pure Python in both packages, the
same decision rules, tie orders and sweep order).

Every policy runs against an injectable ``HostClock`` and a host table,
so the logic is tested on one machine (``tests/test_torch_fault_tolerance.py``
holds each decision to the reference's).

Components:
  * HeartbeatMonitor — per-host monotone heartbeats; hosts silent longer
    than ``timeout`` are marked suspect; past ``grace`` -> dead.
  * StragglerPolicy — EWMA of per-host step durations; a host slower than
    ``ratio`` x fleet median for ``patience`` consecutive reads is a
    straggler (re-dispatch its shard / swap it for a hot spare).
  * RestartLoop — crash-only training: on any failure, restore the newest
    checkpoint and continue; bounded retries with exponential backoff.
    Wrapping the trainer::

        loop = RestartLoop(
            lambda start: (train(..., resume=True, ckpt_dir=d), steps)[1],
            lambda: CheckpointManager(d).latest_step() or 0)
        loop.run()

    ``train(resume=True)`` restores the newest checkpoint itself (the
    state, the step and the pipeline cursor), so ``restore_fn`` only
    reports its step.
  * HotSparePool — spare hosts to swap for dead or straggling ones (the
    mesh-resize path is ``elastic.py``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional


class HostClock:
    """Injectable time source (tests use a fake)."""

    def now(self) -> float:
        return time.monotonic()


@dataclasses.dataclass
class HostState:
    last_beat: float
    suspect_since: Optional[float] = None
    dead: bool = False
    step_ewma: float = 0.0


class HeartbeatMonitor:
    def __init__(self, hosts: List[str], timeout: float = 30.0,
                 grace: float = 60.0, clock: HostClock | None = None):
        self.clock = clock or HostClock()
        self.timeout = timeout
        self.grace = grace
        now = self.clock.now()
        self.hosts: Dict[str, HostState] = {
            h: HostState(last_beat=now) for h in hosts}

    def beat(self, host: str):
        st = self.hosts[host]
        st.last_beat = self.clock.now()
        st.suspect_since = None

    def sweep(self) -> dict:
        """Returns {suspect: [...], dead: [...]} after one health sweep."""
        now = self.clock.now()
        suspect, dead = [], []
        for h, st in self.hosts.items():
            if st.dead:
                dead.append(h)
                continue
            silent = now - st.last_beat
            if silent > self.timeout:
                if st.suspect_since is None:
                    st.suspect_since = now
                if now - st.suspect_since + self.timeout > self.grace:
                    st.dead = True
                    dead.append(h)
                else:
                    suspect.append(h)
        return {"suspect": suspect, "dead": dead}


class StragglerPolicy:
    """EWMA step-duration tracking; flags persistent stragglers."""

    def __init__(self, ratio: float = 1.5, patience: int = 3,
                 alpha: float = 0.3):
        self.ratio = ratio
        self.patience = patience
        self.alpha = alpha
        self.ewma: Dict[str, float] = {}
        self.strikes: Dict[str, int] = defaultdict(int)

    def record(self, host: str, step_seconds: float):
        prev = self.ewma.get(host, step_seconds)
        self.ewma[host] = (1 - self.alpha) * prev + self.alpha * step_seconds

    def stragglers(self) -> List[str]:
        if len(self.ewma) < 2:
            return []
        med = sorted(self.ewma.values())[len(self.ewma) // 2]
        out = []
        for h, v in self.ewma.items():
            if v > self.ratio * med:
                self.strikes[h] += 1
                if self.strikes[h] >= self.patience:
                    out.append(h)
            else:
                self.strikes[h] = 0
        return out


class HotSparePool:
    def __init__(self, spares: List[str]):
        self.spares = deque(spares)
        self.swapped: Dict[str, str] = {}

    def swap(self, bad_host: str) -> Optional[str]:
        if not self.spares:
            return None
        repl = self.spares.popleft()
        self.swapped[bad_host] = repl
        return repl


class RestartLoop:
    """Crash-only training driver: run -> on failure restore -> retry."""

    def __init__(self, run_fn: Callable[[int], int],
                 restore_fn: Callable[[], int],
                 max_restarts: int = 16, backoff: float = 1.5):
        self.run_fn = run_fn  # (start_step) -> final_step, raises on fault
        self.restore_fn = restore_fn  # () -> step to resume from
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.restarts = 0

    def run(self) -> int:
        delay = 0.0
        while True:
            start = self.restore_fn()
            try:
                return self.run_fn(start)
            except Exception:  # noqa: BLE001 — any fault -> restart
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                delay = max(1.0, delay * self.backoff)
                time.sleep(min(delay, 0.01))  # bounded for tests
