"""Arrival arithmetic of the load generator, separate from what the
system does with the load.

An open loop sends each request at a time fixed in advance (Poisson
arrivals at a rate) whatever the system does, and a request's latency
runs from its due time, so a stall counts against every request it
delays. A closed loop has a fixed set of clients, each sending its next
request as soon as its previous one is answered: latency runs from the
issue time, and a slow system receives less load. Rounds of writes due
at a fixed period are an open loop of their own.
"""

from __future__ import annotations

import numpy as np


def poisson_due(rng: np.random.Generator, rate: float, horizon_s: float
                ) -> np.ndarray:
    """Due times (seconds from the window's start, ascending) of a Poisson
    process at ``rate`` a second over ``horizon_s`` seconds."""
    n = int(rate * horizon_s * 1.5) + 64
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    while t[-1] < horizon_s:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / rate, n))])
    return t[t < horizon_s]


class OpenLoop:
    """Requests due at fixed times; ``take(now)`` returns the indices of
    those due by ``now`` and not taken yet."""

    def __init__(self, due: np.ndarray):
        self.due = np.asarray(due, np.float64)
        self.next = 0

    def take(self, now: float) -> range:
        end = int(np.searchsorted(self.due, now, side="right"))
        out = range(self.next, end)
        self.next = end
        return out

    def issue_time(self, i: int) -> float:
        return float(self.due[i])


class Periodic(OpenLoop):
    """Rounds due every ``period_s`` seconds from 0."""

    def __init__(self, period_s: float, horizon_s: float):
        super().__init__(np.arange(0.0, horizon_s, period_s))


class ClosedLoop:
    """``n`` clients, all ready at time 0; a client is ready again at the
    time its previous request was answered."""

    def __init__(self, n: int):
        self.ready_at = np.zeros(n, np.float64)
        self.waiting = list(range(n))

    def take(self, now: float) -> list:
        out, self.waiting = self.waiting, []
        return out

    def issue_time(self, client: int) -> float:
        return float(self.ready_at[client])

    def answered(self, client: int, t: float) -> None:
        self.ready_at[client] = t
        self.waiting.append(client)


def latencies_ms(issued: np.ndarray, answered: np.ndarray) -> np.ndarray:
    """Per-request latency in milliseconds (answer minus issue time)."""
    return (np.asarray(answered) - np.asarray(issued)) * 1e3


def p95(values) -> float:
    """The 95th percentile (linear interpolation between order
    statistics) of every value."""
    return float(np.percentile(np.asarray(values, np.float64), 95))
