"""The load generator's arithmetic: Poisson due times, the open loop's
takes, the periodic rounds, the closed loop's clients, and latencies
from due or issue time to answer."""

import numpy as np

from sketchbench.traffic import schedule


def test_poisson_due_times_rate_and_order():
    t = schedule.poisson_due(np.random.default_rng(1), 200.0, 30.0)
    assert np.all(np.diff(t) > 0) and t[0] > 0 and t[-1] < 30.0
    assert abs(len(t) / 30.0 - 200.0) < 15.0
    again = schedule.poisson_due(np.random.default_rng(1), 200.0, 30.0)
    np.testing.assert_array_equal(t, again)


def test_open_loop_takes_each_due_request_once():
    loop = schedule.OpenLoop(np.array([0.1, 0.2, 0.25, 0.9]))
    assert list(loop.take(0.05)) == []
    assert list(loop.take(0.2)) == [0, 1]
    assert list(loop.take(0.3)) == [2]
    assert list(loop.take(5.0)) == [3]
    assert list(loop.take(6.0)) == []
    assert loop.issue_time(2) == 0.25


def test_periodic_rounds_fall_due_at_their_period():
    p = schedule.Periodic(0.05, 0.3)
    assert len(p.due) == 6
    assert list(p.take(0.0)) == [0]
    assert list(p.take(0.12)) == [1, 2]  # a late loop takes both rounds


def test_closed_loop_clients_issue_when_answered():
    c = schedule.ClosedLoop(3)
    assert c.take(0.0) == [0, 1, 2]
    assert c.take(0.1) == []
    c.answered(1, 0.4)
    c.answered(0, 0.5)
    assert c.take(0.5) == [1, 0]
    assert c.issue_time(1) == 0.4 and c.issue_time(2) == 0.0


def test_latency_runs_from_due_or_issue_time_to_the_answer():
    lat = schedule.latencies_ms([0.1, 0.2, 0.25], [0.3, 0.3, 0.6])
    np.testing.assert_allclose(lat, [200.0, 100.0, 350.0])
    # a stall delays every request due during it: each counts its wait
    assert schedule.p95(lat) == np.percentile(lat, 95)
    assert schedule.p95(range(1, 101)) == np.percentile(range(1, 101), 95)
