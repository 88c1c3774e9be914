"""Fault tolerance and elasticity's decisions (``repro_torch.distributed.
fault_tolerance`` and ``elastic``) against ``repro``'s, decision for
decision: the reference's three scenarios (``tests/test_checkpoint_ft.py``),
random scripts of beats, sweeps, step times, swaps, restarts and health
reads on a fake clock, and ``plan_mesh`` for every chip count to 1,024."""

import pytest

from repro.distributed import elastic as jel
from repro.distributed import fault_tolerance as jft

from repro_torch.distributed import elastic as tel
from repro_torch.distributed import fault_tolerance as tft

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional, as in tests/test_properties.py
    given = None

PACKAGES = (jft, tft)
HOSTS = ("h0", "h1", "h2", "h3", "h4", "h5")


def _clock(ft):
    class FakeClock(ft.HostClock):
        t = 0.0

        def now(self):
            return self.t

    return FakeClock()


def heartbeat_scenario(ft) -> list:
    """``test_heartbeat_and_straggler_policies``: every sweep, straggler
    read and swap."""
    clock = _clock(ft)
    mon = ft.HeartbeatMonitor(["h0", "h1", "h2"], timeout=10, grace=25,
                              clock=clock)
    out = []
    clock.t = 5
    for h in ("h0", "h1", "h2"):
        mon.beat(h)
    clock.t = 20
    mon.beat("h0"), mon.beat("h1")
    out.append(mon.sweep())
    clock.t = 60
    mon.beat("h0"), mon.beat("h1")
    out.append(mon.sweep())
    pol = ft.StragglerPolicy(ratio=1.5, patience=2)
    for _ in range(4):
        for h, d in [("h0", 1.0), ("h1", 1.05), ("h2", 3.0)]:
            pol.record(h, d)
        out.append(pol.stragglers())
    spares = ft.HotSparePool(["spare0"])
    out += [spares.swap("h2"), spares.swap("h1"), dict(spares.swapped)]
    return out


def restart_scenario(ft) -> list:
    """``test_restart_loop_recovers``: the final step, the restarts and
    the step every restore resumed from."""
    state = {"step": 0, "fails": 0}
    resumed = []

    def restore():
        resumed.append(state["step"])
        return state["step"]

    def run(start):
        for s in range(start, 10):
            state["step"] = s
            if s == 4 and state["fails"] < 2:
                state["fails"] += 1
                raise RuntimeError("injected node failure")
        return 10

    loop = ft.RestartLoop(run, restore, max_restarts=5)
    return [loop.run(), loop.restarts, resumed]


def elastic_scenario(el) -> list:
    """``test_elastic_plan_and_controller``."""
    out = [el.plan_mesh(512), el.plan_mesh(384), el.plan_mesh(100)]
    ctrl = el.ElasticController(chips_per_host=4)
    for n in (128, 96, 128):
        e = ctrl.evaluate([f"h{i}" for i in range(n)])
        out.append((e.kind, e.n_chips, e.mesh_shape))
    return out


def test_reference_scenarios_decide_alike():
    ref, port = (heartbeat_scenario(ft) for ft in PACKAGES)
    assert port == ref
    assert ref[0] == {"suspect": ["h2"], "dead": []}
    assert "h2" in ref[1]["dead"] and ref[5] == ["h2"]
    ref, port = (restart_scenario(ft) for ft in PACKAGES)
    assert port == ref and ref[:2] == [10, 2]
    ref, port = (elastic_scenario(el) for el in (jel, tel))
    assert port == ref
    assert ref[:3] == [(32, 16), (24, 16), (10, 10)]
    assert [e[0] for e in ref[3:]] == ["steady", "shrink", "grow"]


def test_restart_loop_reraises_past_max_restarts():
    got = []
    for ft in PACKAGES:
        calls = []

        def run(start):
            calls.append(start)
            raise ValueError("always")

        loop = ft.RestartLoop(run, lambda: len(calls), max_restarts=2)
        with pytest.raises(ValueError):
            loop.run()
        got.append((calls, loop.restarts))
    assert got[0] == got[1] == ([0, 1, 2], 3)


def test_plan_mesh_equals_the_reference_to_1024():
    for n in range(1, 1025):
        assert tel.plan_mesh(n) == jel.plan_mesh(n), n
        for model_max, prefer in ((8, 8), (16, 4), (4, 16)):
            assert tel.plan_mesh(n, model_max, prefer) == \
                jel.plan_mesh(n, model_max, prefer), (n, model_max, prefer)


def run_script(ft, el, n_hosts, timeout, grace, ratio, patience, alpha,
               ops) -> list:
    """One script through one package: every decision in order."""
    hosts = list(HOSTS[:n_hosts])
    clock = _clock(ft)
    mon = ft.HeartbeatMonitor(hosts, timeout=timeout, grace=grace,
                              clock=clock)
    pol = ft.StragglerPolicy(ratio=ratio, patience=patience, alpha=alpha)
    spares = ft.HotSparePool(["s0", "s1"])
    ctrl = el.ElasticController(chips_per_host=4, min_chips=2)
    out = []
    for op, a, b in ops:
        if op == "advance":
            clock.t += b
        elif op == "beat":
            mon.beat(hosts[a % n_hosts])
        elif op == "sweep":
            res = mon.sweep()
            out.append(("sweep", res))
            healthy = [h for h in hosts if h not in res["dead"]]
            e = ctrl.evaluate(healthy)
            out.append(("elastic", e.kind, e.n_chips, e.mesh_shape))
        elif op == "record":
            pol.record(hosts[a % n_hosts], b)
        elif op == "stragglers":
            out.append(("stragglers", pol.stragglers(),
                        dict(pol.strikes)))
        elif op == "swap":
            out.append(("swap", spares.swap(hosts[a % n_hosts])))
        elif op == "restart":
            fails = {"left": a % 4}

            def run(start):
                if fails["left"]:
                    fails["left"] -= 1
                    raise RuntimeError("fault")
                return start + 1

            loop = ft.RestartLoop(run, lambda: int(b), max_restarts=2)
            try:
                out.append(("restart", loop.run(), loop.restarts))
            except RuntimeError:
                out.append(("restart", "raised", loop.restarts))
    out.append(("ewma", sorted(pol.ewma.items())))
    return out


if given is not None:
    OPS = st.lists(st.tuples(
        st.sampled_from(["advance", "beat", "sweep", "record", "stragglers",
                         "swap", "restart"]),
        st.integers(0, 11),
        st.floats(0.0, 40.0, allow_nan=False)), max_size=40)

    @settings(max_examples=120, deadline=None)
    @given(n_hosts=st.integers(1, len(HOSTS)),
           timeout=st.floats(1.0, 30.0), grace=st.floats(1.0, 60.0),
           ratio=st.floats(1.0, 3.0), patience=st.integers(1, 4),
           alpha=st.floats(0.05, 1.0), ops=OPS)
    def test_random_scripts_decide_alike(n_hosts, timeout, grace, ratio,
                                         patience, alpha, ops):
        ref = run_script(jft, jel, n_hosts, timeout, grace, ratio, patience,
                         alpha, ops)
        port = run_script(tft, tel, n_hosts, timeout, grace, ratio,
                          patience, alpha, ops)
        assert port == ref
else:
    def test_random_scripts_decide_alike():
        pytest.skip("hypothesis is not installed")
