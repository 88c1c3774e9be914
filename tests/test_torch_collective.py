"""The port's mesh-resident collective path (``sketch.place``,
``MeshContext``, ``path="collective"``, ``core.merge.psum_*``,
``distributed.ranks``) on gloo ranks of the CPU against ``repro``, exactly
(int32).

The cases of ``tests/test_multidevice.py``'s mesh-resident half, on the
same configs and streams: each world size (4, 2 and 1 ranks) is spawned
once for the module and runs every case of its size
(``tests/torch_collective_ranks.py``); rank 0's results come back here.
Every answer of a placed handle, on every path, must equal ``repro``'s
``"scan"`` answer on the same stream and the port's unplaced answer; the
placed leaves (gathered) must equal the unplaced ones and ``repro``'s. One
case runs ``repro``'s own ``path="collective"`` over 4 fake CPU devices in
a subprocess and holds the port's collective answers to it.
"""

import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sketch as jskt
from repro.core import LSketchConfig as JConfig
from repro.core.gss import gss_config as j_gss_config
from repro.core.types import EdgeBatch as JBatch

from repro_torch import sketch as tskt
from repro_torch.distributed.ranks import spawn_ranks

import torch_collective_ranks as R

SRC = str(Path(__file__).resolve().parents[1] / "src")
PATHS = ("scan", "cuda", "collective")

# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------

_REF: dict = {}


def _jspec(kind, ns, kw=None, routed=False):
    cfg = j_gss_config(**R.GS) if kind == "gss" else JConfig(**(kw or R.LS))
    spec = jskt.SketchSpec(kind=kind, config=cfg, n_shards=ns)
    return spec.with_splits([(R.HOT, R.HOT % 3, 4)]) if routed else spec


def _jb(a):
    return JBatch(*[jnp.asarray(x, jnp.int32) for x in a])


def _ref_states(key, spec, batches):
    """``repro``'s handle after each batch (memoized by ``key``; copies,
    since ingest donates the handle it consumes)."""
    if key not in _REF:
        st, states = jskt.create(spec), []
        for b in batches:
            st = jskt.ingest(spec, st, _jb(b))
            states.append(jskt.ShardedState(
                shards=jax.tree.map(jnp.copy, st.shards)))
        _REF[key] = states
    return _REF[key]


def _ref_answers(spec, st, items, path="scan"):
    return [np.asarray(jskt.query(spec, st, R.make_query(jskt, it),
                                  path=path)) for it in items]


def _jleaves(st):
    return [np.asarray(x) for x in jax.tree.leaves(st.shards)]


def _eq_leaves(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(x, y), (what, i)


def _eq_answers(got, want, what):
    assert len(got) == len(want), what
    for i, (x, y) in enumerate(zip(got, want)):
        assert np.array_equal(x, y), (what, i, x[:6], y[:6])


def _hold(res, jst, want, what):
    """Placed leaves == unplaced == repro's ``jst``; every path's answers
    == ``want`` (repro's scan)."""
    _eq_leaves(res["leaves"], res["host"], what + " placed vs unplaced")
    _eq_leaves(res["leaves"], _jleaves(jst), what + " vs repro")
    for p in res["answers"]:
        _eq_answers(res["answers"][p], want, f"{what} {p}")


# ---------------------------------------------------------------------------
# the worlds: one spawn a size for the whole module
# ---------------------------------------------------------------------------

def _repro_shard_states():
    """Leaves of each shard of ``repro``'s 4-shard smoke handle."""
    spec = _jspec("lsketch", 4)
    (st,) = _ref_states(("lsketch", 4, "whole"), spec,
                        [R.stream("lsketch")])
    leaves = _jleaves(st)
    return [[x[r] for x in leaves] for r in range(4)]


@pytest.fixture(scope="module")
def repro_collective(tmp_path_factory):
    """``repro``'s collective answers over 4 fake CPU devices, in a child
    process started before the worlds spawn (it runs beside them)."""
    out = tmp_path_factory.mktemp("repro_collective") / "answers.npz"
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import sys
        sys.path.insert(0, {str(Path(__file__).parent)!r})
        import numpy as np, jax, jax.numpy as jnp
        from repro import sketch as skt
        from repro.core import LSketchConfig
        from repro.core.types import EdgeBatch
        import torch_collective_ranks as R
        spec = skt.SketchSpec(kind="lsketch",
                              config=LSketchConfig(**R.LS), n_shards=4)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
        st = skt.place(spec, skt.create(spec), mesh)
        a = R.stream("lsketch")
        for b in R.stages(a):
            st = skt.ingest(spec, st, EdgeBatch(
                *[jnp.asarray(x, jnp.int32) for x in b]))
        got = [np.asarray(skt.query(spec, st, R.make_query(skt, it),
                                    path="collective"))
               for it in R.suite("lsketch", a)]
        np.savez({str(out)!r}, *got)
    """)
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"),
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, repro_collective):
    """The three worlds, spawned in threads as the module starts so that
    the reference side computes meanwhile: ``{world: future of rank 0's
    results}``. World 2 restores the checkpoint world 4 saves, so it
    starts after it."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    rdv = {w: tmp_path_factory.mktemp(f"rendezvous{w}") / "file"
           for w in (4, 2, 1)}
    states = _repro_shard_states()

    def spawn(world, after=None):
        if after is not None:
            after.result()
        return spawn_ranks(R.run, world, device="cpu", init_file=rdv[world],
                           args=(world, ckpt, states if world == 4
                                 else None))

    with ThreadPoolExecutor(max_workers=3) as pool:
        f4 = pool.submit(spawn, 4)
        futures = {4: f4, 2: pool.submit(spawn, 2, f4),
                   1: pool.submit(spawn, 1)}
        yield futures


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,kind,ns", [
    (w, k, ns) for w in (4, 2, 1) for k, ns in R.SWEEP[w]])
def test_collective_parity_sweep(worlds, world, kind, ns):
    """Staged ingest into a placed handle over ``world`` ranks: after each
    stage the gathered leaves equal the unplaced handle's and ``repro``'s,
    every rank holds its block (checked in the rank), and "scan", "cuda"
    and "collective" all answer ``repro``'s scan answers, as does the
    unplaced handle on both host paths."""
    spec = _jspec(kind, ns)
    a = R.stream(kind)
    jsts = _ref_states((kind, ns, "stages"), spec, R.stages(a))
    items = R.suite(kind, a)
    wants = [_ref_answers(spec, jst, items) for jst in jsts]
    got = worlds[world].result()[("sweep", kind, ns)]
    for stage, (res, jst, want) in enumerate(zip(got, jsts, wants)):
        what = f"{kind} x{ns} over {world} ranks, stage {stage}"
        _hold(res, jst, want, what)
        for p in ("scan", "cuda"):
            _eq_answers(res["host_answers"][p], want, f"{what} unplaced {p}")


def test_collective_matches_repro_collective(worlds, repro_collective):
    """The port's collective answers equal ``repro``'s own
    ``path="collective"`` over a 4-device mesh, on the same stream."""
    proc, out = repro_collective
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(out) as f:
        want = [f[f"arr_{i}"] for i in range(len(f.files))]
    got = worlds[4].result()[("sweep", "lsketch", 4)][-1]
    _eq_answers(got["answers"]["collective"], want,
                "port collective vs repro collective")


def test_collective_window_wraparound_and_pool_overflow(worlds):
    spec = _jspec("lsketch", 4)
    a = R.stream("lsketch", seed=12, n=200, tmax=R.LS["window_size"] - 1)
    (_, jst) = _ref_states(("lsketch", 4, "wrap"), spec,
                           [a, R.wrap_late()])
    wrap = (jst, _ref_answers(spec, jst, R.suite("lsketch", a)))
    spec = _jspec("lsketch", 4, R.TINY)
    a = R.stream("lsketch", seed=13, n=500, tmax=1500, nv=400)
    (jst,) = _ref_states(("tiny", 4), spec, [a])
    assert int(jnp.sum(jst.shards.pool_lost)) > 0
    over = (jst, _ref_answers(spec, jst, R.suite("lsketch", a)))
    res = worlds[4].result()["window_edges"]
    _hold(res["wrap"], *wrap, "wraparound")
    _hold(res["overflow"], *over, "overflow")


def test_collective_routed_split_key(worlds):
    """A split hot key: placed routed ingest equals the unplaced one and
    ``repro``'s, every path answers ``repro``'s scan, and ``merge_all``,
    ``shards_compatible`` and ``reshard`` of the placed handle equal the
    unplaced handle's (and ``repro``'s merge)."""
    spec = _jspec("lsketch", 4, routed=True)
    a = R.routed_stream()
    (jst,) = _ref_states(("routed", 4), spec, [a])
    want = _ref_answers(spec, jst, R.suite("lsketch", a, (None,)))
    res = worlds[4].result()["routed"]
    _hold(res, jst, want, "routed")
    placed, unplaced = res["placed"], res["unplaced"]
    _eq_leaves(placed["merged"], unplaced["merged"], "merge_all")
    _eq_leaves(placed["merged"], [np.asarray(x) for x in jax.tree.leaves(
        jskt.merge_all(spec, jst))], "merge_all vs repro")
    assert placed["compatible"] == unplaced["compatible"] == bool(
        jskt.shards_compatible(spec, jst))
    _eq_leaves(placed["reshard"], unplaced["reshard"], "reshard to 2")


def test_collective_analytics_parity(worlds):
    """Top-k on a placed handle: every path equals ``repro``'s "pallas"
    top-k of the same stream (the reference's own collective analytics
    case; ``repro`` pins "pallas" to "scan")."""
    spec = _jspec("lsketch", 4)
    (jst,) = _ref_states(("lsketch", 4, "whole"), spec,
                         [R.stream("lsketch")])
    wants = {(name, str(kw), "pallas"): [np.asarray(x) for x in getattr(
        jskt, name)(spec, jst, 6, path="pallas", **kw)]
        for name, kw in R.ANALYTICS}
    res = worlds[4].result()["analytics"]
    for (name, kw, jpath), want in wants.items():
        for p in PATHS:
            _eq_leaves(res[(name, kw)][p], want, f"{name} {kw} {p} {jpath}")


def test_collective_plane_builds_one_per_horizon(worlds):
    """Edge queries of two buckets, a vertex and a label batch share one
    collective build; a tighter horizon adds one, a new handle one more
    (each rank counts its own)."""
    assert worlds[4].result()["build_counts"] == [1, 2, 3]


def test_collective_planes_delta_across_flushes(worlds):
    """Four live flushes fold into the collective entry (each fold equal
    to a cold build), with no build beyond the four cold comparisons; a
    flush that moves the ring rebuilds; the delta-kept handle answers."""
    spec = _jspec("lsketch", 8)
    batches = [R.stream("lsketch", seed=71, n=1600)] + \
        [R.live_batch(72 + i) for i in range(4)] + \
        [R.live_batch(90, 2400, 2500), R.live_batch(99, 2400, 2500)]
    jst = _ref_states(("delta", 8), spec, batches)[-1]
    want = _ref_answers(spec, jst, R.suite("lsketch", batches[0]))
    res = worlds[4].result()["delta"]
    assert res["folds_equal"] == [True] * 4
    assert res["counts"] == [4, 4, 4, 5]
    _hold(res, jst, want, "delta-kept")


def test_collective_multi_horizon_parity_and_delta(worlds):
    """Horizon sweeps on the collective path: rows equal ``repro``'s
    per-horizon scan, before and after a live flush that folds into the
    stacked entry (no build; the fold equals a cold build), and the
    analytics sweep equals its single-horizon calls."""
    spec = _jspec("lsketch", 8)
    a = R.stream("lsketch", seed=41, n=1600)
    jsts = _ref_states(("multi", 8), spec, [a, R.live_batch(42)])
    src, dst, la, lb = a[:4]
    vs = np.arange(24, dtype=np.int32)
    singles = [("edges", (src[:32], la[:32], dst[:32], lb[:32])),
               ("vertices", (vs, vs % 3))]
    wants = {tag: [[_ref_answers(spec, jst, [(ctor, args, dict(last=h))])[0]
                    for h in R.MULTI_LASTS] for ctor, args in singles]
             for tag, jst in (("cold", jsts[0]), ("delta", jsts[1]))}
    res = worlds[4].result()["multi"]
    assert res["uniq"] == (1, 2, 3, 4)
    assert res["counts"][0] == 0 and res["counts"][1] > 0
    assert res["fold_equal"]
    assert res["analytics_sweep"] == {"heavy_vertices": True,
                                      "top_labels": True}
    _eq_leaves(res["leaves"], res["host"], "multi placed vs unplaced")
    _eq_leaves(res["leaves"], _jleaves(jsts[-1]), "multi vs repro")
    for tag, want in wants.items():
        for p in PATHS:
            for j, rows in enumerate(want):
                _eq_answers(res[tag][p][j], rows, (tag, p, j))


def test_psum_sketch_matches_leafwise_max_and_sum(worlds):
    """``psum_sketch`` over 4 ranks, each holding one shard of ``repro``'s
    4-shard state: the leafwise MAX of keys and window indices and the
    int32 SUM of the counters, taken with numpy."""
    shards = _repro_shard_states()
    names = ("key", "C", "P", "pool_key", "pool_C", "pool_P", "pool_lost",
             "slot_widx", "cur_widx")
    got = worlds[4].result()["psum_sketch"]
    for i, (name, x) in enumerate(zip(names, got)):
        stack = np.stack([s[i] for s in shards])
        if name in ("key", "pool_key", "slot_widx", "cur_widx"):
            want = stack.max(0)
        else:
            want = stack.astype(np.int64).sum(0).astype(np.int32)
        assert x.dtype == np.int32 and np.array_equal(x, want), name


def test_collective_lgs_placed_handle(worlds):
    """An ``lgs`` handle over 2 ranks: its gathered state and every path's
    answers equal the unplaced handle's scan answers (``lgs`` always
    scans)."""
    res = worlds[2].result()["lgs"]
    _eq_leaves(res["leaves"], res["host"], "lgs placed vs unplaced")
    for p in PATHS:
        _eq_answers(res["answers"][p], res["host_answers"]["scan"],
                    f"lgs {p}")


def test_replicated_branch_warns_once_and_refuses_collective(worlds):
    """3 shards over 2 ranks: the layout warns once and replicates, every
    rank ingests every row, "collective" raises the reference's
    ``ValueError`` (checked in the ranks) and the host paths answer
    ``repro``'s scan."""
    spec = _jspec("lsketch", 3)
    a = R.stream("lsketch")
    (jst,) = _ref_states(("lsketch", 3), spec, [a])
    want = _ref_answers(spec, jst, R.suite("lsketch", a))
    _hold(worlds[2].result()["replicated"], jst, want, "replicated")


def test_checkpoint_saved_at_world_4_restores_at_world_2(worlds):
    """Rank 0 of a 4-rank placed handle writes the whole stack; restored
    over 2 ranks it is the same stack leaf for leaf (each rank holding two
    rows, checked in the ranks) and answers ``repro``'s scan."""
    spec = _jspec("lsketch", 4)
    a = R.stream("lsketch")
    (jst,) = _ref_states(("lsketch", 4, "whole"), spec, [a])
    want = _ref_answers(spec, jst, R.suite("lsketch", a))
    res = dict(worlds[2].result()["restored"],
               host=worlds[4].result()["saved"])
    _hold(res, jst, want, "restored")


def test_spawned_rank_failure_fails_the_run(tmp_path):
    """A rank that raises fails the run with its traceback, while the
    other waits in a collective: no hang."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                       "(.|\n)*rank 1 gives up"):
        spawn_ranks(R.fail_on_rank_1, 2, device="cpu",
                    init_file=tmp_path / "rdv")


def test_mesh_context_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialized process group"):
        tskt.MeshContext()
    assert tskt.mesh_context(tskt.create(tskt.SketchSpec(
        kind="lsketch", config=R.config("lsketch")), "cpu")) is None
    with pytest.raises(ValueError, match="mesh-resident handle"):
        spec = tskt.SketchSpec(kind="lsketch", config=R.config("lsketch"))
        tskt.query(spec, tskt.create(spec, "cpu"),
                   R.make_query(tskt, R.suite("lsketch",
                                              R.stream("lsketch"))[0]),
                   path="collective")
    assert torch.distributed.is_available()


def test_chip_smoke_phase_c_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phase C at a tiny size on the CPU (a one-rank
    gloo group in this process, the card's timers stubbed), after the
    phases it reads (4, 5 and 6b): every comparison must hold, the CLI's
    ``--mesh 1`` and ``--mesh 2`` runs exit 0 (gloo ranks) and the group
    is gone afterwards."""
    import time

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.core.types import LSketchConfig

    class _Event:
        def __init__(self, enable_timing=True):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return 1e3 * (other.t - self.t)

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    cfg = LSketchConfig(d=32, n_blocks=4, F=1024, r=8, s=8, c=16, k=8,
                        window_size=1440, pool_capacity=128, pool_probes=16)
    for name, value in (
            ("CFG", cfg), ("N_EDGES", 8000), ("N_QUERIES", 96),
            ("MAX_FLUSH", 1200), ("SERVER_REQUESTS", 256), ("N_REACH", 8),
            ("CLI_ARGS", ("--edges", "256", "--requests", "16")),
            ("TELEMETRY_STEPS", 8), ("TELEMETRY_CHECK", 4),
            ("TELEMETRY_TOKENS", 256)):
        monkeypatch.setattr(chip_smoke, name, value)
    dev, tag = torch.device("cpu"), "[cpu]"
    spec, stream, flushes, span_i = chip_smoke.deployment()
    qi = chip_smoke.query_inputs(cfg, stream)
    state, rate, _ = chip_smoke.ingest_stream(cfg, spec, stream, flushes,
                                              span_i, dev, tag)
    answers = chip_smoke.run_queries(spec, state, qi, tag)
    got = chip_smoke.analytics_path(cfg, spec, state, qi, answers, tag)
    tskt.clear_plane_cache(state)
    capsys.readouterr()
    launches, out = chip_smoke.collective_phase(
        spec, stream, flushes, state, qi, answers, got, rate, dev, tag)
    text = capsys.readouterr().out
    for phase in ("C1", "C2", "C3", "C4", "C5", "C6"):
        assert f"phase {phase} " in text, phase
    assert not torch.distributed.is_initialized()
    assert set(launches) == set(chip_smoke.WRAPPERS)
    assert out["server"]["mismatches"] == out["telemetry"]["mismatches"] == 0
    assert out["folds"] + out["builds"] == chip_smoke.COLLECTIVE_TAIL
    assert [c["exit"] for c in out["cli"]] == [0, 0]
    edge = out["by_kind"]["edge"]
    assert edge["all_reduce_per_batch"] >= 1 and \
        edge["all_gather_per_batch"] == 0
    assert out["by_kind"]["edge sweep"]["all_reduce_per_batch"] == 1
    import json
    json.dumps(out)
