"""The port's sketch server (``repro_torch.launch.serve_sketch``:
``SketchServer`` in single-handle and pool mode, ``build_spec``, the CLI's
``main``, ``serve --mode sketch``), ``telemetry.BigramSketch`` and
``data.tokens`` against ``repro`` on the CPU, exactly.

The cases of ``tests/test_serve_sketch.py``, each run on the port and on
``repro`` with the same stream and requests: the port's ``path="scan"``
against ``"scan"`` and its ``"cuda"`` (the kernels' plain versions on the
CPU) against ``"pallas"``. Then a rehearsal of ``chip_smoke.py``'s phases
V (the server) and M (merge, reshard, restore) at a tiny size.
"""

import dataclasses
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sketch as jskt
from repro.core import LSketchConfig as JConfig
from repro.core.types import EdgeBatch as JBatch
from repro.data import tokens as jtokens
from repro.data.stream import PHONE as J_PHONE
from repro.data.stream import edge_batches as j_edge_batches
from repro.data.stream import generate as j_generate
from repro.launch import serve_sketch as jserve
from repro.telemetry.stream_stats import BigramSketch as JBigram

from repro_torch import sketch as tskt
from repro_torch.core import LSketch
from repro_torch.core.types import EdgeBatch, LSketchConfig
from repro_torch.data import tokens as ttokens
from repro_torch.data.stream import PHONE, edge_batches, generate
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.launch import serve as tserve_lm
from repro_torch.launch import serve_sketch as tserve
from repro_torch.telemetry import BigramSketch

import torch_collective_ranks as R

q_mod = importlib.import_module("repro_torch.sketch.query")
ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
SERVE_KW = dict(d=64, n_blocks=2, F=512, r=4, s=4, c=4, k=4, window_size=400,
                pool_capacity=256, pool_probes=8)
PATHS = [("scan", "scan"), ("cuda", "pallas")]


def _streams(n_edges=3000):
    t = generate(dataclasses.replace(PHONE, n_edges=n_edges,
                                     n_vertices=300), seed=0)
    j = j_generate(dataclasses.replace(J_PHONE, n_edges=n_edges,
                                       n_vertices=300), seed=0)
    return t, j


def _servers(kind, window, ns, tpath="auto", jpath="auto", **kw):
    return (tserve.SketchServer(tserve.build_spec(kind, window, ns),
                                query_path=tpath, device=CPU, **kw),
            jserve.SketchServer(jserve.build_spec(kind, window, ns),
                                query_path=jpath, **kw))


def _mk(rng, n, tlo, thi):
    src = rng.integers(0, 50, n).astype(np.int32)
    dst = rng.integers(0, 50, n).astype(np.int32)
    return [np.asarray(x, np.int32) for x in (
        src, dst, src % 3, dst % 3, rng.integers(0, 5, n),
        rng.integers(1, 4, n), np.sort(rng.integers(tlo, thi, n)))]


def _tb(cols):
    return EdgeBatch(*cols)


def _jb(cols):
    return JBatch(*[jnp.asarray(x, jnp.int32) for x in cols])


def _leaves_equal(tstate, jstate):
    for x, y in zip(tskt.to_numpy(tstate), jax.tree.leaves(jstate.shards)):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_flush_on_empty_queue_is_noop():
    spec = tserve.build_spec("lsketch", window_size=100, n_shards=2)
    server = tserve.SketchServer(spec, device=CPU)
    before = server.state.live().leaves()
    assert server.flush() == 0
    after = server.state.live().leaves()
    assert all(a is b for a, b in zip(before, after))  # no dispatch at all
    assert server.pending == []


def test_request_grouping_axes():
    """Requests group by (kind, has-edge-label, last, direction); batched
    fields stay per request; the answers are ``repro``'s."""
    t, j = _servers("lsketch", 100, 1)
    tst, jst = _streams(600)
    for b in edge_batches(tst, 256):
        t.ingest(b)
    for b in j_edge_batches(jst, 256):
        j.ingest(b)
    subs = [("edge", dict(src=1, la=0, dst=2, lb=0)),
            ("edge", dict(src=3, la=1, dst=4, lb=1)),
            ("edge", dict(src=1, la=0, dst=2, lb=0, le=5)),
            ("edge", dict(src=1, la=0, dst=2, lb=0, last=2)),
            ("vertex", dict(v=1, lv=0, direction="in")),
            ("vertex", dict(v=1, lv=0, direction="out"))]
    treqs = [t.submit(k, **a) for k, a in subs]
    jreqs = [j.submit(k, **a) for k, a in subs]
    groups = {}
    for r in t.pending:
        groups.setdefault(t._group_key(r), []).append(r)
    assert len(groups) == 5
    assert len(groups[("edge", False, None, "out")]) == 2
    for key in (("edge", True, None, "out"), ("edge", False, 2, "out"),
                ("vertex", False, None, "in"),
                ("vertex", False, None, "out")):
        assert key in groups
    assert t.flush() == 6 and t.pending == []
    j.flush()
    assert [r.answer for r in treqs] == [r.answer for r in jreqs]
    assert all(r.answer is not None for r in treqs)


def _every_key_requests(cols, n=33):
    """Requests over all 30 group keys at ``SERVE_KW``'s k = 4 (lasts
    None, 1 and k, with and without an edge label, both directions for
    vertices and labels), about edges and endpoints of the newest batch
    ``cols``, each kind's pass ``n`` = 33 rows (one past a bucket)."""
    src, dst, la, lb, le_ = (c.tolist() for c in cols[:5])
    out = []
    for i in range(n):
        le, last = (None, le_[i])[i % 2], (None, 1, 4)[(i // 2) % 3]
        out.append(("edge", dict(src=src[i], la=la[i], dst=dst[i],
                                 lb=lb[i], le=le, last=last)))
        d = ("out", "in")[(i // 6) % 2]
        v, lv = (src[i], la[i]) if d == "out" else (dst[i], lb[i])
        out.append(("vertex", dict(v=v, lv=lv, le=le, last=last,
                                   direction=d)))
        out.append(("label", dict(lv=i % 3, le=le, last=last, direction=d)))
    return [(k, {a: b for a, b in args.items() if b is not None})
            for k, args in out]


@pytest.fixture(scope="module")
def every_key_served():
    """One port server on the kernel route (the kernels' plain versions)
    and ``repro``'s on ``"pallas"``, the same stream over several
    subwindows ingested into both; ``repro``'s answers to every request
    of ``_every_key_requests`` in one flush."""
    tspec, jspec = _serve_specs(2)
    t = tserve.SketchServer(tspec, query_path="cuda", horizons=[1, 4],
                            device=CPU)
    j = jserve.SketchServer(jspec, query_path="pallas", horizons=[1, 4])
    rng = np.random.default_rng(5)
    for lo in range(0, 2400, 400):
        cols = _mk(rng, 160, lo, lo + 400)
        t.ingest(_tb(cols))
        j.ingest(_jb(cols))
    reqs = _every_key_requests(cols)
    jh = [j.submit(k, **a) for k, a in reqs]
    j.flush()
    return t, tspec, reqs, [h.answer for h in jh]


def _query_one(spec, state, kind, a) -> int:
    """One request's answer from ``skt.query`` on the kernel route."""
    le = None if a.get("le") is None else [a["le"]]
    last = a.get("last")
    if kind == "edge":
        q = tskt.QueryBatch.edges([a["src"]], [a["la"]], [a["dst"]],
                                  [a["lb"]], edge_label=le, last=last)
    elif kind == "vertex":
        q = tskt.QueryBatch.vertices([a["v"]], [a["lv"]], edge_label=le,
                                     direction=a["direction"], last=last)
    else:
        q = tskt.QueryBatch.labels([a["lv"]], edge_label=le,
                                   direction=a["direction"], last=last)
    return int(tskt.query(spec, state, q, path="cuda")[0])


@pytest.mark.parametrize("kinds,n_keys", [
    (("edge",), 6), (("vertex",), 12), (("label",), 12),
    (("edge", "vertex", "label"), 30)],
    ids=["edge", "vertex", "label", "mixed"])
def test_fused_flush_answers_every_group_key_as_query_and_repro(
        every_key_served, kinds, n_keys):
    """A single handle's flush on the kernel route answers each kind in
    one pass over all its group keys (``skt.query_many``); every answer
    equals a per-request ``skt.query`` on the served state and
    ``repro``'s server, for each pass alone and for all three at once."""
    server, spec, reqs, jans = every_key_served
    pick = [i for i, (k, _) in enumerate(reqs) if k in kinds]
    keys = {server._group_key(tserve.QueryRequest(*reqs[i])) for i in pick}
    assert len(keys) == n_keys
    handles = [server.submit(reqs[i][0], **reqs[i][1]) for i in pick]
    assert server.flush() == len(pick) >= 33
    state = server.state
    for h, i in zip(handles, pick):
        want = _query_one(spec, state, *reqs[i])
        assert h.answer == want == jans[i], (reqs[i], h.answer, want,
                                             jans[i])
    assert all(any(h.answer for h, i in zip(handles, pick)
                   if reqs[i][0] == k) for k in kinds)


@pytest.mark.parametrize("direction", ["out", "in"])
def test_label_pass_reduces_only_the_rows_buckets(every_key_served,
                                                  direction):
    """The label pass's ``w_label``, one masked sum a distinct (block,
    bucket) pair of the rows (repeated labels, and more labels than ``c``
    buckets), equals ``label_aggregate_planes``' shard by shard."""
    from repro_torch.kernels.vertex_scan import ops as vs_ops
    server, spec, _, _ = every_key_served
    cfg = spec.config
    planes = tskt.query_planes(spec, server.state, 4)
    rng = np.random.default_rng(3)
    lv = rng.integers(0, 3, 40).astype(np.int32)
    le = rng.integers(0, 4 * cfg.c, 40).astype(np.int32)
    le[:5] = le[0]
    _, want = vs_ops.label_aggregate_planes(
        cfg, planes, torch.from_numpy(lv), torch.from_numpy(le), direction,
        with_le=True)
    got = vs_ops.label_weight_planes(cfg, planes, lv, le, direction)
    assert torch.equal(got, want) and bool(want.any())


@pytest.mark.parametrize("tpath,jpath", PATHS)
def test_sharded_server_answers_match_repro_and_single_sketch(tpath, jpath):
    tst, jst = _streams()
    t, j = _servers("lsketch", PHONE.window_size, 4, tpath, jpath)
    ref = LSketch(tserve.build_spec("lsketch", PHONE.window_size).config,
                  device=CPU)
    for b in edge_batches(tst, 512):
        t.ingest(b)
        ref.insert(b.src, b.dst, b.src_label, b.dst_label, b.edge_label,
                   b.weight, b.time)
    for b in j_edge_batches(jst, 512):
        j.ingest(b)
    _leaves_equal(t.state, j.state)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, len(tst), 64)
    subs = [("edge", dict(src=int(tst.src[i]), la=int(tst.src_label[i]),
                          dst=int(tst.dst[i]), lb=int(tst.dst_label[i])))
            for i in idx]
    subs += [("vertex", dict(v=int(tst.src[i]), lv=int(tst.src_label[i]),
                             direction="out")) for i in idx[:16]]
    subs += [("label", dict(lv=int(x), le=3, last=2)) for x in range(3)]
    treqs = [t.submit(k, **a) for k, a in subs]
    jreqs = [j.submit(k, **a) for k, a in subs]
    assert t.flush() == len(treqs) == j.flush()
    assert [r.answer for r in treqs] == [r.answer for r in jreqs]
    for r, i in zip(treqs[:64], idx):
        assert r.answer == ref.edge_weight(
            int(tst.src[i]), int(tst.src_label[i]),
            int(tst.dst[i]), int(tst.dst_label[i]))
    for r, i in zip(treqs[64:80], idx[:16]):
        assert r.answer == ref.vertex_weight(
            int(tst.src[i]), int(tst.src_label[i]), direction="out")
    # the analytics of the served sketch
    for kind in ("vertex", "edge", "label"):
        got = t.top_k(kind, 8)
        want = j.top_k(kind, 8)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    src, la = tst.src[idx[:8]], tst.src_label[idx[:8]]
    dst, lb = tst.dst[idx[:8]], tst.dst_label[idx[:8]]
    np.testing.assert_array_equal(
        t.reachable(src, la, dst, lb, max_hops=3),
        np.asarray(j.reachable(src, la, dst, lb, max_hops=3)))


def _main_lines(out):
    """The deterministic lines of a CLI run (not the timings)."""
    keep = ("sample answers", "top-", "routing:")
    lines = [re.sub(r" \([0-9.]+s(, one [a-z ]+dispatch)?\)", "", x)
             for x in out.splitlines() if x.startswith(keep)]
    return lines + [x.split(" (")[0] for x in out.splitlines()
                    if x.startswith("horizon sweep")]


@pytest.mark.parametrize("argv", [
    ["--sketch", "lsketch", "--shards", "4"],
    ["--sketch", "lgs", "--shards", "2"],
    ["--sketch", "gss", "--shards", "2"],
    ["--sketch", "lsketch", "--shards", "2", "--no-prewarm",
     "--heat-threshold", "0.05", "--horizons", "1,2"],
    ["--sketch", "lsketch", "--shards", "1", "--tenants", "4",
     "--horizons", "1,2,4"]])
def test_serve_sketch_main_matches_repro(argv, capsys):
    """The CLI for every kind, the no-prewarm flag, routing and pool mode:
    the same answers, top-k, sweeps and routing lines as ``repro``'s."""
    small = ["--edges", "1024", "--requests", "64", "--ingest-batch", "256"]
    tserve.main(argv + small + ["--device", "cpu"])
    tout = capsys.readouterr().out
    jserve.main(argv + small)
    jout = capsys.readouterr().out
    assert "ingested 1024 edges" in tout and "on cpu" in tout
    assert "answered 64 edge queries" in tout
    if "--tenants" in argv:
        assert "4 tenants" in tout
    assert _main_lines(tout) == _main_lines(jout) != []


def test_serve_mode_sketch_and_mesh_raise(capsys):
    """``serve --mode sketch`` runs; the mesh options refuse what the
    reference refuses: the collective path without a mesh (CLI and
    constructor), a mesh that does not divide the shards, pool mode with
    a mesh or with the collective path."""
    tserve_lm.main(["--mode", "sketch", "--device", "cpu", "--edges", "512",
                    "--requests", "16", "--ingest-batch", "256"])
    assert "answered 16 edge queries" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="needs --mesh N"):
        tserve.main(["--collective", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --mesh N"):
        tserve.main(["--query-path", "collective", "--device", "cpu"])
    with pytest.raises(SystemExit, match="divide --shards"):
        tserve.main(["--shards", "8", "--mesh", "3", "--collective",
                     "--device", "cpu"])
    spec = tserve.build_spec("lsketch", 100, 2)
    with pytest.raises(ValueError, match="needs a mesh"):
        tserve.SketchServer(spec, query_path="collective", device=CPU)
    pool = tskt.TenantPool(spec, n_slots=2, device=CPU)
    with pytest.raises(ValueError, match="not a TenantPool"):
        tserve.SketchServer(pool=pool, query_path="collective")
    with pytest.raises(ValueError, match="host-resident"):
        tserve.SketchServer(pool=pool, mesh=object())
    with pytest.raises(SystemExit):
        tserve.main(["--tenants", "2", "--mesh", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tserve.main(["--tenants", "2", "--heat-threshold", "0.1",
                     "--device", "cpu"])


MESH_PATHS = ("collective", "cuda")


@pytest.fixture(scope="module")
def mesh_served(tmp_path_factory):
    """``SketchServer(mesh=...)`` over 2 gloo ranks at 4 shards on each
    path of MESH_PATHS (one spawn), and ``repro``'s unplaced server on
    its scan path, fed the same stream."""
    got = spawn_ranks(R.serve_mesh, 2, device=CPU, args=(MESH_PATHS,),
                      init_file=tmp_path_factory.mktemp("mesh") / "rdv")
    _, jst = _streams()
    j = jserve.SketchServer(jserve.build_spec("lsketch", PHONE.window_size,
                                              4), query_path="scan")
    for b in j_edge_batches(jst, 512):
        j.ingest(b)
    return got, j, jst


@pytest.mark.parametrize("tpath", MESH_PATHS)
def test_mesh_server_matches_repro(tpath, mesh_served):
    """``SketchServer(mesh=...)`` over 2 gloo ranks at 4 shards (each rank
    serving its block; the refusals of a 3-shard collective server and
    of pool mode checked in the ranks): the gathered state, every answer,
    a sweep, top-k and reachability equal ``repro``'s unplaced server's
    on its scan path."""
    served, j, jst = mesh_served
    got = served[tpath]
    for x, y in zip(got["leaves"], jax.tree.leaves(j.state.shards)):
        np.testing.assert_array_equal(x, np.asarray(y))
    idx, subs = R.serve_requests(jst)
    jreqs = [j.submit(k, **a) for k, a in subs]
    j.flush()
    assert got["answers"] == [r.answer for r in jreqs]
    for kind, g in zip(("vertex", "edge", "label"), got["top_k"]):
        for a, b in zip(g, j.top_k(kind, 8)):
            np.testing.assert_array_equal(a, np.asarray(b))
    sl = idx[:8]
    np.testing.assert_array_equal(got["reachable"], np.asarray(j.reachable(
        jst.src[sl], jst.src_label[sl], jst.dst[sl], jst.dst_label[sl],
        max_hops=3)))
    q = jskt.QueryBatch.edges(jst.src[sl], jst.src_label[sl], jst.dst[sl],
                              jst.dst_label[sl], last=[1, 2])
    np.testing.assert_array_equal(got["sweep"], np.asarray(jskt.query(
        j.spec, j.state, q, path="scan")))


def test_serve_cli_mesh_collective_matches_repro():
    """``--shards 8 --mesh 4 --collective``: the port's 4 gloo ranks
    (``--device cpu``) print the deterministic lines of ``repro``'s CLI
    over 8 fake devices."""
    small = ["--shards", "8", "--mesh", "4", "--collective", "--edges",
             "1024", "--requests", "64", "--ingest-batch", "256",
             "--horizons", "1,2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-m", mod, *small, *extra], env=e, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mod, extra, e in (
            ("repro_torch.launch.serve_sketch", ["--device", "cpu"], env),
            ("repro.launch.serve_sketch", [], jenv))]
    (tout, terr), (jout, jerr) = [p.communicate(timeout=600) for p in procs]
    assert procs[0].returncode == 0, terr[-3000:]
    assert procs[1].returncode == 0, jerr[-3000:]
    assert "ingested 1024 edges" in tout and "of 4 ranks) on cpu" in tout
    assert "answered 64 edge queries" in tout
    assert _main_lines(tout) == _main_lines(jout) != []


# --------------------------------------------------------------------------
# plane-cache prewarm
# --------------------------------------------------------------------------

def _serve_specs(ns):
    return (tskt.SketchSpec(kind="lsketch", config=LSketchConfig(**SERVE_KW),
                            n_shards=ns),
            jskt.SketchSpec(kind="lsketch", config=JConfig(**SERVE_KW),
                            n_shards=ns))


def test_prewarm_moves_plane_builds_off_the_query_path():
    """Live-subwindow flushes with prewarm on: the query flush pays no
    full plane build (the cache was folded during ingest); answers and
    state equal ``repro``'s on the kernel path."""
    tspec, jspec = _serve_specs(4)
    rng = np.random.default_rng(0)
    t = tserve.SketchServer(tspec, query_path="cuda", device=CPU)
    j = jserve.SketchServer(jspec, query_path="pallas")
    batches = [_mk(rng, 1200, 0, 2400)] + [_mk(rng, 96, 2300, 2400)
                                           for _ in range(4)]
    for b in batches:
        t.ingest(_tb(b))
        j.ingest(_jb(b))
    before = dict(q_mod.PLANES_BUILD_COUNTS)
    r = t.submit("edge", src=1, la=1, dst=2, lb=2)
    jr = j.submit("edge", src=1, la=1, dst=2, lb=2)
    assert t.flush() == 1 and r.answer is not None
    j.flush()
    assert q_mod.PLANES_BUILD_COUNTS["build"] == before["build"], \
        "query flush paid a full plane rebuild despite prewarm"
    assert r.answer == jr.answer
    _leaves_equal(t.state, j.state)


def test_prewarm_off_pays_build_inline_same_answers():
    answers = {}
    for prewarm in (True, False):
        rng = np.random.default_rng(0)
        tspec, _ = _serve_specs(4)
        server = tserve.SketchServer(tspec, query_path="cuda",
                                     prewarm=prewarm, device=CPU)
        server.ingest(_tb(_mk(rng, 1200, 0, 2400)))
        for _ in range(3):
            server.ingest(_tb(_mk(rng, 96, 2300, 2400)))
        before = dict(q_mod.PLANES_BUILD_COUNTS)
        reqs = [server.submit("edge", src=i, la=i % 3, dst=i + 1,
                              lb=(i + 1) % 3) for i in range(8)]
        server.flush()
        answers[prewarm] = [r.answer for r in reqs]
        paid = (q_mod.PLANES_BUILD_COUNTS["build"] - before["build"],
                q_mod.PLANES_BUILD_COUNTS["delta"] - before["delta"])
        if prewarm:
            assert paid[0] == 0, f"prewarmed flush rebuilt planes: {paid}"
        else:
            assert sum(paid) >= 1, \
                "no-prewarm flush should pay the cache fill inline"
    assert answers[True] == answers[False]


def test_prewarm_noop_on_scan_path_and_horizons_sweep():
    """The scan path builds no planes; with ``horizons=`` registered an
    ingest prewarms every horizon in one stacked build (a multi entry),
    and each horizon's answers equal ``repro``'s."""
    tspec, jspec = _serve_specs(2)
    rng = np.random.default_rng(1)
    b = _mk(rng, 256, 0, 2400)
    before = dict(q_mod.PLANES_BUILD_COUNTS)
    server = tserve.SketchServer(tspec, query_path="scan", device=CPU)
    server.ingest(_tb(b))
    r = server.submit("edge", src=1, la=1, dst=2, lb=2)
    server.flush()
    assert r.answer is not None
    assert dict(q_mod.PLANES_BUILD_COUNTS) == before
    t = tserve.SketchServer(tspec, query_path="cuda", horizons=[1, 2],
                            device=CPU)
    j = jserve.SketchServer(jspec, query_path="pallas", horizons=[1, 2])
    t.ingest(_tb(b))
    j.ingest(_jb(b))
    assert q_mod.PLANES_BUILD_COUNTS["build-multi"] == \
        before["build-multi"] + 1
    tr = [t.submit("vertex", v=v, lv=v % 3, last=h)
          for v in range(6) for h in (None, 1, 2)]
    jr = [j.submit("vertex", v=v, lv=v % 3, last=h)
          for v in range(6) for h in (None, 1, 2)]
    t.flush()
    j.flush()
    assert [x.answer for x in tr] == [x.answer for x in jr]


# --------------------------------------------------------------------------
# pool mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tpath,jpath", PATHS)
def test_pool_mode_answers_match_per_tenant_servers_and_repro(tpath, jpath):
    tspec, jspec = _serve_specs(2)
    pooled = tserve.SketchServer(pool=tskt.TenantPool(tspec, n_slots=3,
                                                      device=CPU),
                                 query_path=tpath)
    jpooled = jserve.SketchServer(pool=jskt.TenantPool(jspec, n_slots=3),
                                  query_path=jpath)
    singles = {t: tserve.SketchServer(tspec, query_path=tpath, device=CPU)
               for t in range(3)}
    for rnd in range(3):
        cols = [(t, _mk(np.random.default_rng(10 * rnd + t), 256, 0, 2400))
                for t in range(3)]
        pooled.ingest_many([(t, _tb(c)) for t, c in cols])
        jpooled.ingest_many([(t, _jb(c)) for t, c in cols])
        for t, c in cols:
            singles[t].ingest(_tb(c))
    reqs, jreqs, refs = [], [], []
    for t in range(3):
        for v in range(0, 24, 3):
            reqs.append(pooled.submit("vertex", tenant=t, v=v, lv=v % 3))
            jreqs.append(jpooled.submit("vertex", tenant=t, v=v, lv=v % 3))
            refs.append(singles[t].submit("vertex", v=v, lv=v % 3))
        for last in (None, 1):
            kw = dict(src=1, la=1, dst=2, lb=2, last=last)
            reqs.append(pooled.submit("edge", tenant=t, **kw))
            jreqs.append(jpooled.submit("edge", tenant=t, **kw))
            refs.append(singles[t].submit("edge", **kw))
    assert pooled.flush() == len(reqs) == jpooled.flush()
    for s in singles.values():
        s.flush()
    assert [r.answer for r in reqs] == [r.answer for r in refs] == \
        [r.answer for r in jreqs]
    for kind in ("vertex", "edge"):
        for a, b in zip(pooled.top_k(kind, 8, tenant=1),
                        jpooled.top_k(kind, 8, tenant=1)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pool_mode_tenant_argument_validation():
    tspec, _ = _serve_specs(1)
    pool = tskt.TenantPool(tspec, n_slots=2, device=CPU)
    pooled = tserve.SketchServer(pool=pool, query_path="scan")
    single = tserve.SketchServer(tspec, query_path="scan", device=CPU)
    b = _tb(_mk(np.random.default_rng(4), 32, 0, 100))
    with pytest.raises(ValueError, match="tenant="):
        pooled.ingest(b)
    with pytest.raises(ValueError, match="pool"):
        single.ingest(b, tenant=0)
    with pytest.raises(ValueError, match="tenant="):
        pooled.submit("vertex", v=1, lv=0)
    with pytest.raises(ValueError, match="tenant="):
        single.submit("vertex", tenant=0, v=1, lv=0)
    with pytest.raises(ValueError, match="ingest_many"):
        single.ingest_many([(0, b)])
    with pytest.raises(ValueError):
        tserve.SketchServer(spec=tspec.replace(n_shards=4), pool=pool)
    with pytest.raises(ValueError, match="collective"):
        tserve.SketchServer(pool=pool, query_path="collective")
    with pytest.raises(ValueError, match="budget_report"):
        pooled.budget_report()
    with pytest.raises(ValueError, match="detector"):
        single.budget_report()


def test_pool_mode_ingest_many_order_invariant():
    tspec, jspec = _serve_specs(2)
    cols = {t: _mk(np.random.default_rng(40 + t), 128, 0, 2400)
            for t in range(3)}

    def run(order):
        pool = tskt.TenantPool(tspec, n_slots=3, device=CPU)
        for t in range(3):
            pool.attach(t)
        srv = tserve.SketchServer(pool=pool, query_path="scan")
        srv.ingest_many([(t, _tb(cols[t])) for t in order])
        return srv.state

    jpool = jskt.TenantPool(jspec, n_slots=3)
    for t in range(3):
        jpool.attach(t)
    jsrv = jserve.SketchServer(pool=jpool, query_path="scan")
    jsrv.ingest_many([(t, _jb(cols[t])) for t in (1, 2, 0)])
    s1, s2 = run([0, 1, 2]), run([2, 0, 1])
    for x, y in zip(tskt.to_numpy(s1), tskt.to_numpy(s2)):
        np.testing.assert_array_equal(x, y)
    _leaves_equal(s1, jsrv.state)


def test_budget_report_and_serving_summary_match_repro():
    """The detector's splits, the query-endpoint log, ``budget_report``
    and the summary line (with a fresh plane counter) as ``repro``'s."""
    tspec, jspec = _serve_specs(4)
    t = tserve.SketchServer(tspec, heat_threshold=0.05, split_replicas=2,
                            query_path="scan", device=CPU)
    j = jserve.SketchServer(jspec, heat_threshold=0.05, split_replicas=2,
                            query_path="scan")
    rng = np.random.default_rng(7)
    for _ in range(3):
        c = _mk(rng, 300, 0, 2400)
        c[0][: 150] = 7
        c[2][: 150] = 1
        t.ingest(_tb(c))
        j.ingest(_jb(c))
    for v in range(12):
        t.submit("vertex", v=v, lv=v % 3)
        j.submit("vertex", v=v, lv=v % 3)
        t.submit("edge", src=v, la=v % 3, dst=1, lb=1)
        j.submit("edge", src=v, la=v % 3, dst=1, lb=1)
    t.flush()
    j.flush()
    np.testing.assert_array_equal(t.query_shard_counts, j.query_shard_counts)
    assert t.live_spec.routing.splits == j.live_spec.routing.splits != ()
    assert t.budget_report().to_json() == j.budget_report().to_json()
    tail = lambda s: s.split("] ", 1)[1]  # noqa: E731 (past the counters)
    assert tail(t.serving_summary()) == tail(j.serving_summary())
    _leaves_equal(t.state, j.state)


# --------------------------------------------------------------------------
# BigramSketch and the token helpers
# --------------------------------------------------------------------------

def test_token_helpers_match_repro():
    toks = np.random.default_rng(0).integers(0, 50304, (3, 17))
    for n_bands in (4, 6):
        np.testing.assert_array_equal(
            ttokens.token_band(toks, n_bands, 50304),
            jtokens.token_band(toks, n_bands, 50304))
        t, j = ttokens.bigram_stream(toks, n_bands), \
            jtokens.bigram_stream(toks, n_bands)
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_array_equal(ttokens.zipf_unigram(100, 1.5),
                                  jtokens.zipf_unigram(100, 1.5))
    cfg = dict(vocab_size=500, batch_size=2, seq_len=16, seed=3)
    np.testing.assert_array_equal(
        ttokens.SyntheticCorpus(ttokens.TokenPipelineConfig(**cfg)).batch_at(
            5),
        jtokens.SyntheticCorpus(jtokens.TokenPipelineConfig(**cfg)).batch_at(
            5))
    pipe = ttokens.TokenPipeline(ttokens.TokenPipelineConfig(**cfg))
    first = next(pipe)
    pipe.close()
    assert first["cursor"] == 0 and pipe.state() == {"cursor": 1}
    np.testing.assert_array_equal(first["tokens"], jtokens.SyntheticCorpus(
        jtokens.TokenPipelineConfig(**cfg)).batch_at(0)[:, :-1])


def test_bigram_sketch_matches_repro():
    t = BigramSketch(window_steps=8, subwindows=4, d=64, device=CPU)
    j = JBigram(window_steps=8, subwindows=4, d=64)
    rng = np.random.default_rng(2)
    corpus = ttokens.SyntheticCorpus(ttokens.TokenPipelineConfig(
        vocab_size=3000, batch_size=2, seq_len=32, seed=1))
    for step in range(10):
        toks = corpus.batch_at(step)
        t.ingest_tokens(toks)
        j.ingest_tokens(toks)
    for x, y in zip(t.sketch.state.leaves(), jax.tree.leaves(j.sketch.state)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    toks = corpus.batch_at(9).reshape(-1)
    for i in rng.integers(0, len(toks) - 1, 12):
        a, b = int(toks[i]), int(toks[i + 1])
        for last in (None, 2):
            assert t.bigram_weight(a, b, last=last) == \
                j.bigram_weight(a, b, last=last)
    for band in range(4):
        assert t.band_volume(band) == j.band_volume(band)
        assert t.drift(band) == pytest.approx(j.drift(band), abs=0)


# --------------------------------------------------------------------------
# chip_smoke.py phases V and M, rehearsed on the CPU
# --------------------------------------------------------------------------

def test_chip_smoke_phases_v_and_m_rehearse_on_the_cpu(monkeypatch, capsys):
    """Phases V and M at a tiny size on the CPU with the card's timers
    stubbed: every comparison must hold (the card-only launch counts are
    not asserted on CPU tensors)."""
    import time

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

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
    from repro_torch.core import LGSConfig, gss_config
    cfg = LSketchConfig(d=32, n_blocks=4, F=1024, r=8, s=8, c=16, k=8,
                        window_size=1440, pool_capacity=128, pool_probes=16)
    tcfg = dataclasses.replace(cfg, d=16)
    for name, value in (
            ("CFG", cfg), ("N_EDGES", 8000), ("N_QUERIES", 96),
            ("MAX_FLUSH", 1200), ("SERVER_REQUESTS", 256),
            ("TENANTS", 4), ("TENANT_EDGES", 3000), ("TENANT_QUERIES", 16),
            ("TENANT_CFG", tcfg), ("N_REACH", 8), ("BIGRAM_STEPS", 3),
            ("BIGRAM_BATCH", (2, 64)),
            ("CLI_ARGS", ("--edges", "1024", "--requests", "64")),
            ("GSS_CFG", gss_config(d=32, pool_capacity=64)),
            ("LGS_CFG", LGSConfig(d=32, copies=6, c=16, k=8,
                                  window_size=1440))):
        monkeypatch.setattr(chip_smoke, name, value)
    dev, tag = torch.device("cpu"), "[cpu]"
    spec, stream, flushes, _ = chip_smoke.deployment()
    v_launches, v_out, state = chip_smoke.server_phase(spec, stream, flushes,
                                                       dev, tag)
    out = capsys.readouterr().out
    for phase in ("V1", "V2", "V3", "V4", "V5"):
        assert f"phase {phase} " in out, phase
    assert v_out["mismatches"] == 0 and v_out["cli_runs"] == 4
    assert set(v_launches) == {"server", "server_pool", "bigram"}
    assert all(set(x) == set(chip_smoke.WRAPPERS)
               for x in v_launches.values())
    m_launches, m_out = chip_smoke.merge_phase(stream, state, dev, tag)
    out = capsys.readouterr().out
    for phase in ("M1", "M2", "M3"):
        assert f"phase {phase} " in out, phase
    assert out.count("plain replay on a CPU copy, leaf for leaf: equal") == 4
    assert m_out["m2_violations"] == 0
    assert set(m_launches) == set(chip_smoke.WRAPPERS)
    import json
    json.dumps({"server": v_out, "merge": m_out})
