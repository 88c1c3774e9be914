"""The port stands alone (no JAX, nothing of ``repro``) and keeps the
device and handle rules of its entry points."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import sketch as tskt
from repro_torch.core.types import EdgeBatch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # does its work only under __main__
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(mods), bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_mods = int(out.stdout.split()[0])
    assert n_mods >= 50


SPEC = dict(d=16, n_blocks=2, F=256, r=4, s=4, c=4, k=4, window_size=100,
            pool_capacity=8, pool_probes=2)


def test_every_c_entry_has_its_ctypes_signature():
    """Each ``extern "C"`` entry of ``csrc/*.cu`` is in ``build.SIGNATURES``
    with one ``c_void_p`` per pointer and the stream and one ``c_int`` per
    int, in order: ctypes would pass an undeclared pointer as a 32-bit
    int."""
    import ctypes
    import re

    from repro_torch.kernels import build

    entries = {}
    for src in build.CSRC.glob("*.cu"):
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            entries[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                             for p in params.split(",")]
    assert entries and set(entries) == set(build.SIGNATURES)
    for name, argtypes in entries.items():
        assert build.SIGNATURES[name] == argtypes, name


def test_entry_points_default_to_the_card():
    from repro_torch import configs
    from repro_torch.launch.serve import DecodeServer
    from repro_torch.models import lm

    spec = tskt.make_spec("lsketch", n_shards=2, **SPEC)
    cfg = configs.get("smollm-135m", reduced=True)
    params = lm.init_params(cfg, device="cpu")
    if torch.cuda.is_available():
        assert tskt.create(spec).device.type == "cuda"
        assert lm.init_params(cfg).device.type == "cuda"
        assert lm.init_cache(cfg, 1, 8)[0]["mixer"]["k"].device.type == "cuda"
        with pytest.raises(ValueError, match="parameters lie on cpu"):
            DecodeServer(cfg, params)
    else:
        for entry in (lambda: tskt.create(spec), lambda: lm.init_params(cfg),
                      lambda: lm.init_cache(cfg, 1, 8),
                      lambda: DecodeServer(cfg, params)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                entry()
    assert tskt.create(spec, device="cpu").device.type == "cpu"
    assert params.device.type == "cpu"
    assert DecodeServer(cfg, params, device="cpu").caches[0]["mixer"][
        "k"].device.type == "cpu"


def test_ingest_spends_the_old_handle_and_starts_a_cold_cache():
    spec = tskt.make_spec("lsketch", n_shards=2, **SPEC)
    st = tskt.create(spec, device="cpu")
    rng = np.random.default_rng(0)
    b = EdgeBatch.from_arrays(rng.integers(0, 40, 64), rng.integers(0, 40, 64),
                              weight=rng.integers(1, 3, 64),
                              time=np.full(64, 3))
    q = tskt.QueryBatch.vertices(np.arange(8), np.zeros(8, np.int32))
    st1 = tskt.ingest(spec, st, b.slice(0, 32), path="cuda")
    w1 = tskt.query(spec, st1, q, path="cuda")
    assert tskt.query_planes(spec, st1) is tskt.query_planes(spec, st1, 9)
    st2 = tskt.ingest(spec, st1, b.slice(32, 64), path="cuda")
    assert st2 is not st1 and st2.shards is st1.shards
    with pytest.raises(RuntimeError, match="consumed by ingest"):
        tskt.query(spec, st1, q)
    with pytest.raises(RuntimeError, match="consumed by ingest"):
        tskt.ingest(spec, st1, b)
    w2 = tskt.query(spec, st2, q, path="cuda")
    assert int(w2.sum()) > int(w1.sum())  # no stale planes
    np.testing.assert_array_equal(
        w2.numpy(), tskt.query(spec, st2, q, path="scan").numpy())


@pytest.mark.parametrize("kind", ["gss", "lgs"])
def test_unported_kinds_raise(kind):
    """Every kind of the reference is ported now: ``gss`` and ``lgs`` make
    specs, and only a kind the reference lacks raises."""
    assert tskt.make_spec(kind, n_shards=1).kind == kind
    with pytest.raises(ValueError, match="kind must be one of"):
        tskt.make_spec(kind + "x", n_shards=1)


def test_dense_vertex_scan_is_independent_of_its_query_chunk():
    from repro_torch.core.queries import vertex_query

    spec = tskt.make_spec("lsketch", n_shards=1, **SPEC)
    st = tskt.create(spec, device="cpu")
    rng = np.random.default_rng(2)
    b = EdgeBatch.from_arrays(rng.integers(0, 30, 400),
                              rng.integers(0, 30, 400), weight=np.ones(400),
                              edge_label=rng.integers(0, 4, 400),
                              time=np.sort(rng.integers(0, 90, 400)))
    st = tskt.ingest(spec, st, b, path="scan")
    one = st.shards.map(lambda x: x[0])
    v = torch.arange(-1, 30, dtype=torch.int32)
    labels = (torch.zeros_like(v), torch.remainder(v, 4))
    for direction in ("out", "in"):
        whole = vertex_query(spec.config, one, v, labels, direction, True)
        for chunk in (1, 7):
            part = vertex_query(spec.config, one, v, labels, direction, True,
                                chunk=chunk)
            for a, c in zip(whole, part):
                assert torch.equal(a, c)


def test_chip_smoke_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke``'s phases in ``main``'s order at a tiny size on the
    CPU, with the card's timers stubbed: every comparison must hold and
    every bound must count no more bytes than its inputs and outputs hold.
    ``main`` itself runs on the card only: without one it exits non-zero
    and prints no result."""
    import json
    import time

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from repro_torch.core.types import LSketchConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out

    class _Event:
        def __init__(self, enable_timing=True):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return 1e3 * (other.t - self.t)

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cfg = LSketchConfig(d=32, n_blocks=4, F=1024, r=8, s=8, c=16, k=8,
                        window_size=1440, pool_capacity=128, pool_probes=16)
    for name, value in (("CFG", cfg), ("N_EDGES", 8000), ("N_QUERIES", 96),
                        ("MAX_FLUSH", 1200)):
        monkeypatch.setattr(chip_smoke, name, value)
    dev, tag = torch.device("cpu"), "[cpu]"
    spec, stream, flushes, span_i = chip_smoke.deployment()
    results = {"sketch_insert_kernel_sharded": chip_smoke.check_insert_kernel(
        cfg, spec, [stream.slice(*f) for f in flushes[:2]], dev, tag)}
    assert "loaded state" in capsys.readouterr().out
    qi = chip_smoke.query_inputs(cfg, stream)
    capture = chip_smoke.PoolCapture()

    def main_path():  # CPU tensors launch nothing: no kernel is required
        state, _, _ = chip_smoke.ingest_stream(cfg, spec, stream, flushes,
                                               span_i, dev, tag, capture)
        return state, chip_smoke.run_queries(spec, state, qi, tag)

    (state, answers), launches = chip_smoke.count_launches((), main_path)
    assert set(launches) == set(chip_smoke.WRAPPERS)
    assert capsys.readouterr().out.count("CPU clone of shard 0") == 3
    results.update(chip_smoke.check_pool_kernel(capture, tag))  # phase 3b
    assert int(capture.items[6].sum()) > 0  # the flush had rejects
    chip_smoke.check_scan_path(spec, state, qi, answers)
    results.update(chip_smoke.check_query_kernels(cfg, spec, state, qi, dev,
                                                  tag))
    tskt.clear_plane_cache(state)
    got, _ = chip_smoke.count_launches((), lambda: chip_smoke.analytics_path(
        cfg, spec, state, qi, answers, tag))
    results.update(chip_smoke.check_analytics(cfg, spec, state, got, tag))
    assert "reachable" in capsys.readouterr().out
    profile = chip_smoke.profile_ingest(spec, state, stream, flushes, tag)
    assert profile["profile_launches"] == 0  # the CPU launches nothing
    del state

    # phase O at a tiny size: the GSS replay runs in its child process
    from repro_torch.core import LGSConfig, gss_config
    for name, value in (("OBJ_EDGES", 6000), ("N_SCALAR", 12),
                        ("N_OBJ_REACH", 4), ("N_SUBGRAPHS", 4),
                        ("DROP_IN_EDGES", 300),
                        ("GSS_CFG", gss_config(d=32, pool_capacity=64)),
                        ("LGS_CFG", LGSConfig(d=32, copies=6, c=16, k=8,
                                              window_size=1440))):
        monkeypatch.setattr(chip_smoke, name, value)
    obj_rows, o_launches, obj_out = chip_smoke.object_phase(dev, tag)
    out = capsys.readouterr().out
    for phase in ("O1", "O2", "O3", "O4", "O5", "O6"):
        assert f"phase {phase} " in out, phase
    assert out.count("CPU replay through the plain versions vs the card, "
                     "leaf for leaf: equal") == 3
    assert out.count("vs the card, leaf for leaf: equal") == 5
    assert obj_out["lsketch"]["plane_builds"] == 2
    assert obj_out["gss"]["query_mismatches"] == 0
    assert set(obj_rows) == set(chip_smoke.OBJECT_KERNELS)
    results.update(obj_rows)

    # L1-L3 at the reduced Qwen3 config: the kernel's plain version on the
    # CPU, so the card-only launch and TF32 checks are not run
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    flash_cases = (("small", 1, 4, 2, 96, 16, torch.float32),
                   ("bf16", 1, 4, 2, 70, 32, torch.bfloat16))
    for name, value in (("LM_REDUCED", True), ("PREFILL_LEN", 64),
                        ("DECODE_CHECK", 16), ("PLAIN_CHUNK_THRESHOLD", 16),
                        ("SERVE", dict(batch_slots=2, max_seq=32, requests=3,
                                       prompt=6, max_new=4)),
                        ("FLASH_CASES", flash_cases), ("FLASH_REPS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    results.update(chip_smoke.check_flash_kernel(dev, tag))
    cfg_lm, params = chip_smoke.lm_model(dev, tag)
    lm_out, tokens, head = chip_smoke.prefill_phase(cfg_lm, params, dev, tag)
    assert lm_out["prefill_flash_launches"] == 0  # CPU tensors: plain
    assert lm_out["prefill_logit_rel_err"] <= chip_smoke.LOGIT_TOL
    with pytest.raises(AssertionError, match="flash launches"):
        chip_smoke.check_prefill_on_the_card(cfg_lm, lm_out)
    lm_out.update(chip_smoke.serve_phase(cfg_lm, params, tokens, head, dev,
                                         tag))
    assert lm_out["decode_steps"] > 0
    assert lm_out["decode_logit_rel_err"] <= chip_smoke.LOGIT_TOL
    assert "3 of 3 requests done" in capsys.readouterr().out

    kernels = chip_smoke.kernel_entries(
        results, {n: 0 for n in chip_smoke.KERNELS})
    json.dumps({"kernels": kernels, "object": obj_out, **lm_out})
    assert [k["mismatches"] for k in kernels] == [0] * 9
    assert {k["name"] for k in kernels} == set(chip_smoke.WRAPPERS) | set(
        chip_smoke.OBJECT_KERNELS) == set(chip_smoke.KERNELS)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(k) for k in kernels)
    flash = next(k for k in kernels if k["name"] == "flash_attention_kernel")
    assert flash["library_ms"] is not None
    # the first case: 4 dh operations per kept (query, key) pair; q, k, v
    # and out read or written once
    # (f32: three TF32 MMAs a product, split-TF32)
    ops_ms = 1e3 * 3 * 4 * 16 * 4 * 96 * 97 / 2 / \
        chip_smoke.TF32_FLOPS_PER_S
    bytes_ms = 1e3 * 4 * 96 * 16 * (4 + 2 + 2 + 4) / \
        chip_smoke.HBM_BYTES_PER_S
    assert flash["bound_ms"] == pytest.approx(max(ops_ms, bytes_ms))
    assert flash["bound_by"] == ("operations" if ops_ms > bytes_ms
                                 else "bytes")
    # no bound may count more than its inputs and outputs hold: key, cw
    # and pw planes read once (the insert: key, C and P at one slot read
    # and written once; the pool pass: its pool leaves) plus the per-item
    # inputs and outputs
    S, d = spec.n_shards, cfg.d
    plane = S * 2 * d * d * 4 * (2 + cfg.c)
    pool_leaves = S * 4 * (cfg.pool_capacity * (2 + cfg.k + cfg.k * cfg.c)
                           + 1)
    most = {"sketch_insert_kernel_sharded": 2 * plane +
            8000 * ((3 * cfg.s + 4) * 4 + 1),
            "pool_pass_kernel_sharded": pool_leaves + 8000 * 7 * 4,
            "sketch_query_kernel_sharded": plane +
            96 * ((3 * cfg.s + 1) * 4 + 3 * S * 4),
            "vertex_scan_kernel_sharded": plane +
            96 * ((cfg.r + 2) * 4 + 2 * S * 4),
            # the key plane read once, two owner planes written once
            "cell_decode_kernel_sharded": 3 * S * 2 * d * d * 4 +
            2 * cfg.n_blocks * 4,
            # the single-sketch entries at S = 1: a flush of the object
            # stream, and the fused probe and the scan on 96 queries
            "sketch_insert_kernel": 2 * plane // S + 6000 * (
                (3 * cfg.s + 4) * 4 + 1),
            "sketch_query_kernel": 2 * d * d * 4 * (2 + cfg.c) +
            cfg.pool_capacity * 4 * (3 + cfg.c) + 2 * cfg.n_blocks * 4 +
            96 * (5 * 4 + 2 * 4),
            "vertex_scan_kernel": plane // S + 96 * ((cfg.r + 2) * 4 + 2 * 4)}
    for k in kernels:
        if k["name"] == "flash_attention_kernel":
            continue  # operations bound, checked above
        for bound in ("bound_ms", "bound_ms_in"):
            if bound in k:
                nbytes = k[bound] * chip_smoke.HBM_BYTES_PER_S / 1e3
                assert 0 < nbytes <= most[k["name"]], (bound, k)
    # the fused edge-query entry at H horizons: the key plane and the pool
    # keys once, each horizon's counters, the block table, five inputs
    # and two outputs per (horizon, shard) a query
    probe = next(k for k in kernels
                 if k["name"] == "sketch_query_kernel_sharded")
    for bound, H in (("bound_ms_fused", 1),
                     ("bound_ms_fused_sweep", probe["fused_sweep_horizons"])):
        fused_most = S * 2 * d * d * 4 * (1 + H * (1 + cfg.c)) + \
            S * cfg.pool_capacity * 4 * (2 + H * (1 + cfg.c)) + \
            2 * cfg.n_blocks * 4 + 96 * (5 * 4 + 2 * H * S * 4)
        nbytes = probe[bound] * chip_smoke.HBM_BYTES_PER_S / 1e3
        assert 0 < nbytes <= fused_most, (bound, probe)
    assert probe["fused_mismatches"] == 0


def test_chip_smoke_reads_the_flash_kernels_ptxas_report(monkeypatch):
    """The phase-2 parser pairs each flash instance with its registers and
    spills; the L1 bound takes each variant's tensor-core rate."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    fn = "_ZN12_GLOBAL__N_126lsk_flash_attention_kernelI{}Li{}EEEvPKT_S3_"
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{fn.format(t, d)}' for "
        f"'sm_90a'\nptxas info    : Function properties for "
        f"{fn.format(t, d)}\n    0 bytes stack frame, {s} bytes spill "
        f"stores, {s} bytes spill loads\nptxas info    : Used {r} "
        f"registers, used 1 barriers, 400 bytes cmem[0]"
        for t, d, r, s in (("f", 128, 168, 0), ("13__nv_bfloat16", 64, 96, 8)))
    assert chip_smoke.flash_ptxas(log) == {("f32", 128): (168, 0, 0),
                                           ("bf16", 64): (96, 8, 8)}
    flops = chip_smoke.flash_flops(2, 32, 2048, 128)
    assert flops == 68_753_031_168
    ms, rate = chip_smoke.flash_ops_ms(flops, torch.bfloat16)
    assert ms == pytest.approx(0.0695, abs=1e-4) and "bf16" in rate
    ms, rate = chip_smoke.flash_ops_ms(
        chip_smoke.flash_flops(1, 32, 8192, 128), torch.float32)
    assert ms == pytest.approx(3.332, abs=1e-3) and "split-TF32" in rate
