"""The cell estimator (``repro_torch.launch.dryrun``, ``perf_iter``)
against the reference's counts and a real sharded step.

The reference's own dry run cannot be the oracle: it fails on this box's
jax (``tests/test_multidevice.py::test_dryrun_machinery_small_mesh``, a
baseline failure). So:

  * parameter counts: ``repro``'s ``ModelConfig.param_count()`` and
    ``active_param_count()``, every arch at its published config;
  * state and collective bytes a device: one real sharded step of the
    port on a gloo world of 4 ranks, meshes (2, 2) and (1, 4) (both the
    tensor-parallel step), for a dense, a MoE and an MLA arch
    (``tests/torch_dryrun_ranks.py``): the local shards' ``nbytes`` and
    the result bytes of every collective the step issued, equal;
  * train-step FLOPs: ``repro.launch.hlo_analysis.analyze(...).flops`` of
    the reference's single-device ``jax.jit(make_train_step(cfg, opt))``
    compiled on the CPU (remat off), against the estimate with the plain
    attention (the dense masked products the reference differentiates),
    within FLOPS_REL (measured: equal).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as jconfigs
from repro.launch.hlo_analysis import analyze
from repro.launch.step_fns import init_train_state as jinit
from repro.launch.step_fns import make_train_step as jstep
from repro.optim import AdamWConfig as JAdamW

from repro_torch import configs
from repro_torch.configs.shapes import ShapeCell
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.launch import dryrun, perf_iter
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig

import torch_dryrun_ranks as R

FLOPS_REL = 5e-3
MESH_11 = AbstractMesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Rank 0's results of the world-4 sharded steps, spawned as the
    module starts."""
    tmp = tmp_path_factory.mktemp("world4")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with ThreadPoolExecutor(max_workers=1) as pool:
        yield pool.submit(spawn_ranks, R.run, 4, device="cpu",
                          init_file=tmp / "rendezvous")
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_counts_equal_the_reference(world4, arch):
    """The record's ``params_total``/``params_active`` at the published
    config (a short prefill, so that the estimate itself runs every
    layer) are the reference's counts."""
    rec = dryrun.estimate(configs.get(arch), ShapeCell("p", 8, 1, "prefill"),
                          MESH_11)
    jcfg = jconfigs.get(arch)
    assert rec["params_total"] == jcfg.param_count()
    assert rec["params_active"] == jcfg.active_param_count()
    shapes = lm.param_shapes(configs.get(arch))
    assert rec["memory_split"]["params"] == sum(
        torch.Size(s).numel() * d.itemsize for s, d in shapes.values())


@pytest.mark.parametrize("arch", R.ARCHS)
def test_state_and_collective_bytes_equal_a_real_sharded_step(world4, arch):
    """At mesh (2, 2): the parameter, gradient and moment bytes a device
    equal the real local shards', and the collective bytes of a step, by
    kind, the bytes counted through one real step (``DTensor``'s gathers
    and ``torch.distributed``'s calls)."""
    got = world4.result()[arch]
    rec = dryrun.estimate(configs.get(arch, reduced=True),
                          ShapeCell("t", R.S, R.B, "train"),
                          AbstractMesh(R.MESH, ("data", "model")),
                          R.MICROBATCHES, R.OPT)
    split = rec["memory_split"]
    for k in ("params", "moments", "grads"):
        assert split[k] == got[k], k
    coll = dict(rec["collective_bytes_per_device"])
    assert coll.pop("total") == sum(got["collective"].values())
    assert coll == got["collective"]
    assert got["collective"]["all-gather"] > split["gathered_params"] > 0
    if arch != "smollm_135m":  # the MoE's exchange over "model"
        assert got["ops"]["c10d.allgather_"] > 0


def _two_layers(cfg) -> int:
    """The bytes of the two largest layers' parameters, the embedding and
    the unembedding counting as layers."""
    by = {}
    for k, (s, d) in lm.param_shapes(cfg).items():
        parts = k.split(".")
        key = ".".join(parts[:2]) if parts[0] in ("layers", "encoder") \
            else k
        by[key] = by.get(key, 0) + torch.Size(s).numel() * d.itemsize
    return sum(sorted(by.values())[-2:])


@pytest.mark.parametrize("arch", R.ARCHS)
def test_split_cell_bytes_equal_a_real_split_step(world4, arch):
    """At mesh (1, 4), four model ranks: the state's bytes and the
    collective bytes by kind equal the real tensor-parallel step's (the
    per-layer gathers and their repeats in the backward, the model
    group's sums and gathers, the vocab-parallel loss); the gathered
    copies the estimate measures stay within two layers' parameters."""
    got = world4.result()[(R.SPLIT_MESH, arch)]
    cfg = configs.get(arch, reduced=True)
    rec = dryrun.estimate(cfg, ShapeCell("t", R.S, R.B, "train"),
                          AbstractMesh(R.SPLIT_MESH, ("data", "model")),
                          R.MICROBATCHES, R.OPT)
    split = rec["memory_split"]
    for k in ("params", "moments", "grads"):
        assert split[k] == got[k], k
    coll = dict(rec["collective_bytes_per_device"])
    assert coll.pop("total") == sum(got["collective"].values())
    assert coll == got["collective"]
    assert 0 < split["gathered_params"] <= _two_layers(cfg)
    assert 0 < split["full_grads"] <= split["gathered_params"]


def _reference_flops(arch: str, B: int, S: int) -> float:
    jcfg = jconfigs.get(arch, reduced=True)
    assert jcfg.remat == "none"
    state = jax.eval_shape(lambda: jinit(jcfg, JAdamW(),
                                         jax.random.PRNGKey(0)))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    compiled = jax.jit(jstep(jcfg, JAdamW())).lower(
        state, {"tokens": tok, "labels": tok}).compile()
    return analyze(compiled.as_text()).flops


@pytest.mark.parametrize("arch", R.ARCHS)
def test_train_flops_match_the_reference_hlo(arch):
    B, S = 2, 32
    want = _reference_flops(arch, B, S)
    rec = dryrun.estimate(
        configs.get(arch, reduced=True).replace(attn_impl="plain"),
        ShapeCell("t", S, B, "train"), MESH_11)
    got = rec["flops_per_device"]
    assert got["flash_forward"] == got["flash_backward"] == 0
    assert got["total"] == pytest.approx(want, rel=FLOPS_REL)


def test_flash_flops_follow_the_formula():
    """With the kernel attention, the flash calls count 4 dh a kept pair
    forward (causal: L (L + 1) / 2 a head) and 2.5 times that backward,
    one call each a GQA layer and microbatch; the plain attention's
    matmuls are gone from the matmul count."""
    cfg = configs.get("smollm_135m", reduced=True)
    B, S, mb = 4, 32, 2
    cell = ShapeCell("t", S, B, "train")
    rec = dryrun.estimate(cfg, cell, MESH_11, mb)
    plain = dryrun.estimate(cfg.replace(attn_impl="plain"), cell, MESH_11,
                            mb)
    f = rec["flops_per_device"]
    per_call = 4 * cfg.head_dim * (B // mb) * cfg.n_heads * S * (S + 1) // 2
    assert rec["flash_calls"] == 2 * cfg.n_layers * mb
    assert f["flash_forward"] == cfg.n_layers * mb * per_call
    assert f["flash_backward"] == 2.5 * f["flash_forward"]
    dense = 12 * cfg.head_dim * (B // mb) * cfg.n_heads * S * S
    assert plain["flops_per_device"]["matmul"] - f["matmul"] == \
        cfg.n_layers * mb * dense


def test_lower_cell_records_and_table(tmp_path, monkeypatch, capsys):
    """``run_cell`` writes a record with the reference's keys (lower_s and
    compile_s replaced by estimate_s), a skipped cell its reason;
    ``--table`` writes the roofline CSV; ``perf_iter --top`` ranks the
    estimate's sources."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "_dryrun_model_cfg", lambda arch: configs.get(
        arch, reduced=True).replace(param_dtype=torch.bfloat16,
                                    compute_dtype=torch.bfloat16))
    rec = dryrun.run_cell("smollm_135m", "decode_32k", False)
    for key in ("arch", "shape", "mesh", "mode", "chips", "seq_len",
                "global_batch", "estimate_s", "hlo_flops", "hlo_bytes",
                "collective_bytes", "memory", "roofline", "params_total",
                "params_active", "overrides"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert "lower_s" not in rec and "compile_s" not in rec
    skipped = dryrun.run_cell("smollm_135m", "long_500k", False)
    assert "skipped" in skipped
    dryrun.main(["--table"])
    text = (tmp_path / "roofline.csv").read_text().splitlines()
    assert text[0].split(",") == dryrun.TABLE_COLUMNS
    assert len(text) == 3 and any("SKIP" in line for line in text)
    top = perf_iter.top_contributors(rec)
    assert top["flops"] and top["collective_bytes"]
    assert perf_iter.parse_overrides(["attn_mat_dtype=bf16", "top_k=2",
                                      "capacity_factor=1.5"]) == {
        "attn_mat_dtype": torch.bfloat16, "top_k": 2,
        "capacity_factor": 1.5}


def test_chip_smoke_estimate_phase_rehearses_on_the_cpu(monkeypatch,
                                                        capsys):
    """``chip_smoke``'s E1 at the reduced configs against measurements
    made up from L8's and L2's own formulas (L3's peak from the
    estimate's): the FLOPs agree (L8's count
    takes the norms' parameters too), a peak within the margin passes and
    one outside it fails the phase."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    for name, value in (("LM_REDUCED", True), ("TRAIN_BATCH", 2),
                        ("TRAIN_SEQ", 32), ("TRAIN_MICROBATCHES", 2),
                        ("PREFILL_LEN", 32)):
        monkeypatch.setattr(cs, name, value)
    cfg = configs.get(cs.TRAIN_ARCH, reduced=True)
    qcfg = configs.get(cs.LM_ARCH, reduced=True)
    n_params = sum(torch.Size(s).numel()
                   for s, _ in lm.param_shapes(cfg).values())
    mb = cs.TRAIN_BATCH // cs.TRAIN_MICROBATCHES
    attn = cs.flash_flops(mb, cfg.n_heads, cs.TRAIN_SEQ, cfg.head_dim)
    l8_flops = 6 * n_params * cs.TRAIN_BATCH * cs.TRAIN_SEQ + \
        3 * cs.n_flash_layers(cfg) * attn * cs.TRAIN_MICROBATCHES
    L, V, D = cs.PREFILL_LEN, qcfg.vocab_size, qcfg.d_model
    l2 = dict(prefill_matmul_flops=2 * L * (qcfg.param_count() - V * D),
              prefill_attention_flops=cs.n_flash_layers(qcfg) * cs.flash_flops(
                  1, qcfg.n_heads, L, qcfg.head_dim))
    # the estimates themselves, as the phase makes them
    mesh = AbstractMesh((1, 1), ("data", "model"))
    opt = AdamWConfig(lr_peak=cs.TRAIN_LR, warmup_steps=max(
        2, cs.TRAIN_STEPS // 20), decay_steps=cs.TRAIN_STEPS)
    p8 = dryrun.estimate(cfg, ShapeCell("l8", cs.TRAIN_SEQ, cs.TRAIN_BATCH,
                                        "train"), mesh,
                         cs.TRAIN_MICROBATCHES, opt)["memory"]["peak_bytes"]
    p2 = dryrun.estimate(qcfg, ShapeCell("l2", L, 1, "prefill"),
                         mesh)["memory"]["peak_bytes"]
    p3 = dryrun.estimate(qcfg, ShapeCell("l3", cs.SERVE["max_seq"],
                                         cs.SERVE["batch_slots"], "decode"),
                         mesh)["memory"]["peak_bytes"]
    for scale in (1.05, 1.25):
        l8 = dict(peak_memory_bytes=round(p8 * scale), step_ms=10.0,
                  model_flops_per_step=l8_flops)
        l2["lm_peak_memory_bytes"] = round(p2 * scale)
        l2["decode_peak_memory_bytes"] = round(p3 * scale)
        if scale > 1 + cs.ESTIMATE_MEMORY_MARGIN:
            with pytest.raises(AssertionError, match="E1: a memory"):
                cs.estimate_phase(l8, l2, "[cpu]")
            continue
        out = cs.estimate_phase(l8, l2, "[cpu]")
        assert out["train"]["peak_rel_err"] == pytest.approx(1 / scale - 1,
                                                             abs=1e-5)
        assert out["prefill"]["estimate_peak_bytes"] == p2
        assert abs(out["train"]["flops_rel_err"]) < 1e-2
        assert out["prefill"]["matmul_rel_err"] == 0
        assert out["prefill"]["attention_rel_err"] == 0
        assert out["decode"]["estimate_peak_bytes"] == p3
        assert out["decode"]["peak_rel_err"] == pytest.approx(
            1 / scale - 1, abs=1e-5)
        assert out["decode"]["matmul_over_weight_flops"] >= 1
        assert out["train"]["bound_ms"] > 0
    text = capsys.readouterr().out
    assert "E1 estimator at L8's cell" in text
    assert "E1 estimator at L3's decode step" in text


def test_chip_smoke_estimate_phase_holds_l12s_split_cell(monkeypatch,
                                                         capsys):
    """E1 with L12's measurements: the estimator at L12's first mesh (three
    model ranks, the reduced SmolLM) against a made-up rank-0 peak; within
    the margin it passes and reports the split step's useful FLOP ratio,
    outside it fails the phase."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    for name, value in (("LM_REDUCED", True), ("TRAIN_BATCH", 2),
                        ("TRAIN_SEQ", 32), ("TRAIN_MICROBATCHES", 2),
                        ("PREFILL_LEN", 32), ("TP_SEQ", 32)):
        monkeypatch.setattr(cs, name, value)
    big = 10 ** 15  # L8's, L2's and L3's peaks: kept inside the margin
    cfg = configs.get(cs.TRAIN_ARCH, reduced=True)
    shape = cs.TP_MESHES[0]
    want = dryrun.estimate(cfg, ShapeCell("l12", cs.TP_SEQ, cs.TP_BATCH,
                                          "train"),
                           AbstractMesh(shape, ("data", "model")), 1,
                           AdamWConfig(lr_peak=cs.TRAIN_LR, warmup_steps=2,
                                       decay_steps=10, eps=1e-3))
    monkeypatch.setattr(cs.dryrun, "estimate", lambda *a, **k: dict(
        want, memory=dict(want["memory"], peak_bytes=big))
        if a[1].name != "l12" else want)
    l8 = dict(peak_memory_bytes=big, step_ms=10.0, model_flops_per_step=1)
    l2 = dict(prefill_matmul_flops=1, prefill_attention_flops=1,
              lm_peak_memory_bytes=big, decode_peak_memory_bytes=big)
    name = "x".join(map(str, shape))
    peak = want["memory"]["peak_bytes"]
    for scale, ok in ((1.05, True), (1.25, False)):
        l12 = {name: dict(peak_memory_bytes=round(peak * scale),
                          collectives={})}
        if not ok:
            with pytest.raises(AssertionError, match="E1: a memory"):
                cs.estimate_phase(l8, l2, "[cpu]", l12)
            continue
        out = cs.estimate_phase(l8, l2, "[cpu]", l12)["split_train"]
        assert out["peak_rel_err"] == pytest.approx(1 / scale - 1, abs=1e-5)
        assert 0.5 < out["useful_flops_ratio"] <= 1.0
    assert "E1 estimator at L12's 1x3 cell" in capsys.readouterr().out
