"""The port's training slice against the JAX package on the CPU:
``softmax_xent``, the AdamW schedule and update, int8 gradient
compression (``compressed_psum`` on 2 gloo ranks against the reference
under ``jax.vmap(axis_name=)``), the flash attention's gradient through
its ``torch.autograd.Function`` (the plain backward) against
``jax.grad`` of ``reference_attention``, three train steps against the
reference's jitted ``make_train_step`` from one state, and the port's
``train()`` — the three training tests of ``tests/test_system.py``.

Tolerances: the loss and ``softmax_xent`` within 1e-6 relative (f32, one
reduction in another order); ``lr_at`` exactly (f32 tensor arithmetic on
both sides; within 1 ulp of the jitted train step's, whose f32
arithmetic XLA rewrites); an AdamW step from equal gradients within 1e-6 of each
parameter's scale; the quantised int8 values exactly and the means within
1e-6 (equal quantisation, f32 sums); the attention gradients within 1e-5
of the largest |gradient| (f32, sums in another order). Train steps:
the loss and gradient norm within 1e-5 relative, parameters within
STEP_ATOL, telemetry exactly. AdamW's update m / (sqrt(v) + eps) is ~lr
in size whatever the gradient's, so at the default eps = 1e-8 an entry
whose gradient is ~0 turns the two sides' rounding noise (1e-7 of the
leaf's scale) into updates of either sign (measured: 5 of 16,384 entries
of SmolLM's unembedding 1e-5 apart after 3 steps). These steps use eps
= 1e-3, where the update is a smooth function of the gradient and that
noise moves a parameter by ~lr 1e-4; the update's arithmetic at the
default eps is held by ``test_three_adamw_steps_match_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import shapes as jshapes
from repro.kernels.flash_attention.ref import reference_attention
from repro.launch import inputs as jinputs
from repro.launch import step_fns as jsteps
from repro.models.layers import softmax_xent as jxent
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp

import repro_torch.configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import step_fns as tsteps
from repro_torch.launch.train import train
from repro_torch.models import lm as tlm
from repro_torch.models.layers import softmax_xent as txent
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp

import torch_train_ranks

STEP_ATOL = 1e-6


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7), dtype=np.int32)
    mask = rng.random((3, 7)) < 0.6
    for m in (None, mask, np.zeros_like(mask)):
        want = float(jxent(jnp.asarray(logits), jnp.asarray(labels),
                           None if m is None else jnp.asarray(m)))
        got = float(txent(torch.from_numpy(logits), torch.from_numpy(labels),
                          None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)


def test_lr_schedule_is_the_references():
    cfg_j = jadamw.AdamWConfig(lr_peak=3e-3, warmup_steps=7, decay_steps=50)
    cfg_t = tadamw.AdamWConfig(lr_peak=3e-3, warmup_steps=7, decay_steps=50)
    for s in range(0, 60):
        want = np.float32(jadamw.lr_at(cfg_j, jnp.int32(s)))
        got = tadamw.lr_at(cfg_t, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert np.float32(got) == want, s
        assert np.float32(tadamw.lr_at(cfg_t, s)) == \
            np.float32(jadamw.lr_at(cfg_j, s)), s


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_three_adamw_steps_match_jax(moments):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[moments]
    cfg_j = jadamw.AdamWConfig(warmup_steps=2, decay_steps=10,
                               moment_dtype=jdt, clip_norm=0.5)
    cfg_t = tadamw.AdamWConfig(warmup_steps=2, decay_steps=10,
                               moment_dtype=tdt, clip_norm=0.5)
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    jp, js = p0, jadamw.init_opt_state(cfg_j, p0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = tadamw.init_opt_state(cfg_t, tp)
    for _ in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jp, js, jstats = jadamw.apply_updates(
            cfg_j, jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts, tstats = tadamw.apply_updates(
            cfg_t, tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        assert np.float32(tstats["lr"]) == np.float32(jstats["lr"])
        assert abs(float(tstats["grad_norm"]) - float(jstats["grad_norm"])) \
            <= 1e-6 * float(jstats["grad_norm"])
        for k in shapes:
            w = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())
            for tree in ("mu", "nu"):
                w = np.asarray(js[tree][k], np.float32)
                got = ts[tree][k].float().numpy()
                assert ts[tree][k].dtype == tdt
                ulp = 2.0 ** -7 if moments == "bf16" else 1e-6
                np.testing.assert_allclose(got, w, rtol=ulp,
                                           atol=1e-30)
        assert int(ts["step"]) == int(js["step"])


def test_int8_compression_matches_jax():
    rng = np.random.default_rng(2)
    for shape in ((1000,), (3, 256), (5, 7, 11)):
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        x.reshape(-1)[: min(300, x.size)] = 0.0  # an all-zero block
        qj, sj, nj = jcomp.compress_int8(jnp.asarray(x))
        qt, st, nt = tcomp.compress_int8(torch.from_numpy(x))
        assert nt == nj and qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(
            tcomp.decompress_int8(qt, st, nt, shape).numpy(),
            np.asarray(jcomp.decompress_int8(qj, sj, nj, shape)))


@pytest.fixture(scope="module")
def psum_run(tmp_path_factory):
    """3 steps of ``compressed_psum`` with error feedback on 2 gloo ranks
    (one spawn for the file), and the per-rank gradients fed."""
    rng = np.random.default_rng(3)
    shapes = {"w": (300,), "b": (4, 70)}
    grads = [[{k: (rng.standard_normal(s) * (r + 1)).astype(np.float32)
               for k, s in shapes.items()} for _ in range(3)]
             for r in range(2)]
    got = spawn_ranks(torch_train_ranks.compressed_psum_steps, 2,
                      device="cpu", args=(grads,),
                      init_file=tmp_path_factory.mktemp("psum") / "rdv")
    return grads, got


def test_compressed_psum_on_gloo_matches_jax(psum_run):
    grads, got = psum_run
    fn = jax.vmap(lambda g, e: jcomp.compressed_psum(g, "r", e),
                  axis_name="r")
    err = None
    for step, (mean_t, err_t) in enumerate(got):
        g = {k: jnp.stack([jnp.asarray(grads[r][step][k]) for r in range(2)])
             for k in grads[0][step]}
        if err is None:
            err = jax.tree.map(jnp.zeros_like, g)
        mean_j, err = fn(g, err)
        for k in g:
            np.testing.assert_allclose(mean_t[k], np.asarray(mean_j[k][0]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(err_t[k], np.asarray(err[k][0]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("B,Hq,Hkv,L,dh,causal", [
    (2, 4, 2, 37, 16, True), (1, 6, 2, 64, 64, True),
    (2, 4, 2, 128, 16, False), (1, 4, 4, 128, 64, False)])
def test_flash_gradient_matches_jax(B, Hq, Hkv, L, dh, causal):
    """dq, dk, dv through ``attention()``'s autograd ``FlashAttention``
    (plain forward with lse, ``flash_attention_backward_plain``) against
    ``jax.grad`` of ``reference_attention``; GQA, a ragged length."""
    rng = np.random.default_rng(L + dh)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, L, dh), (B, Hkv, L, dh), (B, Hkv, L, dh)))
    do = rng.standard_normal((B, Hq, L, dh)).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(
        reference_attention(a, b, c, causal) * do), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = fk.flash_attention_backward_kernel.launches
    out = attention(*ts, causal=causal)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    # on the CPU the wrapper takes the plain versions: no launch counted
    assert fk.flash_attention_backward_kernel.launches == before
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-5 * scale


def _spec_leaves(tree):
    """[(shape, dtype name)] of a spec tree in key order (JAX
    ShapeDtypeStructs or the port's (shape, dtype) pairs)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    if isinstance(tree, tuple) and len(tree) == 2 and \
            isinstance(tree[1], torch.dtype):
        return [(tuple(tree[0]), str(tree[1]).replace("torch.", ""))]
    return [(tuple(tree.shape), np.dtype(tree.dtype).name)]


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_shape_cells_and_input_specs_match_jax(arch):
    """``configs/shapes.py`` (cells, skip reasons, reduced cells) and
    ``launch/inputs.py`` (every input's shape and dtype at each full and
    reduced cell; ``random_inputs`` materialises them) against the
    reference's, at the arch's reduced config."""
    jcfg = jconfigs.get(arch, reduced=True)
    tcfg = tconfigs.get(arch, reduced=True)
    assert [(c.name, c.seq_len, c.global_batch, c.mode)
            for c in tshapes.SHAPES] == [
        (c.name, c.seq_len, c.global_batch, c.mode) for c in jshapes.SHAPES]
    assert [r for _, r in tshapes.applicable_shapes(tconfigs.get(arch))] == \
        [r for _, r in jshapes.applicable_shapes(jconfigs.get(arch))]
    gen = torch.Generator().manual_seed(0)
    for tc, jc in zip(tshapes.SHAPES, jshapes.SHAPES):
        for t, j in ((tc, jc), (tshapes.reduced_cell(tc),
                                jshapes.reduced_cell(jc))):
            assert (t.seq_len, t.global_batch) == (j.seq_len, j.global_batch)
            assert _spec_leaves(tinputs.input_specs(tcfg, t)) == \
                _spec_leaves(jinputs.input_specs(jcfg, j)), (arch, t.name)
        small = tshapes.reduced_cell(tc)
        got = tinputs.random_inputs(tcfg, small, gen, "cpu")
        assert _spec_leaves(jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
            jinputs.random_inputs(jcfg, jshapes.reduced_cell(jc),
                                  jax.random.PRNGKey(0)))) == \
            [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
             for x in _tensor_leaves(got)]
        toks = got["tokens"]
        assert int(toks.min()) >= 0 and int(toks.max()) < tcfg.vocab_size


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensor_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _tensor_leaves(v)]
    return [tree]


def test_prefill_and_serve_step_factories():
    """``make_prefill_step`` is the forward's logits with no graph;
    ``make_serve_step`` is ``lm.serve_step``."""
    cfg = tconfigs.get("smollm_135m", reduced=True)
    state = tsteps.init_train_state(cfg, tadamw.AdamWConfig(),
                                    torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    logits = tsteps.make_prefill_step(cfg)(state.params, {"tokens": toks})
    assert not logits.requires_grad
    want = tlm.forward(cfg, state.params, {"tokens": toks})[0].detach()
    assert torch.equal(logits, want)
    caches = tlm.init_cache(cfg, 2, 12, "cpu")
    step = tsteps.make_serve_step(cfg)
    for i in range(12):
        out, caches = step(state.params, caches, toks[:, i:i + 1])
        assert float((out[:, 0] - want[:, i]).abs().max()) < \
            1e-4 * float(want.abs().max())


def _seeded_batches(cfg, n, B, S, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        out.append({"tokens": toks[:, :-1].copy(),
                    "labels": toks[:, 1:].copy()})
    return out


@pytest.mark.parametrize("arch,microbatches", [
    ("smollm_135m", 1), ("smollm_135m", 2), ("kimi_k2_1t_a32b", 1)])
def test_three_train_steps_match_jax(arch, microbatches):
    jcfg = jconfigs.get(arch, reduced=True)
    tcfg = tconfigs.get(arch, reduced=True)
    kw = dict(lr_peak=1e-3, warmup_steps=2, decay_steps=10, eps=1e-3)
    jopt, topt = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    jstate = jsteps.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    tstate = tsteps.from_jax_train_state(
        tcfg, jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, microbatches))
    tstep = tsteps.make_train_step(tcfg, topt, microbatches)
    for batch in _seeded_batches(jcfg, 3, 4, 32):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        assert set(tm) == set(jm)
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-5 * abs(float(jm[k])), k
        # 1 ulp: under jit XLA rewrites the schedule's f32 arithmetic
        # (lr_at itself matches bit for bit, above)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=2e-7)
        if jcfg.n_experts:
            assert abs(float(tm["lb_loss"]) - float(jm["lb_loss"])) < 1e-5
            assert float(tm["dropped"]) == pytest.approx(float(jm["dropped"]),
                                                         abs=1e-6)
    want = tsteps.from_jax_train_state(tcfg,
                                       jax.tree.map(np.asarray, jstate))
    assert int(tstate.step) == int(want.step) == 3
    assert int(tstate.opt["step"]) == 3
    np.testing.assert_array_equal(tstate.telemetry.numpy(),
                                  want.telemetry.numpy())
    got = dict(tstate.params.named_parameters())
    for name, w in want.params.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   w.detach().numpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=name)
    if jcfg.n_experts:
        assert int(tstate.telemetry.sum()) > 0


def test_moe_drops_and_aux_losses_carry_the_references_gradients():
    """At capacity 0.25 (most (token, k) slots dropped) and no shared
    experts: a token whose every slot was dropped gets an exact zero
    gradient through the output (the scratch row's scatter passes none
    back), and the gradients of sum(y), lb_loss and z_loss with respect
    to x and every expert weight match ``jax.grad`` of the reference's
    layer (1e-5 of each one's largest |gradient|)."""
    from repro.models import moe as jmoe
    from repro.models.params import init_tree as jinit_tree

    from repro_torch.models import moe as tmoe

    jcfg = jconfigs.get("kimi_k2_1t_a32b", reduced=True).replace(
        n_shared_experts=0, capacity_factor=0.25)
    tcfg = tconfigs.get("kimi_k2_1t_a32b", reduced=True).replace(
        n_shared_experts=0, capacity_factor=0.25)
    jp = jinit_tree(jmoe.moe_defs(jcfg), jax.random.PRNGKey(2))
    x = np.random.default_rng(7).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)

    def jloss(p, xx, which):
        y, aux = jmoe.moe(p, xx, jcfg)
        return {"y": jnp.sum(y), "lb": aux["lb_loss"],
                "z": aux["z_loss"]}[which]

    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe(tp, tx, tcfg)
    for which, t in (("y", y.sum()), ("lb", aux["lb_loss"]),
                     ("z", aux["z_loss"])):
        want = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x), which)
        got = torch.autograd.grad(t, [tp[k] for k in jp] + [tx],
                                  retain_graph=True, allow_unused=True)
        for g, w in zip(got, [want[0][k] for k in jp] + [want[1]]):
            w = np.asarray(w)
            g = np.zeros_like(w) if g is None else g.numpy()
            assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30)
        if which == "y":
            gx = got[-1].reshape(-1, jcfg.d_model)
            dropped = (y.detach().reshape(-1, jcfg.d_model) == 0).all(1)
            assert 0 < int(dropped.sum()) < dropped.numel()
            assert bool((gx[dropped] == 0).all())
    assert float(aux["dropped"]) > 0.5


def test_from_jax_train_state_keeps_bf16_moments():
    """A reference state with bf16 moments carries across with bf16
    moments, leaf for leaf by name."""
    jcfg = jconfigs.get("smollm_135m", reduced=True)
    tcfg = tconfigs.get("smollm_135m", reduced=True)
    jopt = jadamw.AdamWConfig(moment_dtype=jnp.bfloat16)
    jstate = jsteps.init_train_state(jcfg, jopt, jax.random.PRNGKey(1))
    jstate = jstate._replace(opt=dict(jstate.opt, mu=jax.tree.map(
        lambda p: (p * 3).astype(jnp.bfloat16), jstate.params)))
    got = tsteps.from_jax_train_state(tcfg, jax.tree.map(np.asarray, jstate))
    params = dict(got.params.named_parameters())
    assert set(got.opt["mu"]) == set(params)
    for name, m in got.opt["mu"].items():
        assert m.dtype == torch.bfloat16 and got.opt["nu"][name].dtype == \
            torch.bfloat16
        want = (params[name].detach() * 3).to(torch.bfloat16)
        assert torch.equal(m, want), name


def test_train_loss_decreases(tmp_path):
    losses = train(arch="smollm-135m", steps=60, smoke=True, batch_size=4,
                   seq_len=64, ckpt_dir=str(tmp_path), ckpt_every=0,
                   log_every=100, lr_peak=3e-3, device="cpu")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.1, (first, last)


def test_train_moe_with_telemetry(tmp_path):
    stats = {}
    losses = train(arch="kimi-k2-1t-a32b", steps=12, smoke=True,
                   batch_size=2, seq_len=32, ckpt_dir=str(tmp_path),
                   ckpt_every=0, controller_every=4, log_every=100,
                   device="cpu", stats=stats)
    assert np.isfinite(losses).all()
    assert len(stats["cf"]) == 3  # steps 0, 4 and 8
    cfg = tconfigs.get("kimi-k2-1t-a32b", reduced=True)
    n_moe = sum(p.mlp == "moe" for p in tlm.plans(cfg)[0].layers)
    load = stats["telemetry"].load_vector()
    # the window holds the routing of steps 0 .. 8 (9 steps of 2 x 32
    # tokens, top-k edges a token a MoE layer) but for the pool's losses
    assert 0 < load.sum() <= 9 * 2 * 32 * cfg.top_k * n_moe


def test_train_cli_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train ... --device cpu``: three steps
    and the final checkpoint under the port's dotted leaf names."""
    import json

    from repro_torch.launch.train import main

    main(["--steps", "3", "--batch-size", "2", "--seq-len", "16",
          "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert "final loss" in capsys.readouterr().out
    meta = json.loads((tmp_path / "step_00000003" / "manifest.json")
                      .read_text())
    assert meta["extra"] == {"step": 3, "cursor": 3}
    assert meta["keys"][0] == "params.embed.tok"
    assert meta["keys"][-3:] == ["opt.step", "telemetry", "step"]


def test_checkpoint_resume_exact(tmp_path):
    train(arch="smollm-135m", steps=5, smoke=True, batch_size=2, seq_len=32,
          ckpt_dir=str(tmp_path), ckpt_every=0, log_every=100, seed=7,
          schedule_steps=10, device="cpu")
    resumed = train(arch="smollm-135m", steps=10, smoke=True, batch_size=2,
                    seq_len=32, ckpt_dir=str(tmp_path), ckpt_every=0,
                    log_every=100, resume=True, seed=7, device="cpu")
    fresh = train(arch="smollm-135m", steps=10, smoke=True, batch_size=2,
                  seq_len=32, ckpt_dir=str(tmp_path / "c"), ckpt_every=0,
                  log_every=100, seed=7, device="cpu")
    assert len(resumed) == 5
    np.testing.assert_array_equal(fresh[5:], resumed)


def test_chip_smoke_training_phases_rehearse_on_the_cpu(monkeypatch,
                                                        capsys):
    """``chip_smoke``'s L8 and L9 at the reduced configs on the CPU (the
    flash kernels' plain versions, the telemetry on the scan route), with
    the card's synchronisation stubbed: every comparison must hold; the
    launch checks only the card can pass must fail here."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    for name, value in (("LM_REDUCED", True), ("TRAIN_BATCH", 2),
                        ("TRAIN_SEQ", 32), ("TRAIN_MICROBATCHES", 2),
                        ("TRAIN_STEPS", 20), ("TRAIN_LR", 3e-3),
                        ("TRAIN_CKPT_EVERY", 10), ("TRAIN_CHECK_SEQ", 32)):
        monkeypatch.setattr(chip_smoke, name, value)
    dev, tag = torch.device("cpu"), "[cpu]"
    out = chip_smoke.train_phase(dev, tag)
    assert out["loss_last5"] < out["loss_first5"]
    assert out["check_loss_rel"] <= chip_smoke.TRAIN_REL
    assert out["flash_forward_launches"] == 0  # CPU tensors: plain
    assert set(out["profile_share_by_group"]) == {
        "flash_backward", "flash_forward", "matmul", "other"}
    with pytest.raises(AssertionError, match="L8: flash launches"):
        chip_smoke.check_train_on_the_card(
            tconfigs.get(chip_smoke.TRAIN_ARCH, reduced=True), out)
    moe = chip_smoke.moe_train_phase(dev, tag)
    assert moe["telemetry_equal"] and moe["load_vector_equal"]
    assert len(moe["capacity_factors"]) == 3
    with pytest.raises(AssertionError, match="L9: a kernel"):
        chip_smoke.check_moe_train_on_the_card(moe)
    text = capsys.readouterr().out
    assert "L8 train" in text and "L8 one step" in text and "L9 MoE" in text
    assert "L8 profile of one train step" in text
