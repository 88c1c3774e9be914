"""The tensor-parallel train step on gloo ranks of the CPU: the sharded
step over a ``("data", "model")`` mesh with several model ranks
(``launch.step_fns.sharded_grads``/``make_sharded_train_step``; the
models' split blocks, the "sp" fallback and the vocab-parallel loss)
against the port's single-device step and ``repro``'s loss and gradients.

Every state is a ``repro`` parameter tree (the structure of
``repro.models.lm.init_params``, leaves drawn by numpy from one seed)
carried over by ``lm.from_jax_params``, so the JAX oracle, the one-device step and the
split step start from the same parameters. Worlds 2 and 4 are each
spawned once for the module, in threads, while the oracles compute; the
rank bodies are ``tests/torch_tp_ranks.py``.

Tolerances (f32 on every side, the same math in another order): the loss
within 1e-5 of its value against both oracles; each gradient leaf within
1e-5 of that leaf's largest |gradient| against the one-device step, and
within 1e-4 against ``repro``, as ``tests/test_torch_train_archs.py``
holds the one-device gradient (the recurrent archs 1e-4 and 5e-4: their
scans carry the residual stream's gradient, summed over the model ranks
in another order, through f32 sums at every step, and a bias such as
Mamba's ``dt_bias`` sums them with cancellation); after
two steps the metrics within 1e-5 and the parameters within 1e-6 (AdamW
at eps = 1e-3, ``tests/test_torch_train.py``'s reason); the MoE
telemetry exactly; a resume bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm

from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.launch.step_fns import _grads, make_train_step
from repro_torch.models import attention, lm
from repro_torch.models.layers import embed, softmax_xent

import torch_tp_ranks as R

LOSS_REL, GRAD_REL, JAX_GRAD_REL = 1e-5, 1e-5, 1e-4
RECURRENT_GRAD_REL, RECURRENT_JAX_REL = 1e-4, 5e-4
METRIC_REL, PARAM_ATOL = 1e-5, 1e-6
RECURRENT = ("jamba_15_large_398b", "xlstm_13b")
ARCHS = sorted({a for cases in R.CASES.values() for a, _, _ in cases})
SPLIT = [(w, arch, shape) for w, cases in R.CASES.items()
         for arch, shape, _ in cases]


def _jax_params(arch):
    """``repro``'s parameter tree for the arch, its leaves drawn by numpy
    from one seed (norm scales about 1, the rest scaled by their fan-in)."""
    shapes = jax.eval_shape(
        lambda k: jlm.init_params(jconfigs.get(arch, reduced=True), k),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    paths, tree = jax.tree_util.tree_flatten_with_path(shapes)

    def draw(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        if "scale" in jax.tree_util.keystr(path):
            return 1.0 + 0.1 * x
        return x / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.1 * x

    return jax.tree_util.tree_unflatten(tree, [draw(p, s) for p, s in paths])


def _leaves(arch, params) -> dict:
    cfg = R.config(arch)
    tree = lm.from_jax_params(cfg, jax.tree.map(np.asarray, params))
    return {k: v.detach().numpy() for k, v in tree.named_parameters()}


def _vocab_inputs() -> dict:
    rng = np.random.default_rng(5)
    out = {}
    for v in R.VOCABS:
        out[v] = (rng.standard_normal((v, 8)).astype(np.float32),
                  rng.standard_normal((6, v)).astype(np.float32),
                  rng.integers(0, v, (2, 5)).astype(np.int32),
                  rng.integers(0, v, (6,)).astype(np.int32))
    return out


@pytest.fixture(scope="module")
def states():
    return {a: _jax_params(a) for a in ARCHS}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, states):
    """``{world: future of rank 0's results}``, both worlds spawned as the
    module starts so that the oracles compute meanwhile."""
    leaves = {a: _leaves(a, p) for a, p in states.items()}
    vocab = _vocab_inputs()
    n = torch.get_num_threads()
    torch.set_num_threads(1)

    # made here: the base temporary directory is not made thread-safely
    tmps = {w: tmp_path_factory.mktemp(f"tp{w}") for w in (2, 4)}

    def spawn(world):
        tmp = tmps[world]
        return spawn_ranks(R.run, world, device="cpu",
                           init_file=tmp / "rendezvous",
                           args=(world, str(tmp), leaves, vocab))

    with ThreadPoolExecutor(max_workers=2) as pool:
        yield {w: pool.submit(spawn, w) for w in (2, 4)}
    torch.set_num_threads(n)


_ORACLES: dict = {}


def _oracle(key, fn):
    if key not in _ORACLES:
        _ORACLES[key] = fn()
    return _ORACLES[key]


def _one_device(arch, leaves, microbatches):
    """The one-device step's loss and gradients on the whole batch, then
    STEPS steps' metrics and parameters."""
    cfg = R.config(arch)
    state = R.state_of(cfg, leaves)
    data = {k: torch.from_numpy(v) for k, v in R.batch(cfg).items()}
    loss, aux, grads = _grads(cfg, state.params, data)
    out = dict(loss=float(loss), grads={k: g.numpy()
                                        for k, g in grads.items()},
               telemetry=aux["telemetry"].numpy())
    step = make_train_step(cfg, R.OPT, microbatches)
    metrics = []
    for i in range(R.STEPS):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                R.batch(cfg, 10 + i).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"] = metrics
    out["params"] = {f"params.{k}": p.detach().numpy()
                     for k, p in state.params.named_parameters()}
    return out


def _jax(arch, params):
    """``repro``'s loss and gradients (by the port's names) on the batch."""
    jcfg = jconfigs.get(arch, reduced=True)
    cfg = R.config(arch)
    if cfg.n_experts:
        jcfg = jcfg.replace(capacity_factor=cfg.capacity_factor)
    b = {k: jnp.asarray(v) for k, v in R.batch(cfg).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))(params, b)
    tree = lm.from_jax_params(cfg, jax.tree.map(np.asarray, grads))
    return float(loss), {k: v.detach().numpy()
                         for k, v in tree.named_parameters()}


def _worst(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    out = {}
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        out[k] = float(np.abs(got[k] - w).max()) / scale
    return out


@pytest.mark.parametrize("world,arch,shape", SPLIT, ids=str)
def test_split_step_matches_one_device_and_jax(worlds, states, world, arch,
                                               shape):
    """The split step's loss and every gradient leaf equal the one-device
    step's and ``repro``'s from the same state; two steps' metrics and
    parameters equal the one-device step's."""
    mb = next(m for a, s, m in R.CASES[world] if (a, s) == (arch, shape))
    leaves = _leaves(arch, states[arch])
    want = _oracle(("one", arch, mb), lambda: _one_device(arch, leaves, mb))
    jloss, jgrads = _oracle(("jax", arch), lambda: _jax(arch, states[arch]))
    got = worlds[world].result()[(arch, shape)]

    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    assert abs(got["loss"] - jloss) <= LOSS_REL * abs(jloss)
    rel = RECURRENT_GRAD_REL if arch in RECURRENT else GRAD_REL
    bad = {k: v for k, v in _worst(got["grads"], want["grads"]).items()
           if v > rel}
    assert not bad, bad
    rel = RECURRENT_JAX_REL if arch in RECURRENT else JAX_GRAD_REL
    bad = {k: v for k, v in _worst(got["grads"], jgrads).items() if v > rel}
    assert not bad, bad
    np.testing.assert_array_equal(got["telemetry"], want["telemetry"])

    for g, w in zip(got["metrics"], want["metrics"]):
        assert set(g) == set(w)
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= METRIC_REL * abs(w[k]), (k, g, w)
        assert g["lr"] == w["lr"]
    for k, v in want["params"].items():
        err = float(np.abs(got["params"][k] - v).max())
        assert err <= PARAM_ATOL, (k, err)


def _flash_layers(cfg) -> int:
    dec, enc = lm.plans(cfg)
    plans = dec.layers + (enc.layers if enc else [])
    return sum(p.kind == "attn" and not p.window for p in plans)


@pytest.mark.parametrize("world,arch,shape", [
    (2, R.QWEN3, (1, 2)), (4, R.QWEN3, (1, 4)), (4, R.QWEN3, (2, 2)),
    (2, R.SMOL, (1, 2)), (2, "gemma3_4b", (1, 2))], ids=str)
def test_flash_runs_on_local_heads_or_offset_rows(worlds, world, arch,
                                                  shape):
    """Head-parallel layers call the flash kernel on the rank's heads
    ``[B_local, H/tp, L, dh]`` (and the KV heads its query heads read);
    the "sp" fallback (SmolLM's 3 heads on 2 ranks) on the rank's block of
    query rows ``[B_local, H, L/tp, dh]`` at ``q_offset = r L/tp``, against
    all keys."""
    cfg = R.config(arch)
    data, tp = shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = R.B // data
    mb = next(m for a, s, m in R.CASES[world] if (a, s) == (arch, shape))
    every = worlds[world].result()[(arch, shape)]["flash"]
    assert len(every) == data * tp
    b //= mb
    for rank, calls in enumerate(every):
        assert len(calls) == _flash_layers(cfg) * mb
        for q, k, off in calls:
            L = k[2]
            if H % tp == 0:
                _, kv, idx = attention._kv_heads(cfg, tp, rank % tp)
                kv = kv if idx is None else H // tp
                assert (q, k, off) == ((b, H // tp, L, dh), (b, kv, L, dh),
                                       0)
            else:
                r = rank % tp
                assert (q, k, off) == ((b, H, L // tp, dh), (b, KV, L, dh),
                                       r * L // tp)


@pytest.mark.parametrize("arch", RECURRENT)
def test_mixers_compute_on_their_channel_shards(worlds, arch):
    """At (1, 2) the recurrent mixers run on their channel shards: every
    mixer call of the split step holds di / 2 rows of ``w_out``."""
    cfg = R.config(arch)
    di = cfg.ssm_expand * cfg.d_model
    seen = worlds[2].result()[(arch, (1, 2))]["mixers"]
    assert len(seen) == sum(p.kind != "attn"
                            for p in lm.plans(cfg)[0].layers)
    assert {rows for _, (rows, _) in seen} == {di // 2}


@pytest.mark.parametrize("vocab", R.VOCABS)
def test_vocab_parallel_embedding_and_xent(worlds, vocab):
    """The embedding (a masked lookup of this rank's rows, summed over the
    ranks) and the cross entropy (max, sum of exponentials and gold logit
    over the ranks) equal the one-device functions, and so do their
    gradients joined over the ranks; a vocabulary that does not divide
    takes the whole path."""
    table, logits, tokens, labels = _vocab_inputs()[vocab]
    got = worlds[2].result()[("vocab", vocab)]
    cfg = R.configs.get(R.SMOL, reduced=True).replace(vocab_size=vocab)
    tab = torch.from_numpy(table).requires_grad_(True)
    lg = torch.from_numpy(logits).requires_grad_(True)
    x = embed({"tok": tab}, torch.from_numpy(tokens), cfg)
    loss = softmax_xent(lg, torch.from_numpy(labels))
    proj = torch.from_numpy(np.linspace(-1, 1, x.numel(), dtype=np.float32)
                            .reshape(x.shape))
    g_tab, g_lg = torch.autograd.grad(torch.sum(x * proj) + loss, [tab, lg])
    np.testing.assert_array_equal(got["x"], x.detach().numpy())
    loss = float(loss.detach())
    assert abs(got["loss"] - loss) <= LOSS_REL * abs(loss)
    np.testing.assert_array_equal(got["g_tab"], g_tab.numpy())
    assert np.abs(got["g_logits"] - g_lg.numpy()).max() <= \
        1e-6 * np.abs(g_lg.numpy()).max()


def test_split_resume_is_exact(worlds):
    """Reduced Qwen3 over (1, 2): three steps, a checkpoint and a resume to
    six give the unbroken run's losses bit for bit."""
    res = worlds[2].result()["resume"]
    assert res["resumed"] == res["straight"][R.RESUME_SPLIT:]
    assert len(res["straight"]) == 6


def test_chip_smoke_phase_l12_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke``'s L12 at the reduced SmolLM on the CPU (its meshes as
    spawned gloo ranks, the flash kernels' plain versions): every
    comparison must hold, and the launch check only the card can pass must
    fail here."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    run = dict(arch=cs.TRAIN_ARCH, reduced=True, batch=2, seq=32, steps=2)
    out = cs.tp_phase(torch.device("cpu"), "[cpu]", run)
    for name in ("1x3", "1x2"):
        assert out[name]["flash_calls_match"], out[name]
        assert out[name]["grad_rel_err"] <= cs.TRAIN_REL
        assert out[name]["collectives"]["all_reduce"]["calls"] > 0
    # reduced SmolLM: 3 heads, so 1 x 3 is head-parallel, 1 x 2 "sp"
    assert {c[2] for c in out["1x2"]["flash_call_shapes"]} == {0, 16}
    assert out["launches"]["flash_attention_kernel"] == 0  # plain versions
    with pytest.raises(AssertionError, match="L12: flash launches"):
        cs.check_tp_on_the_card(R.config(R.SMOL), out, steps=2)
    text = capsys.readouterr().out
    assert text.count("L12 smollm-smoke tensor parallel") == 2


def test_chip_smoke_l12_flash_rows_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.check_flash_tp_rows`` at the reduced SmolLM on the CPU
    (CUDA events replaced by a plain call): one forward and one backward
    row a distinct call shape of L12's ranks, the "sp" blocks at their
    offsets; a forward that is off by one ulp of its scale fails it."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    monkeypatch.setattr(cs, "LM_REDUCED", True)
    monkeypatch.setattr(cs, "TP_SEQ", 64)
    monkeypatch.setattr(cs, "_sync", lambda: None)
    monkeypatch.setattr(cs, "event_times",
                        lambda fn, reps: [fn() is None or 0.0])
    out = cs.check_flash_tp_rows(torch.device("cpu"), "[cpu]")
    cfg = R.config(R.SMOL)  # 3 heads over 1 KV head
    H, dh, B = cfg.n_heads, cfg.head_dim, cs.TP_BATCH
    want = [f"L12 q {[B, 1, 64, dh]} k {[B, 1, 64, dh]} q_offset 0",
            f"L12 q {[B, H, 32, dh]} k {[B, 1, 64, dh]} q_offset 0",
            f"L12 q {[B, H, 32, dh]} k {[B, 1, 64, dh]} q_offset 32"]
    for rows in out.values():
        assert [r["label"] for r in rows] == [w + " float32" for w in want]
        assert not any(r["out_of_tolerance"] for r in rows)

    plain = cs.flash_attention_plain

    def off(q, k, v, causal=True, lse=False, q_offset=0):
        o, s = plain(q, k, v, causal, True, q_offset)
        return (o + 1e-3, s) if lse else o + 1e-3

    monkeypatch.setattr(cs, "flash_attention_kernel", off)
    with pytest.raises(AssertionError, match="disagree"):
        cs.check_flash_tp_rows(torch.device("cpu"), "[cpu]")
