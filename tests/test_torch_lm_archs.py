"""The port's LM serving for the seven architectures beyond the dense GQA
decoders — Gemma-3 (sliding-window layers), DeepSeek-V2 (MLA + MoE),
Kimi-K2 (MoE), Jamba (Mamba + attention + MoE), xLSTM (mLSTM/sLSTM),
phi-3-vision (vision prefix) and SeamlessM4T (encoder-decoder) — against
the JAX package on the CPU at the reduced configs, weights carried across
by ``lm.from_jax_params``; and the decode server on heterogeneous caches.

Tolerances (f32 on both sides, the same math in another order of
operations): logits within REL = 1e-5 of the largest logit, as
``tests/test_torch_lm.py``; the archs with recurrent mixers (Jamba's
Mamba, xLSTM's mLSTM and sLSTM) within RECURRENT_REL = 5e-5, since their
states carry f32 sums through every step and Mamba's in-chunk scan
associates in another order than ``lax.associative_scan`` (measured
1.1e-5 and 1.4e-5 at these sizes); the aux losses within 1e-5 absolute; the MoE
telemetry count matrices exactly. Decode against the port's own prefill:
1e-3 of the largest logit, the bound of
``tests/test_models.py::test_decode_matches_prefill``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import serve as jserve
from repro.models import lm as jlm

import repro_torch.configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm

NEW_ARCHS = ["gemma3_4b", "deepseek_v2_236b", "kimi_k2_1t_a32b",
             "jamba_15_large_398b", "xlstm_13b", "phi3_vision_42b",
             "seamless_m4t_medium"]
RECURRENT = ("jamba_15_large_398b", "xlstm_13b")
REL, RECURRENT_REL, AUX_TOL = 1e-5, 5e-5, 1e-5
B, S, FRAMES = 2, 12, 10


def _np(x):
    return np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def _pair(arch, **kw):
    """(JAX config, port config, JAX params, port params) of a reduced
    arch, the port's weights carried over from the JAX draw."""
    jcfg = jconfigs.get(arch, reduced=True).replace(**kw)
    tcfg = tconfigs.get(arch, reduced=True).replace(**kw)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, tlm.from_jax_params(
        tcfg, jax.tree.map(np.asarray, params))


def _batch(cfg, seed=1):
    """Tokens and, where the arch takes them, a vision prefix or frame
    embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    if cfg.frontend == "vision":
        batch["prefix_emb"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frame_emb"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_and_serve_step_match_jax(arch):
    """The prefill's logits and aux (the MoE losses, dropped share and
    telemetry, summed over layers), then S decode steps through
    ``serve_step`` (the encoder-decoder's with ``encode_memory``'s memory),
    each against the JAX package's, and the caches after them."""
    jcfg, tcfg, params, tp = _pair(arch)
    rel = RECURRENT_REL if arch in RECURRENT else REL
    batch = _batch(jcfg)
    want, jaux = jlm.forward(jcfg, params,
                             {k: jnp.asarray(v) for k, v in batch.items()})
    got, taux = tlm.forward(tcfg, tp, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    assert got.shape == (B, S, jcfg.vocab_size)
    assert _rel(want, got) < rel
    assert set(jaux) == set(taux)
    for k in ("lb_loss", "z_loss", "dropped"):
        assert abs(float(jaux[k]) - float(taux[k])) < AUX_TOL, k
    assert taux["telemetry"].dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jaux["telemetry"]),
                                  taux["telemetry"].numpy())
    if jcfg.n_experts:  # the routing stream: top_k edges a token a layer
        n_moe = sum(p.mlp == "moe" for p in tlm.plans(tcfg)[0].layers)
        assert int(taux["telemetry"].sum()) == B * S * jcfg.top_k * n_moe

    jmem = tmem = None
    if jcfg.is_encdec:
        jmem = jlm.encode_memory(jcfg, params,
                                 jnp.asarray(batch["frame_emb"]))
        tmem = tlm.encode_memory(tcfg, tp,
                                 torch.from_numpy(batch["frame_emb"]))
        assert _rel(jmem, tmem) < REL
    jc = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      jlm.init_cache_specs(jcfg, B, S))
    tc = tlm.init_cache(tcfg, B, S, device="cpu")
    toks = batch["tokens"]
    jstep = jax.jit(lambda p, c, t, m: jlm.serve_step(jcfg, p, c, t,
                                                      memory=m))
    for i in range(S):
        jl, jc = jstep(params, jc, jnp.asarray(toks[:, i:i + 1]), jmem)
        tl, tc = tlm.serve_step(tcfg, tp, tc, torch.from_numpy(
            toks[:, i:i + 1]), memory=tmem)
        assert _rel(jl, tl) < rel, i
    for li, (a, b) in enumerate(zip(jc, tc)):
        assert set(a["mixer"]) == set(b["mixer"])
        for name, x in a["mixer"].items():
            y = b["mixer"][name]
            assert tuple(x.shape) == tuple(y.shape), (li, name)
            assert str(y.dtype).split(".")[-1] == np.dtype(x.dtype).name
            if name == "pos":
                np.testing.assert_array_equal(np.asarray(x), y.numpy())
            elif np.abs(_np(x)).max() > 0:
                assert _rel(x, y) < 10 * rel, (li, name)


@pytest.mark.parametrize("arch", ["gemma3_4b", "deepseek_v2_236b",
                                  "xlstm_13b", "jamba_15_large_398b"])
def test_decode_matches_prefill(arch):
    """The port's decode through its caches (Gemma-3's local layers wrap
    their 8-row rings: 12 positions) against its own prefill; the MoE
    archs drop-free, as the decode is."""
    cfg = tconfigs.get(arch, reduced=True)
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    params = tlm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(_batch(cfg, seed=4)["tokens"])
    full, aux = tlm.forward(cfg, params, {"tokens": toks})
    assert float(aux["dropped"]) == 0.0
    caches = tlm.init_cache(cfg, B, S, device="cpu")
    steps = [tlm.serve_step(cfg, params, caches, toks[:, i:i + 1])[0]
             for i in range(S)]
    assert _rel(full, torch.cat(steps, 1)) < 1e-3


def _recording(server, log, reqs):
    """Wrap ``server._step`` to record each step's slot schedule (request
    indices) and logits."""
    inner = server._step

    def step(p, c, t):
        slots = tuple(None if s is None else
                      next(i for i, r in enumerate(reqs) if r is s)
                      for s in server.slots)
        logits, caches = inner(p, c, t)
        log.append((slots, _np(logits[:, 0])))
        return logits, caches

    server._step = step


@pytest.mark.parametrize("arch", ["gemma3_4b", "jamba_15_large_398b"])
def test_decode_server_matches_jax(arch):
    """More requests than slots, so refilled slots must start from zeroed
    rows of every cache leaf (ring buffers, recurrent states); Gemma-3's
    requests outrun its 8-row local rings (prompt + new > 8). The same
    schedule, per-step logits within REL and the same greedy tokens
    wherever the top two logits are further apart than that."""
    jcfg, tcfg, params, tp = _pair(arch)
    rng = np.random.default_rng(6)
    specs = [(list(map(int, rng.integers(0, jcfg.vocab_size, n))), m)
             for n, m in ((6, 5), (3, 9), (9, 2), (4, 7))]
    logs, outs = {}, {}
    for name, mod, cfg, p, kw in (("jax", jserve, jcfg, params, {}),
                                  ("torch", tserve, tcfg, tp,
                                   {"device": "cpu"})):
        reqs = [mod.Request(prompt=list(pr), max_new=m) for pr, m in specs]
        server = mod.DecodeServer(cfg, p, batch_slots=2, max_seq=24, **kw)
        logs[name] = []
        _recording(server, logs[name], reqs)
        server.run(reqs)
        outs[name] = [r.out for r in reqs]
        assert all(r.done for r in reqs)
    assert [s for s, _ in logs["jax"]] == [s for s, _ in logs["torch"]]
    for (_, a), (_, b) in zip(logs["jax"], logs["torch"]):
        scale = np.abs(a).max()
        assert np.abs(a - b).max() / scale < REL
        top2 = np.sort(a, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > REL * scale
        assert np.array_equal(a.argmax(-1)[clear], b.argmax(-1)[clear])
    assert outs["jax"] == outs["torch"]
    assert [len(o) for o in outs["torch"]] == [m for _, m in specs]


def test_decode_server_encoder_decoder():
    """SeamlessM4T through the server: each request's frames are encoded
    into its slot's memory row when it takes the slot, and its tokens
    equal a one-request greedy decode against that memory."""
    cfg = tconfigs.get("seamless_m4t_medium", reduced=True)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    rng = np.random.default_rng(7)
    reqs = [tserve.Request(
        prompt=list(map(int, rng.integers(0, cfg.vocab_size, 4))), max_new=3,
        frame_emb=rng.standard_normal((FRAMES, cfg.d_model)).astype(
            np.float32)) for _ in range(3)]
    server = tserve.DecodeServer(cfg, params, batch_slots=2, max_seq=16,
                                 device="cpu")
    server.run(reqs)
    for r in reqs:
        mem = tlm.encode_memory(cfg, params, torch.from_numpy(r.frame_emb)[
            None])
        caches = tlm.init_cache(cfg, 1, 16, device="cpu")
        toks, out = list(r.prompt), []
        for i in range(len(r.prompt) + 2):
            lg, caches = tlm.serve_step(cfg, params, caches, torch.tensor(
                [[toks[i]]], dtype=torch.int32), memory=mem)
            if i >= len(r.prompt) - 1:
                out.append(int(lg[0, 0].argmax()))
                toks.append(out[-1])
        assert r.out == out
    with pytest.raises(ValueError, match="frame_emb"):
        server.submit(tserve.Request(prompt=[1, 2]))


@pytest.mark.parametrize("arch", ["gemma3-4b", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_serve_cli_on_the_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--requests", "3", "--max-new", "2",
                 "--device", "cpu"])
    assert "decoded 6 tokens for 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch,stack", [("jamba_15_large_398b", "decoder"),
                                        ("seamless_m4t_medium", "encoder")])
def test_from_jax_params_rejects_a_missing_or_extra_leaf(arch, stack):
    """A period-8 body (Jamba: the attention layer is body[4]) and an
    encoder stack: every leaf is used once, in plan order; a missing or
    extra leaf, or a period axis of the wrong length, raises."""
    jcfg, tcfg, params, tp = _pair(arch)
    pn = jax.tree.map(np.asarray, params)
    assert sum(t.numel() for t in tp.parameters()) == sum(
        a.size for a in jax.tree.leaves(pn))
    plan = tlm.plans(tcfg)[0 if stack == "decoder" else 1]
    layers = tp.layers if stack == "decoder" else tp.encoder
    assert [lp.plan for lp in layers] == plan.layers
    if plan.n_periods:  # body[0]'s period p is layer head + p * period
        body = pn[stack]["body"][0]
        sub, name = ("attn", "wq") if "attn" in body else ("mixer", "w_in")
        for p in range(plan.n_periods):
            lp = layers[len(plan.head) + p * len(plan.pattern)]
            np.testing.assert_array_equal(lp[sub][name].numpy(),
                                          body[sub][name][p])
    part = "body" if pn[stack]["body"] else "tail"
    i = 4 if arch == "jamba_15_large_398b" else 0
    leaf = "attn" if "attn" in pn[stack][part][i] else "mixer"

    def broken(edit):
        tree = jax.tree.map(lambda a: a, pn)
        edit(tree)
        return tree

    def drop(t):
        sub = t[stack][part][i][leaf]
        del sub[sorted(sub)[0]]

    def add(t):
        t[stack][part][i]["unused"] = np.zeros(3, np.float32)

    for tree, match in ((broken(drop), "missing leaves"),
                        (broken(add), "extra leaves")):
        with pytest.raises(ValueError, match=match):
            tlm.from_jax_params(tcfg, tree)
    if jcfg.is_encdec:
        with pytest.raises(ValueError, match="missing leaves"):
            tlm.from_jax_params(tcfg, broken(lambda t: t.pop("enc_norm")))
    else:
        def cut(t):
            t[stack]["body"][i] = jax.tree.map(lambda a: a[:-1],
                                               t[stack]["body"][i])
        with pytest.raises(ValueError, match="periods"):
            tlm.from_jax_params(tcfg, broken(cut))


def test_chip_smoke_lm_archs_rehearse_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke``'s L4-L6 at the reduced configs on the CPU (the
    kernel's plain version, the card's timers stubbed): Gemma-3's prefill,
    server, decode and ring wrap, DeepSeek-V2's prefills, decode and
    telemetry, and the five reduced archs card-against-CPU (here CPU
    against CPU) must all pass their checks."""
    import time
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    class _Event:
        def __init__(self, enable_timing=True):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return 1e3 * (other.t - self.t)

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    for name, value in (("LM_REDUCED", True), ("GEMMA_PREFILL", 48),
                        ("DECODE_CHECK", 12), ("PLAIN_CHUNK_THRESHOLD", 16),
                        ("RING_PROMPT", 20), ("RING_SEQ", 32),
                        ("DSV2_PREFILL", 40), ("REDUCED_LEN", 10),
                        ("SERVE", dict(batch_slots=2, max_seq=32, requests=3,
                                       prompt=5, max_new=4))):
        monkeypatch.setattr(chip_smoke, name, value)
    out, launches = chip_smoke.arch_phases(torch.device("cpu"), "[cpu]")
    text = capsys.readouterr().out
    assert "L4 ring wrap" in text and "cache rows [8, 32]" in text
    assert "L5 decode" in text and "load vectors equal" in text
    assert text.count("L6 ") == len(chip_smoke.REDUCED_ARCHS)
    assert set(out) == {"gemma3_4b", "deepseek_v2_236b",
                        *chip_smoke.REDUCED_ARCHS}
    assert all(n == 0 for n in launches.values())  # CPU tensors: plain
    assert out["deepseek_v2_236b"]["telemetry_sum"] == 40 * 2 * 2
    # the flash launches the card must see: global GQA layers only
    cfgs = {a: tconfigs.get(a, reduced=True) for a in chip_smoke.REDUCED_ARCHS}
    assert {a: chip_smoke.n_flash_layers(c) for a, c in cfgs.items()} == {
        "kimi_k2_1t_a32b": 3, "jamba_15_large_398b": 1, "xlstm_13b": 0,
        "phi3_vision_42b": 2, "seamless_m4t_medium": 4}
    assert chip_smoke.n_flash_layers(tconfigs.get("gemma3_4b")) == 5
