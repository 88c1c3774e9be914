"""The port's LM serving slice against the JAX package on the CPU: the
flash kernel's plain version against the interpreted Pallas kernel, GQA
attention, the prefill forward, the cached decode step and the decode
server, on the reduced dense-GQA configs.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: float32 on both sides, the same math in a different order of
operations, which moves a result by ~1e-6 relative (measured at these
sizes); the model-level checks take 1e-5 of the largest logit, ten times
that, and the kernel-level checks the JAX kernel test's own 2e-5 (f32)
and 2e-2 (bf16: one rounding of the output)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.attention as jattn
from repro.kernels.flash_attention.ops import attention as j_flash
from repro.kernels.flash_attention.ref import reference_attention
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models.params import init_tree as j_init_tree

import repro_torch.configs as tconfigs
import repro_torch.models.attention as tattn
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import attention as t_flash
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models.params import ParamTree

ARCHS = ["smollm_135m", "qwen3_8b", "qwen15_110b"]
REL = 1e-5  # of the largest logit (module docstring)
F32_TOL, BF16_TOL = 2e-5, 2e-2


def _np(x):
    return np.asarray(x, np.float32)


def _pair(arch, **kw):
    """(JAX config, port config, JAX params, port params) of a reduced
    arch, the port's weights carried over from the JAX draw."""
    jcfg = jconfigs.get(arch, reduced=True).replace(**kw)
    tcfg = tconfigs.get(arch, reduced=True)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, tlm.from_jax_params(
        tcfg, jax.tree.map(np.asarray, params))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


# ---- 1. the flash kernel's plain version ----------------------------------

@pytest.mark.parametrize("B,Hq,Hkv,L,dh,dtype", [
    (1, 2, 2, 128, 32, "f32"),
    (2, 4, 2, 256, 64, "f32"),
    (1, 8, 1, 128, 64, "f32"),   # MQA
    (2, 4, 4, 384, 32, "bf16"),  # bf16 + non-pow2 length
    (1, 4, 2, 128, 128, "f32"),  # Qwen3's head dim
    (1, 4, 2, 200, 16, "f32"),   # ragged: the JAX wrapper pads to 256
    (1, 4, 2, 128, 256, "f32"),  # Gemma-3's head dim
    (1, 4, 4, 144, 96, "f32"),   # phi-3-vision's, MHA, ragged
    (1, 4, 2, 128, 256, "bf16"),
])
def test_flash_plain_matches_pallas_interpret(B, Hq, Hkv, L, dh, dtype):
    rng = np.random.default_rng(L + dh)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, L, dh), (B, Hkv, L, dh), (B, Hkv, L, dh))]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jq, jk, jv = [jnp.asarray(a, jdt) for a in arrs]
    want = j_flash(jq, jk, jv, causal=True, impl="pallas_interpret")
    ref = reference_attention(jq, jk, jv, causal=True)  # Lq == Lk
    before = flash_attention_kernel.launches
    got = t_flash(*[torch.from_numpy(a).to(tdt) for a in arrs])
    assert flash_attention_kernel.launches == before  # CPU: plain version
    assert got.dtype == tdt and got.shape == (B, Hq, L, dh)
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    assert np.abs(_np(want) - _np(got.float())).max() < tol
    assert np.abs(_np(ref) - _np(got.float())).max() < tol


def test_flash_plain_non_causal_and_ragged_rule():
    rng = np.random.default_rng(5)
    q, k, v = [rng.standard_normal((1, 4, 128, 32)).astype(np.float32)
               for _ in range(3)]
    k, v = k[:, :2], v[:, :2]
    want = j_flash(*map(jnp.asarray, (q, k, v)), causal=False,
                   impl="pallas_interpret")
    got = t_flash(*map(torch.from_numpy, (q, k, v)), causal=False)
    assert np.abs(_np(want) - got.numpy()).max() < F32_TOL
    with pytest.raises(ValueError, match="non-causal"):
        t_flash(*[torch.from_numpy(x[:, :, :100].copy()) for x in (q, k, v)],
                causal=False)


# ---- 2. GQA attention ------------------------------------------------------

@pytest.mark.parametrize("threshold,window", [(8192, 0), (16, 0), (8192, 7),
                                               (16, 7)],
                         ids=["dense", "chunked", "window", "chunked-window"])
def test_masked_attention_matches_jax(monkeypatch, threshold, window):
    monkeypatch.setattr(jattn, "CHUNKED_ATTN_THRESHOLD", threshold)
    monkeypatch.setattr(tattn, "CHUNKED_ATTN_THRESHOLD", threshold)
    rng = np.random.default_rng(threshold + window)
    q = rng.standard_normal((2, 64, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 24)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 24)).astype(np.float32)
    want = jattn._masked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=True, window=window)
    got = tattn._masked_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=True, window=window)
    assert np.abs(_np(want) - got.numpy()).max() < F32_TOL
    np.testing.assert_array_equal(np.asarray(jattn.causal_mask(64, window)),
                                  tattn.causal_mask(64, window).numpy())


def _gqa_params(cfg, seed):
    """JAX GQA params with the zero/one-initialised biases and norm scales
    replaced by random values, as numpy."""
    p = jax.tree.map(np.asarray,
                     j_init_tree(jattn.gqa_defs(cfg), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in p:
            p[name] = rng.standard_normal(p[name].shape).astype(np.float32)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name]["scale"] = 1 + 0.3 * rng.standard_normal(
                p[name]["scale"].shape).astype(np.float32)
    return p


def _to_torch(tree):
    return ParamTree(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                  tree))


@pytest.mark.parametrize("arch,window", [("smollm_135m", 0), ("qwen3_8b", 0),
                                         ("qwen15_110b", 0),
                                         ("qwen3_8b", 5)])
def test_gqa_train_and_decode_match_jax(arch, window):
    """Prefill attention (the kernel path where JAX takes its Pallas kernel,
    the plain path otherwise) and 12 decode steps through a 7-slot cache
    (ring-buffered when windowed, so it wraps)."""
    jcfg = jconfigs.get(arch, reduced=True)
    tcfg = tconfigs.get(arch, reduced=True)
    pn = _gqa_params(jcfg, 3)
    jp, tp = jax.tree.map(jnp.asarray, pn), _to_torch(pn)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    for jimpl, timpl in (("xla", "plain"), ("pallas_interpret", "kernel")):
        want = jattn.gqa_train(jp, jnp.asarray(x),
                               jcfg.replace(attn_impl=jimpl), window=window)
        got = tattn.gqa_train(tp, torch.from_numpy(x),
                              tcfg.replace(attn_impl=timpl), window=window)
        assert _rel(want, got) < REL, (jimpl, timpl)
    S = 7 if window else 16
    spec = jattn.gqa_cache_spec(jcfg, 2, S, window=window)
    jc = {n: jnp.zeros(s.shape, s.dtype) for n, s in spec.items()}
    tc = {n: torch.zeros(shape, dtype=dt) for n, (shape, dt) in
          tattn.gqa_cache_spec(tcfg, 2, S, window=window).items()}
    for t in range(12 if window else S):
        xt = x[:, t:t + 1]
        jy, jc = jattn.gqa_decode(jp, jnp.asarray(xt), jc, jcfg, window)
        ty, tc = tattn.gqa_decode(tp, torch.from_numpy(xt), tc, tcfg, window)
        assert _rel(jy, ty) < REL, t
    for n in ("k", "v"):
        assert _rel(jc[n], tc[n]) < REL
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())


# ---- 3/4. prefill forward and decode ---------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """Both pairs: the JAX Pallas kernel (interpreted) against the port's
    kernel path (its plain version on the CPU), and the JAX XLA attention
    against the port's plain attention."""
    jcfg, tcfg, params, tp = _pair(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    for jimpl, timpl in (("pallas_interpret", "kernel"), ("xla", "plain")):
        want, _ = jlm.forward(jcfg.replace(attn_impl=jimpl), params,
                              {"tokens": jnp.asarray(toks)})
        got, _ = tlm.forward(tcfg.replace(attn_impl=timpl), tp,
                             {"tokens": torch.from_numpy(toks)})
        assert got.shape == (2, 16, jcfg.vocab_size)
        assert _rel(want, got) < REL, (jimpl, timpl)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_jax_and_prefill(arch):
    """Step by step against the JAX ``serve_step``; and the port's decode
    through its cache against its own prefill, under the bound of
    ``tests/test_models.py::test_decode_matches_prefill``."""
    jcfg, tcfg, params, tp = _pair(arch)
    B, S = 2, 16
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jc = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      jlm.init_cache_specs(jcfg, B, S))
    tc = tlm.init_cache(tcfg, B, S, device="cpu")
    steps = []
    for i in range(S):
        jl, jc = jlm.serve_step(jcfg, params, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = tlm.serve_step(tcfg, tp, tc, torch.from_numpy(
            toks[:, i:i + 1]))
        assert _rel(jl, tl) < REL, i
        steps.append(tl)
    full, _ = tlm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(full, torch.cat(steps, 1)) < 1e-3


# ---- 5. the decode server --------------------------------------------------

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


def test_decode_server_matches_jax():
    """More requests than slots, so finished slots are refilled: the same
    schedule, the same output lengths, per-step logits within tolerance,
    and the same greedy tokens wherever the top two logits are further
    apart than that tolerance."""
    jcfg, tcfg, params, tp = _pair("smollm_135m")
    rng = np.random.default_rng(6)
    specs = [(list(map(int, rng.integers(0, jcfg.vocab_size, n))), m)
             for n, m in ((3, 4), (5, 6), (2, 3), (4, 5), (6, 2))]
    logs, outs = {}, {}
    for name, mod, cfg, p, kw in (("jax", jserve, jcfg, params, {}),
                                  ("torch", tserve, tcfg, tp,
                                   {"device": "cpu"})):
        reqs = [mod.Request(prompt=list(pr), max_new=m) for pr, m in specs]
        server = mod.DecodeServer(cfg, p, batch_slots=2, max_seq=32, **kw)
        logs[name] = []
        _recording(server, logs[name], reqs)
        server.run(reqs)
        outs[name] = [r.out for r in reqs]
        assert all(r.done for r in reqs)
    assert [len(o) for o in outs["jax"]] == [m for _, m in specs]
    assert [len(o) for o in outs["torch"]] == [m for _, m in specs]
    assert [s for s, _ in logs["jax"]] == [s for s, _ in logs["torch"]]
    for (_, a), (_, b) in zip(logs["jax"], logs["torch"]):
        scale = np.abs(a).max()
        assert np.abs(a - b).max() / scale < REL
        top2 = np.sort(a, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > REL * scale
        assert np.array_equal(a.argmax(-1)[clear], b.argmax(-1)[clear])
    assert outs["jax"] == outs["torch"]


def test_serve_cli_on_the_cpu(capsys):
    tserve.main(["--arch", "qwen3-8b", "--requests", "2", "--max-new", "3",
                 "--device", "cpu"])
    assert "decoded 6 tokens for 2 requests" in capsys.readouterr().out
    # --mode sketch hands every other flag to the graph-stream server
    tserve.main(["--mode", "sketch", "--device", "cpu", "--edges", "512",
                 "--requests", "8", "--ingest-batch", "256"])
    assert "answered 8 edge queries" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # lm mode takes no server flags
        tserve.main(["--arch", "qwen3-8b", "--edges", "512"])


# ---- 6. carrying weights across --------------------------------------------

def test_from_jax_params_uses_every_leaf_once():
    jcfg, tcfg, params, tp = _pair("qwen3_8b")
    pn = jax.tree.map(np.asarray, params)
    assert sum(t.numel() for t in tp.parameters()) == sum(
        a.size for a in jax.tree.leaves(pn))
    body = pn["decoder"]["body"][0]
    for li, lp in enumerate(tp.layers):
        np.testing.assert_array_equal(lp["attn"]["wq"].numpy(),
                                      body["attn"]["wq"][li])
        np.testing.assert_array_equal(lp["mlp"]["w_down"].numpy(),
                                      body["mlp"]["w_down"][li])
    missing = jax.tree.map(lambda a: a, pn)
    del missing["decoder"]["body"][0]["attn"]["k_norm"]
    with pytest.raises(ValueError, match="missing leaves"):
        tlm.from_jax_params(tcfg, missing)
    extra = jax.tree.map(lambda a: a, pn)
    extra["embed"]["unused"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra leaves"):
        tlm.from_jax_params(tcfg, extra)
    bad = jax.tree.map(lambda a: a, pn)
    bad["final_norm"]["scale"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        tlm.from_jax_params(tcfg, bad)


# ---- 7. registry and device rules ------------------------------------------

# the fields whose values are typed by package (dtypes) or name a
# different path (attn_impl: "kernel"/"plain" here, "xla"/"pallas" there)
_TYPED = ("param_dtype", "compute_dtype", "attn_mat_dtype", "attn_impl")


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_jax(arch):
    """Every architecture, full and reduced: field for field equal to the
    JAX package's (dtypes by name), with the same parameter counts."""
    import dataclasses
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for reduced in (False, True):
        j = jconfigs.get(arch, reduced=reduced)
        t = tconfigs.get(arch, reduced=reduced)
        names = {f.name for f in dataclasses.fields(j)}
        assert names == {f.name for f in dataclasses.fields(t)}
        for f in sorted(names - set(_TYPED)):
            assert getattr(j, f) == getattr(t, f), (arch, f)
        for f in _TYPED[:3]:
            assert str(getattr(t, f)).split(".")[-1] == \
                np.dtype(getattr(j, f)).name, (arch, f)
        assert j.head_dim == t.head_dim and j.is_encdec == t.is_encdec
        assert j.param_count() == t.param_count()
        assert j.active_param_count() == t.active_param_count()
    assert tconfigs.get("qwen3-8b").param_count() == 8_190_427_136
    with pytest.raises(ValueError, match="attn_impl"):
        tconfigs.get("qwen3-8b").replace(attn_impl="xla")
    with pytest.raises(ValueError, match="unknown architecture"):
        tconfigs.get("gpt-2")
