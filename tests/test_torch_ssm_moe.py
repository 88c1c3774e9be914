"""The port's new model modules against the JAX package on the CPU, one
module at a time: MLA (prefill and the absorbed decode), cross attention,
the MoE layer (outputs, aux losses, dropped share and telemetry, with and
without drops) and the Mamba, mLSTM and sLSTM mixers (prefill and decode
with their states), on the reduced configs' widths.

Inputs are made with numpy from a seed; the zero- and one-initialised
leaves (biases, norm scales, ``a_log``, ``d_skip``) are redrawn so that
every parameter matters. Tolerances: f32 on both sides, the same math in
another order, within REL = 1e-5 of the largest output (2e-5 for the
recurrent mixers, whose states carry sums across steps and whose Mamba
scan associates in another order); aux losses within 1e-5 absolute;
telemetry counts exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.attention as jattn
import repro.models.moe as jmoe
import repro.models.ssm as jssm
from repro.models.params import init_tree as j_init_tree

import repro_torch.configs as tconfigs
import repro_torch.models.attention as tattn
import repro_torch.models.moe as tmoe
import repro_torch.models.ssm as tssm
from repro_torch.models.params import ParamTree

REL, RECURRENT_REL, AUX_TOL = 1e-5, 2e-5, 1e-5
B, L = 2, 24


def _np(x):
    return np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def _params(defs, seed):
    """JAX-drawn params (numpy) with the constant-initialised leaves
    redrawn; returned for both packages."""
    p = jax.tree.map(np.asarray, j_init_tree(defs, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def redraw(a):
        if a.size and np.all(a == a.flat[0]):
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    p = jax.tree.map(redraw, p)
    return (jax.tree.map(jnp.asarray, p),
            ParamTree(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                   p)))


def _x(cfg, seed, n=L):
    return np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)


def _cfgs(arch, **kw):
    return (jconfigs.get(arch, reduced=True).replace(**kw),
            tconfigs.get(arch, reduced=True).replace(**kw))


def _decode_all(jfn, tfn, jp, tp, x, jc, tc, cfg_pair, rel):
    """Every position of x through both decodes, step by step; returns the
    caches after the last step."""
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        jy, jc = jfn(jp, jnp.asarray(xt), jc, cfg_pair[0])
        ty, tc = tfn(tp, torch.from_numpy(xt), tc, cfg_pair[1])
        assert ty.shape == (B, 1, x.shape[2])
        assert _rel(jy, ty) < rel, t
    return jc, tc


def _zeros_j(spec):
    return {n: jnp.zeros(s.shape, s.dtype) for n, s in spec.items()}


def _zeros_t(spec):
    return {n: torch.zeros(shape, dtype=dt) for n, (shape, dt) in
            spec.items()}


# ---- MLA and cross attention ----------------------------------------------

@pytest.mark.parametrize("q_lora", [48, 0], ids=["q-lora", "direct-q"])
def test_mla_train_and_decode_match_jax(q_lora):
    """DeepSeek-V2's MLA (its q through the low-rank path, and the direct
    ``wq`` of a config without one): the prefill, then every position
    through the absorbed decode against a 24-row compressed cache."""
    cfgs = _cfgs("deepseek_v2_236b", q_lora_rank=q_lora)
    jp, tp = _params(jattn.mla_defs(cfgs[0]), 11)
    x = _x(cfgs[0], 12)
    want = jattn.mla_train(jp, jnp.asarray(x), cfgs[0])
    got = tattn.mla_train(tp, torch.from_numpy(x), cfgs[1])
    assert _rel(want, got) < REL
    jc = _zeros_j(jattn.mla_cache_spec(cfgs[0], B, L))
    tc = _zeros_t(tattn.mla_cache_spec(cfgs[1], B, L))
    jc, tc = _decode_all(jattn.mla_decode, tattn.mla_decode, jp, tp, x, jc,
                         tc, cfgs, REL)
    for n in ("ckv", "krope"):
        assert _rel(jc[n], tc[n]) < REL
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())


def test_cross_attention_matches_jax():
    """Seamless's decoder-to-encoder attention: non-causal over a memory
    of another length than the queries."""
    jcfg, tcfg = _cfgs("seamless_m4t_medium")
    jp, tp = _params(jattn.cross_defs(jcfg), 13)
    x, mem = _x(jcfg, 14, 9), _x(jcfg, 15, 17)
    want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(mem), jcfg)
    got = tattn.cross_attention(tp, torch.from_numpy(x),
                                torch.from_numpy(mem), tcfg)
    assert got.shape == (B, 9, jcfg.d_model)
    assert _rel(want, got) < REL


# ---- MoE ------------------------------------------------------------------

@pytest.mark.parametrize("arch,cf,tokens", [
    ("deepseek_v2_236b", None, True),     # the config's 1.25: drops
    ("deepseek_v2_236b", "E", True),      # drop-free, as decode runs it
    ("kimi_k2_1t_a32b", 0.5, True),       # heavy drops
    ("kimi_k2_1t_a32b", None, False),     # no token ids: zero telemetry
])
def test_moe_matches_jax(arch, cf, tokens):
    jcfg, tcfg = _cfgs(arch)
    cf = float(jcfg.n_experts) if cf == "E" else cf
    jp, tp = _params(jmoe.moe_defs(jcfg), 16)
    x = _x(jcfg, 17)
    ids = np.random.default_rng(18).integers(0, 4 * jmoe.TELEMETRY_BUCKETS,
                                             (B, L), dtype=np.int32)
    jy, ja = jmoe.moe(jp, jnp.asarray(x), jcfg,
                      token_ids=jnp.asarray(ids) if tokens else None,
                      capacity_factor=cf)
    ty, ta = tmoe.moe(tp, torch.from_numpy(x), tcfg,
                      token_ids=torch.from_numpy(ids) if tokens else None,
                      capacity_factor=cf)
    assert _rel(jy, ty) < REL
    for k in ("lb_loss", "z_loss", "dropped"):
        assert abs(float(ja[k]) - float(ta[k])) < AUX_TOL, k
    np.testing.assert_array_equal(np.asarray(ja["telemetry"]),
                                  ta["telemetry"].numpy())
    dropped = float(ta["dropped"])
    if cf is not None and cf >= jcfg.n_experts:
        assert dropped == 0.0
    elif cf is not None:
        assert dropped > 0.1
    assert int(ta["telemetry"].sum()) == (B * L * jcfg.top_k if tokens
                                          else 0)


# ---- the recurrent mixers ---------------------------------------------------

MIXERS = {
    "mamba": ("jamba_15_large_398b", "mamba"),
    "mlstm": ("xlstm_13b", "mlstm"),
    "slstm": ("xlstm_13b", "slstm"),
}


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_train_and_decode_match_jax(kind, monkeypatch):
    """Prefill (Mamba over 3 chunks of 8, mLSTM over 3 of its 8-step
    chunks) and decode from zero states over every position, with the
    states after the last step."""
    arch, name = MIXERS[kind]
    jcfg, tcfg = _cfgs(arch)
    defs = getattr(jssm, f"{name}_defs")(jcfg)
    jp, tp = _params(defs, 19)
    x = 0.5 * _x(jcfg, 20)
    if kind == "mamba":  # a small chunk budget: the carry crosses chunks
        monkeypatch.setattr(jssm, "_mamba_inner", _chunked(
            jssm._mamba_inner, 8))
        monkeypatch.setattr(tssm, "_mamba_inner", _chunked(
            tssm._mamba_inner, 8))
    want = getattr(jssm, f"{name}_train")(jp, jnp.asarray(x), jcfg)
    got = getattr(tssm, f"{name}_train")(tp, torch.from_numpy(x), tcfg)
    assert _rel(want, got) < RECURRENT_REL
    jc = _zeros_j(getattr(jssm, f"{name}_cache_spec")(jcfg, B))
    tc = _zeros_t(getattr(tssm, f"{name}_cache_spec")(tcfg, B))
    assert {n: tuple(s.shape) for n, s in jc.items()} == {
        n: tuple(t.shape) for n, t in tc.items()}
    jc, tc = _decode_all(getattr(jssm, f"{name}_decode"),
                         getattr(tssm, f"{name}_decode"), jp, tp, x, jc, tc,
                         (jcfg, tcfg), RECURRENT_REL)
    for n in jc:
        assert str(tc[n].dtype).split(".")[-1] == np.dtype(jc[n].dtype).name
        assert _rel(jc[n], tc[n]) < RECURRENT_REL, n


def _chunked(inner, chunk):
    """``_mamba_inner`` at a fixed chunk length."""
    def run(params, xz, cfg, **_):
        return inner(params, xz, cfg, chunk=chunk)
    return run


def test_linear_scan_equals_the_recurrence():
    """The doubling scan inside Mamba's chunks: every prefix of h_t = a_t
    h_{t-1} + b_t and of the product of the a's, at lengths that are and
    are not powers of two."""
    rng = np.random.default_rng(21)
    for W in (1, 5, 8, 13):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, W, 3, 4)))
        b = torch.from_numpy(rng.standard_normal((2, W, 3, 4)))
        pa, h = tssm.linear_scan(a, b)
        acc, prod = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
        for t in range(W):
            acc = a[:, t] * acc + b[:, t]
            prod = prod * a[:, t]
            torch.testing.assert_close(h[:, t], acc, rtol=1e-12, atol=1e-12)
            torch.testing.assert_close(pa[:, t], prod, rtol=1e-12,
                                       atol=1e-12)
