"""Sharded serving on gloo ranks of the CPU: the sharded prefill and serve
steps over ``("data", "model")`` meshes (``launch.step_fns.shard_params``,
``shard_caches``, ``make_sharded_prefill_step``,
``make_sharded_serve_step``; the models' split decode: local heads, the
recurrent mixers on their channel shards, experts over "model", the
vocabulary gathered), context parallelism (batch 1, the caches' sequence
over "data") and ``DecodeServer(mesh=)``, against the port's one-device
prefill, ``serve_step`` and server and against ``repro``'s ``lm.forward``
and ``lm.serve_step``.

Every parameter tree is ``repro``'s (the structure of
``repro.models.lm.init_params``, leaves drawn by numpy from one seed),
carried over by ``lm.from_jax_params``; the context-parallel caches are
drawn from a seed, the same for every side. Worlds 2 and 4 are spawned
once for the module, in threads, while the oracles compute; the rank
bodies are ``tests/torch_serve_ranks.py``.

Tolerances (f32 on every side, the same math in another order): logits
within 1e-5 of the largest logit against the one-device port (the
recurrent archs 5e-5, as ``tests/test_torch_lm_archs.py`` holds the
one-device port: their states carry f32 sums through every step) and
within 1e-4 against ``repro`` (the logit bound of ``chip_smoke.py``'s L2
and L3: the split's sums in another order come on top of the port's own
distance from ``repro``); every cache leaf within 10 times the
one-device bound of its largest magnitude, ``pos`` exactly; the served
tokens and the local shapes exactly.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

import repro.configs as jconfigs
from repro.launch import shardings as jshd
from repro.models import lm as jlm

from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.launch import step_fns
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.serve import DecodeServer, Request
from repro_torch.models import lm
from repro_torch.distributed.sharding_ctx import from_placements

import torch_serve_ranks as R
from test_torch_sharding_rules import _pad, _ref_by_name

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

REL, RECURRENT_REL, JAX_REL, CACHE_FACTOR = 1e-5, 5e-5, 1e-4, 10
RECURRENT = ("jamba_15_large_398b", "xlstm_13b")
SPLIT = [(w, arch, shape) for w, cases in R.CASES.items()
         for arch, shape in cases]
CP = [(w, arch, shape) for w, cases in R.CP_CASES.items()
      for arch, shape in cases]
# chip_smoke's L13 at the reduced configs (its ranks spawned on the CPU)
_SERVE = dict(batch_slots=4, max_seq=32, requests=4, prompt=4, max_new=4)
L13_PARTS = {
    "a": dict(arch="qwen3_8b", reduced=True, mesh=(1, 2), prefill=32,
              serve=_SERVE),
    "b": dict(arch="xlstm_13b", reduced=True, mesh=(1, 2), prefill=16,
              serve=_SERVE, train=(2, 16)),
    "c": dict(arch="gemma3_4b", reduced=True, mesh=(2, 1), steps=4, seq=64),
}


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
    tree = lm.from_jax_params(R.config(arch), jax.tree.map(np.asarray, params))
    return {k: v.detach().numpy() for k, v in tree.named_parameters()}


@pytest.fixture(scope="module")
def states():
    archs = {a for cases in list(R.CASES.values()) + list(
        R.CP_CASES.values()) for a, _ in cases} | {R.QWEN3}
    return {a: _jax_params(a) for a in sorted(archs)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, states):
    """``{world: future of rank 0's results}``, both worlds spawned as the
    module starts so that the oracles compute meanwhile."""
    leaves = {a: _leaves(a, p) for a, p in states.items()}
    cp = {a: R.seeded_caches(R.config(a)) for _, a, _ in CP}
    n = torch.get_num_threads()
    torch.set_num_threads(1)

    # made here: the base temporary directory is not made thread-safely
    tmps = {w: tmp_path_factory.mktemp(f"serve{w}") for w in (2, 4)}

    def spawn(world):
        tmp = tmps[world]
        return spawn_ranks(R.run, world, device="cpu",
                           init_file=tmp / "rendezvous",
                           args=(world, leaves, cp))

    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = {w: pool.submit(spawn, w) for w in (2, 4)}
        futures["l13"] = pool.submit(cs.serve_tp_phase, torch.device("cpu"),
                                     "[cpu]", L13_PARTS)
        yield futures
    torch.set_num_threads(n)


_ORACLES: dict = {}


def _oracle(key, fn):
    if key not in _ORACLES:
        _ORACLES[key] = fn()
    return _ORACLES[key]


def _jcfg(arch):
    jcfg = jconfigs.get(arch, reduced=True)
    cfg = R.config(arch)
    return jcfg.replace(capacity_factor=cfg.capacity_factor) \
        if cfg.n_experts else jcfg


def _np_caches(caches) -> list:
    return [{"mixer": {k: np.asarray(v) for k, v in c["mixer"].items()}}
            for c in caches]


def _one_device(arch, states):
    """The port on one device: the prefill's logits, then STEPS decode
    steps from zeroed caches, and the caches after them."""
    cfg = R.config(arch)
    params = R.params_of(cfg, _leaves(arch, states[arch]))
    data = R.prompts(cfg)
    batch = {k: torch.from_numpy(v) for k, v in data.items()
             if k != "decode"}
    with torch.no_grad():
        prefill, _ = lm.forward(cfg, params, batch)
        memory = lm.encode_memory(cfg, params, batch["frame_emb"]) \
            if cfg.is_encdec else None
    caches = lm.init_cache(cfg, R.B, R.CACHE, device="cpu")
    decode = []
    for i in range(R.STEPS):
        lg, caches = lm.serve_step(cfg, params, caches, torch.from_numpy(
            data["decode"][:, i:i + 1]), memory=memory)
        decode.append(lg.numpy())
    return dict(prefill=prefill.numpy(), decode=decode,
                caches=_np_caches(caches))


def _jax(arch, states):
    """``repro``'s prefill logits and STEPS ``serve_step``s from zeroed
    caches."""
    jcfg = _jcfg(arch)
    params = states[arch]
    data = R.prompts(R.config(arch))
    batch = {k: jnp.asarray(v) for k, v in data.items() if k != "decode"}
    prefill, _ = jax.jit(lambda p, b: jlm.forward(jcfg, p, b))(params, batch)
    memory = jlm.encode_memory(jcfg, params, batch["frame_emb"]) \
        if jcfg.is_encdec else None
    caches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jlm.init_cache_specs(jcfg, R.B, R.CACHE))
    step = jax.jit(lambda p, c, t, m: jlm.serve_step(jcfg, p, c, t,
                                                     memory=m))
    decode = []
    for i in range(R.STEPS):
        lg, caches = step(params, caches,
                          jnp.asarray(data["decode"][:, i:i + 1]), memory)
        decode.append(np.asarray(lg))
    return dict(prefill=np.asarray(prefill), decode=decode)


def _cp_one_device(arch, states):
    """One device from the seeded caches: STEPS decode logits and the
    caches after them."""
    cfg = R.config(arch)
    params = R.params_of(cfg, _leaves(arch, states[arch]))
    caches = [{"mixer": {k: torch.from_numpy(v.copy())
                         for k, v in c["mixer"].items()}}
              for c in R.seeded_caches(cfg)]
    toks = R.prompts(cfg)["decode"][:1]
    decode = []
    for i in range(R.STEPS):
        lg, caches = lm.serve_step(cfg, params, caches,
                                   torch.from_numpy(toks[:, i:i + 1]))
        decode.append(lg.numpy())
    return dict(decode=decode, caches=_np_caches(caches))


def _cp_jax(arch, states):
    jcfg = _jcfg(arch)
    caches = [{"mixer": {k: jnp.asarray(v) for k, v in c["mixer"].items()}}
              for c in R.seeded_caches(R.config(arch))]
    toks = R.prompts(R.config(arch))["decode"][:1]
    step = jax.jit(lambda p, c, t: jlm.serve_step(jcfg, p, c, t))
    decode = []
    for i in range(R.STEPS):
        lg, caches = step(states[arch], caches, jnp.asarray(toks[:, i:i + 1]))
        decode.append(np.asarray(lg))
    return decode


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _check_caches(got, want, rel):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g["mixer"]) == set(w["mixer"]), i
        for name, x in w["mixer"].items():
            y = g["mixer"][name]
            assert y.shape == x.shape, (i, name)
            if name == "pos":
                np.testing.assert_array_equal(y, x)
            elif np.abs(x).max() > 0:
                assert _rel(y, x) < CACHE_FACTOR * rel, (i, name)


@pytest.mark.parametrize("world,arch,shape", SPLIT, ids=str)
def test_sharded_prefill_and_decode_match_one_device_and_jax(
        worlds, states, world, arch, shape):
    """The sharded prefill's logits and STEPS sharded decode steps' equal
    the one-device port's and ``repro``'s; the caches, gathered, equal the
    one-device caches."""
    got = worlds[world].result()[(arch, shape)]
    want = _oracle(("one", arch), lambda: _one_device(arch, states))
    jwant = _oracle(("jax", arch), lambda: _jax(arch, states))
    rel = RECURRENT_REL if arch in RECURRENT else REL
    assert got["prefill"].shape == want["prefill"].shape
    assert _rel(got["prefill"], want["prefill"]) < rel
    assert _rel(got["prefill"], jwant["prefill"]) < JAX_REL
    for i, (g, w, j) in enumerate(zip(got["decode"], want["decode"],
                                      jwant["decode"])):
        assert g.shape == w.shape == (R.B, 1, R.config(arch).vocab_size)
        assert _rel(g, w) < rel, i
        assert _rel(g, j) < JAX_REL, i
    _check_caches(got["caches"], want["caches"], rel)


@pytest.mark.parametrize("world,arch,shape", CP, ids=str)
def test_context_parallel_decode(worlds, states, world, arch, shape):
    """One sequence from seeded caches near their end (Gemma-3's rings past
    their wrap, wrapping again inside the steps), the caches' sequence
    axis over "data": every rank's logits the same, equal to the
    one-device port's and ``repro``'s; the caches, gathered, equal the
    one-device caches."""
    got = worlds[world].result()[("cp", arch, shape)]
    want = _oracle(("cp", arch), lambda: _cp_one_device(arch, states))
    jwant = _oracle(("cpjax", arch), lambda: _cp_jax(arch, states))
    rel = RECURRENT_REL if arch in RECURRENT else REL
    assert got["same_on_every_rank"]
    for i, (g, w, j) in enumerate(zip(got["decode"], want["decode"],
                                      jwant)):
        assert _rel(g, w) < rel, i
        assert _rel(g, j) < JAX_REL, i
    _check_caches(got["caches"], want["caches"], rel)


def test_context_parallel_writes_cross_ranks_and_wrap():
    """The context-parallel cases reach what they are for: Gemma-3's ring
    slots of the steps wrap to slot 0 and lie on more than one data rank
    at (2, 1) and (4, 1), and its global layers' slots lie inside the
    cache."""
    cfg = R.config("gemma3_4b")
    ring = cfg.sliding_window
    slots = [(R.CP_POS + i) % ring for i in range(R.STEPS)]
    assert 0 in slots
    for n in (2, 4):
        assert len({s // (ring // n) for s in slots}) > 1
    assert R.CP_POS + R.STEPS <= R.CP_SEQ


def _local(shape, spec, sizes) -> tuple:
    out = []
    for d, entry in zip(shape, spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) \
            else tuple(entry)
        out.append(d // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


@pytest.mark.parametrize("world,arch,shape", SPLIT + CP, ids=str)
def test_shards_have_the_reference_placements_local_shapes(
        worlds, world, arch, shape):
    """Rank 0's cache leaves and parameter shards have the local shapes of
    the reference's placements (``repro.launch.shardings.cache_shardings``
    and ``sanitize_specs(param_specs)`` on an abstract mesh of the same
    shape), leaf for leaf."""
    key = (arch, shape) if (world, arch, shape) in SPLIT else \
        ("cp", arch, shape)
    got = worlds[world].result()[key]["shapes"]
    names = ("data", "model")
    sizes = dict(zip(names, shape))
    jm = JMesh(shape, names)
    jcfg = jconfigs.get(arch, reduced=True)
    batch, seq = (R.B, R.CACHE) if key[0] != "cp" else (1, R.CP_SEQ)
    jc = jshd.cache_shardings(jlm.init_cache_specs(jcfg, batch, seq), jm)
    cspecs = step_fns.cache_specs(R.config(arch), batch, seq)
    want = {}
    for i, (c, s) in enumerate(zip(jc, cspecs)):
        for name, sh in c["mixer"].items():
            shp = s["mixer"][name][0]
            want[f"caches.{i}.{name}"] = _local(shp, _pad(sh.spec, len(shp)),
                                                sizes)
    jshapes = jlm.param_shapes(jcfg)
    jp = jshd.sanitize_specs(jlm.param_specs(jcfg, ("data",), "model"),
                             jshapes, jm)
    pshapes = lm.param_shapes(R.config(arch))
    for name, spec in _ref_by_name(R.config(arch), jp, jshapes).items():
        want[f"params.{name}"] = _local(pshapes[name][0], spec, sizes)
    assert got == want
    # and the port's own placements say the same
    tm = AbstractMesh(shape, names)
    for name, pl in step_fns.param_placements(R.config(arch), tm).items():
        spec = from_placements(pl, tm, len(pshapes[name][0]))
        assert _local(pshapes[name][0], spec, sizes) == got[f"params.{name}"]


def _one_device_server(states):
    cfg = R.config(R.QWEN3)
    params = R.params_of(cfg, _leaves(R.QWEN3, states[R.QWEN3]))
    server = DecodeServer(cfg, params, batch_slots=R.SERVER["batch_slots"],
                          max_seq=R.SERVER["max_seq"], device="cpu")
    reqs = [Request(prompt=p, max_new=R.SERVER["max_new"])
            for p in R.server_requests(cfg)]
    server.run(reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("shape", R.SERVER_MESHES[2], ids=str)
def test_decode_server_on_a_mesh_matches_one_device(worlds, states, shape):
    """``DecodeServer(mesh=)`` (slots over the data ranks at (2, 1), heads,
    MLP and vocabulary over the model ranks at (1, 2)) serves the
    requests with the one-device server's greedy tokens."""
    got = worlds[2].result()[("server", shape)]
    want = _oracle("server", lambda: _one_device_server(states))
    assert len(got) == R.SERVER["requests"]
    assert all(len(t) == R.SERVER["max_new"] for t in got)
    assert got == want


@pytest.mark.parametrize("world,arch,shape", [
    (2, "jamba_15_large_398b", (1, 2)), (2, "xlstm_13b", (1, 2)),
    (4, "jamba_15_large_398b", (1, 4)), (4, "xlstm_13b", (1, 4))], ids=str)
def test_mixers_prefill_on_their_channel_shards(worlds, world, arch, shape):
    """Under the split the recurrent mixers run on their channel shards:
    every mixer call of the sharded prefill holds di / tp rows of
    ``w_out``."""
    cfg = R.config(arch)
    di = cfg.ssm_expand * cfg.d_model
    seen = worlds[world].result()[(arch, shape)]["mixers"]
    n = sum(p.kind != "attn" for p in lm.plans(cfg)[0].layers)
    assert len(seen) == n
    assert {rows for _, (rows, _) in seen} == {di // shape[1]}


def test_chip_smoke_phase_l13_rehearses_on_the_cpu(worlds, monkeypatch,
                                                    capsys):
    """``chip_smoke``'s L13 at the reduced configs on the CPU (its meshes as
    spawned gloo ranks, the flash kernel's plain version): every part
    agrees with its one-device reference; the launch check only the card
    can pass fails here; E1's serving cells and L13's flash rows run."""
    out = worlds["l13"].result()
    a, b, c = out["a"], out["b"], out["c"]
    assert a["prefill"]["logit_rel_err"] <= cs.LOGIT_TOL
    assert a["decode"]["tokens_equal"] and b["decode"]["tokens_equal"]
    assert b["train"]["grad_norm_rel_err"] <= cs.SERVE_TP_GRAD_REL
    # the reduced widths are well conditioned: the tp tests' recurrent bound
    assert b["train"]["grad_rel_err"] <= 1e-4
    assert b["train"]["loss_rel"] <= cs.TRAIN_REL
    assert c["cp"]["logit_rel_err"] <= cs.LOGIT_TOL
    assert c["cp"]["seq"] == 64 and c["cp"]["pos0"] == 64 - 8 + 4 - 2
    # reduced Qwen3: 4 heads over 2 KV heads, so 2 and 1 a rank
    assert a["prefill"]["flash_call_shapes"] == [
        ((1, 2, 32, 16), (1, 1, 32, 16), 0)]
    assert a["prefill"]["collectives"]["all_reduce"]["calls"] > 0
    assert c["cp"]["collectives"]["all_reduce"]["calls"] > 0
    assert out["launches"]["flash_attention_kernel"] == 0  # plain versions
    monkeypatch.setattr(cs, "SERVE_TP_PARTS", L13_PARTS)
    monkeypatch.setattr(cs, "LM_REDUCED", True)
    with pytest.raises(AssertionError, match="L13a: flash launches"):
        cs.check_serve_tp_on_the_card(out)
    est = cs.serving_estimates(out, L13_PARTS, "[cpu]")
    assert set(est) == {"a_prefill", "a_decode", "b_prefill", "b_decode",
                        "c_cp"}
    assert all(x["estimate_peak_bytes"] > 0 for x in est.values())
    monkeypatch.setattr(cs, "_sync", lambda: None)
    monkeypatch.setattr(cs, "event_times",
                        lambda fn, reps: [fn() is None or 0.0])
    rows = cs.check_flash_serve_rows(torch.device("cpu"), "[cpu]",
                                     a["prefill"]["flash_call_shapes"])
    assert [r["out_of_tolerance"] for r in rows] == [0]
    assert "E1 estimator at L13c's cp cell" in capsys.readouterr().out
