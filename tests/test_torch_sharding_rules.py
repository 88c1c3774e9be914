"""The port's mesh and sharding rules (``launch/mesh.py``,
``launch/shardings.py``, ``distributed/sharding_ctx.py``, the spec trees
of ``models/lm.py``, ``optim/adamw.py`` and ``launch/step_fns.py``) against
``repro``'s, exactly, with no devices: the reference's rules run on
``jax.sharding.AbstractMesh``, the port's on its ``AbstractMesh``, and the
port's placements, taken back to per-dimension tuples, must equal the
reference's ``PartitionSpec``s, including the axes the divisibility guard
drops.

Every arch at its published config, on the production meshes and the
smoke meshes; ``resolve`` on every call shape of the reference's
``constrain`` sites, recorded from an abstract forward
(``jax.eval_shape``) of each arch under the production meshes.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

import repro.configs as jconfigs
import repro.distributed.sharding_ctx as jsc
import repro.launch.mesh as jmesh
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import shardings as jshd
from repro.launch.inputs import input_specs as j_input_specs
from repro.launch.step_fns import TrainState as JTrainState
from repro.launch.step_fns import train_state_specs as j_train_state_specs
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamW

import repro_torch.configs as tconfigs
from repro_torch.configs.shapes import SHAPES_BY_NAME
from repro_torch.distributed.sharding_ctx import (ShardingCtx, constrain,
                                                  from_placements,
                                                  to_placements,
                                                  use_sharding_ctx)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tshd
from repro_torch.launch.inputs import input_specs as t_input_specs
from repro_torch.launch.step_fns import TrainState, train_state_specs
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig

PRODUCTION = ((16, 16), (2, 16, 16))
SMOKE = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4))
MESHES = PRODUCTION + SMOKE


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes(shape):
    return (JMesh(shape, _names(shape)),
            tmesh.AbstractMesh(shape, _names(shape)))


def _pad(spec, ndim):
    """A reference ``PartitionSpec`` as a tuple of ``ndim`` entries
    (missing trailing entries are None)."""
    t = tuple(spec)
    assert len(t) <= ndim, (t, ndim)
    return t + (None,) * (ndim - len(t))


def _back(placements, mesh, ndim):
    return from_placements(placements, mesh, ndim)


def _port_specs(tree, mesh):
    """A port spec tree through placements and back."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return _back(to_placements(t, mesh), mesh, len(t))
    return walk(tree)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _ref_by_name(cfg, jtree, jshapes):
    """The reference's param-shaped tree (specs) keyed by the port's dotted
    names through ``tlm.stack_index`` (the mapping ``from_jax_params``
    uses), each as a padded tuple; a scanned body leaf's leading layer
    axis must be None and is dropped."""
    dec, enc = tlm.plans(cfg)
    out = {}
    for k in jtree:
        if k in ("decoder", "encoder"):
            continue
        for name, spec in _flat(jtree[k], f"{k}."):
            shp = dict(_flat(jshapes[k], f"{k}."))[name].shape
            out[name] = _pad(spec, len(shp))
    for stack, plan, key in (("layers", dec, "decoder"),
                             ("encoder", enc, "encoder")):
        if plan is None:
            continue
        for i, (part, j, period) in enumerate(tlm.stack_index(plan)):
            shapes = dict(_flat(jshapes[key][part][j]))
            for leaf, spec in _flat(jtree[key][part][j]):
                t = _pad(spec, len(shapes[leaf].shape))
                if period is not None:
                    assert t[0] is None, (leaf, t)
                    t = t[1:]
                out[f"{stack}.{i}.{leaf}"] = t
    return out


@pytest.fixture(scope="module")
def constrain_calls():
    """``{arch: [(logical, shape)]}``: every ``resolve`` call of the
    reference's ``constrain`` sites in an abstract forward (batch 32 x 64
    tokens) of the arch at its published config, under both production
    meshes (``with_sharding_constraint`` stubbed: the abstract mesh has no
    devices)."""
    calls = {}
    orig = jsc.ShardingCtx.resolve
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax.lax, "with_sharding_constraint", lambda x, s: x)
        for arch in jconfigs.ARCHS:
            seen = []

            def rec(self, logical, shape):
                seen.append((tuple(logical), tuple(int(d) for d in shape)))
                return orig(self, logical, shape)

            mp.setattr(jsc.ShardingCtx, "resolve", rec)
            cfg = jconfigs.get(arch)
            B, L = 32, 64
            tok = jax.ShapeDtypeStruct((B, L), jnp.int32)
            batch = {"tokens": tok, "labels": tok}
            if cfg.frontend == "vision":
                batch["prefix_emb"] = jax.ShapeDtypeStruct(
                    (B, cfg.frontend_len, cfg.d_model), cfg.compute_dtype)
            if cfg.is_encdec:
                batch["frame_emb"] = jax.ShapeDtypeStruct(
                    (B, L, cfg.d_model), cfg.compute_dtype)
            for shape in PRODUCTION:
                with jsc.use_sharding_ctx(JMesh(shape, _names(shape))):
                    jax.eval_shape(lambda p, b: jlm.forward(cfg, p, b),
                                   jlm.param_shapes(cfg), batch)
            calls[arch] = sorted(set(seen), key=repr)
    finally:
        mp.undo()
    return calls


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_rules_match_the_reference(arch, shape, constrain_calls):
    jm, tm = _meshes(shape)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jax_ax, ax = jmesh.mesh_axes(jm), tmesh.mesh_axes(tm)
    assert ax == jax_ax

    # param_specs through sanitize_specs
    jshapes = jlm.param_shapes(jcfg)
    jp = jshd.sanitize_specs(jlm.param_specs(jcfg, ax["fsdp"], ax["tp"]),
                             jshapes, jm)
    tshapes = tlm.param_shapes(tcfg)
    tp = tshd.sanitize_specs(tlm.param_specs(tcfg, ax["fsdp"], ax["tp"]),
                             tshapes, tm)
    want = _ref_by_name(tcfg, jp, jshapes)
    assert set(tp) == set(want)
    got = _port_specs(tp, tm)
    assert got == want

    # train_state_specs and opt_state_specs, sanitized against the state
    E = max(jcfg.n_experts, 1)
    sds = jax.ShapeDtypeStruct
    jstate = JTrainState(
        params=jshapes, opt={"mu": jshapes, "nu": jshapes,
                             "step": sds((), jnp.int32)},
        telemetry=sds((256, E), jnp.int32), step=sds((), jnp.int32))
    js = jshd.sanitize_specs(j_train_state_specs(jcfg, JAdamW(), ax["fsdp"],
                                                 ax["tp"]), jstate, jm)
    tstate = TrainState(
        params=tshapes, opt={"mu": tshapes, "nu": tshapes,
                             "step": ((), None)},
        telemetry=((256, E), None), step=((), None))
    ts = tshd.sanitize_specs(train_state_specs(tcfg, AdamWConfig(),
                                               ax["fsdp"], ax["tp"]),
                             tstate, tm)
    placed = tshd.to_named(ts, tm)
    for part in ("mu", "nu"):
        assert _port_specs(ts.opt[part], tm) == \
            _ref_by_name(tcfg, js.opt[part], jshapes), part
    assert {k: _back(v, tm, len(tshapes[k][0]))
            for k, v in placed.params.items()} == want
    assert _back(placed.telemetry, tm, 2) == _pad(js.telemetry, 2)
    assert _back(placed.step, tm, 0) == tuple(js.step) == ()
    assert _back(placed.opt["step"], tm, 0) == tuple(js.opt["step"]) == ()

    # batch_specs for every shape cell; caches and decode inputs for the
    # decode cells (long_500k: context parallelism over the sequence)
    for jcell in JSHAPES:
        cell = SHAPES_BY_NAME[jcell.name]
        jb = jshd.batch_specs(jcfg, jcell, jm)
        tb = tshd.batch_specs(tcfg, cell, tm)
        assert set(tb) == set(jb)
        for k in jb:
            nd = len(tb[k])
            assert _back(to_placements(tb[k], tm), tm, nd) == \
                _pad(jb[k], nd), (jcell.name, k)
        if cell.mode != "decode":
            continue
        jin = jshd.decode_input_shardings(
            jcfg, jcell, j_input_specs(jcfg, jcell), jm)
        tspecs = t_input_specs(tcfg, cell)
        tin = tshd.decode_input_shardings(tcfg, cell, tspecs, tm)
        assert set(tin) == set(jin)
        assert _back(tin["tokens"], tm, 2) == _pad(jin["tokens"].spec, 2)
        if "memory" in jin:
            assert _back(tin["memory"], tm, 3) == \
                _pad(jin["memory"].spec, 3)
        assert len(tin["caches"]) == len(jin["caches"])
        for i, (tc, jc, sc) in enumerate(zip(tin["caches"], jin["caches"],
                                             tspecs["caches"])):
            assert set(tc["mixer"]) == set(jc["mixer"]), i
            for leaf, pl in tc["mixer"].items():
                nd = len(sc["mixer"][leaf][0])
                assert _back(pl, tm, nd) == _pad(jc["mixer"][leaf].spec,
                                                 nd), (cell.name, i, leaf)

    # ShardingCtx.resolve on the reference's constrain call shapes
    jctx, tctx = jsc.ShardingCtx(jm), ShardingCtx(tm)
    assert tctx.logical == jctx.logical
    for logical, shp in constrain_calls[arch]:
        want_r = _pad(jctx.resolve(logical, shp), len(shp))
        got_r = tctx.resolve(logical, shp)
        assert got_r == want_r, (logical, shp)
        assert _back(to_placements(got_r, tm), tm, len(shp)) == want_r


def test_resolve_falls_back_to_sequence_parallelism():
    """SmolLM's 9 heads do not divide a 16-way model axis: the attention
    scores' query length takes "model" instead (the "sp" fallback), on the
    port as on the reference."""
    cfg = jconfigs.get("smollm_135m")
    s = (32, cfg.n_heads, 64, 64)
    for shape in PRODUCTION:
        jm, tm = _meshes(shape)
        got = ShardingCtx(tm).resolve(("dp", "tp", "sp", None), s)
        assert got == _pad(jsc.ShardingCtx(jm).resolve(
            ("dp", "tp", "sp", None), s), 4)
        assert got[1] is None and got[2] == "model"


def test_mesh_axes_and_smoke_mesh_clamping(monkeypatch):
    for shape in MESHES:
        jm, tm = _meshes(shape)
        assert tmesh.mesh_axes(tm) == jmesh.mesh_axes(jm)
    prod = tmesh.make_production_mesh(), \
        tmesh.make_production_mesh(multi_pod=True)
    assert [(m.axis_sizes, m.axis_names) for m in prod] == [
        ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data",
                                                      "model"))]
    # the reference clamps to jax.devices(); give it n fake devices
    made = []
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shp, axes: made.append((shp, axes)))
    for n in (1, 2, 3, 4, 8):
        monkeypatch.setattr(jmesh.jax, "devices", lambda n=n: [None] * n)
        for data in range(0, 6):
            for model in range(0, 6):
                jmesh.make_smoke_mesh(data, model)
                assert made.pop() == (tmesh.smoke_shape(data, model, n),
                                      ("data", "model")), (n, data, model)
    # no process group: an abstract mesh clamped to one rank
    m = tmesh.make_smoke_mesh(2, 2)
    assert (m.axis_sizes, m.axis_names) == ((1, 1), ("data", "model"))


def test_placements_round_trip_and_reject_bad_specs():
    from torch.distributed.tensor import Replicate, Shard

    m = tmesh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert to_placements((("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert from_placements((Shard(0), Shard(0), Shard(2)), m, 3) == \
        (("pod", "data"), None, "model")
    assert to_placements((), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        to_placements((("data", "pod"),), m)
    with pytest.raises(ValueError, match="twice"):
        to_placements(("data", "data"), m)
    x = torch.ones(4, 3)
    assert constrain(x, "dp", None) is x  # no context: a no-op
    with use_sharding_ctx(m) as ctx:
        assert ctx.dp_size == 32
        assert constrain(x, "dp", None) is x  # a local tensor: unchanged
        with pytest.raises(ValueError, match="logical axes"):
            constrain(x, "dp")


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_specs_follow_the_parameters(arch):
    """``param_specs`` and ``param_shapes`` are keyed and ordered as the
    drawn parameters' ``named_parameters``, shapes equal."""
    cfg = tconfigs.get(arch, reduced=True)
    params = tlm.init_params(cfg, device="cpu")
    named = dict(params.named_parameters())
    specs, shapes = tlm.param_specs(cfg), tlm.param_shapes(cfg)
    assert list(specs) == list(named) == list(shapes)
    for k, p in named.items():
        assert tuple(p.shape) == tuple(shapes[k][0]) and \
            len(specs[k]) == p.ndim, k
    back = dict(tlm.params_from_leaves(cfg, named).named_parameters())
    assert list(back) == list(named)
    assert all(back[k].data_ptr() == p.data_ptr() for k, p in named.items())
