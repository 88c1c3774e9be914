"""The sharded trainer and the expert-parallel MoE on gloo ranks of the CPU
(``launch.step_fns.shard_state``/``make_sharded_train_step``,
``launch.train.train(mesh=)``, ``models.moe`` under a sharding context)
against the port's single-device step and ``repro``'s ``moe``.

The reference's own sharded runs fail on this box's jax (the five
sharding-API baseline failures), so the oracles are single-device: the
port's unsharded step (itself held to ``repro``'s jitted step by
``tests/test_torch_train.py``) and ``repro.models.moe.moe`` with no
context. Worlds 2 and 4 are each spawned once for the module, in
threads, and run every case of their meshes ((2, 1) and (1, 2); (2, 2))
in ``tests/torch_sharded_ranks.py``; rank 0's results come back here,
and each rank checks that its shards are the slices its placements name.

Tolerances: loss and gradient norm within 1e-5 relative, parameters within
1e-6 (AdamW at eps = 1e-3, ``tests/test_torch_train.py``'s reason), as
chip_smoke's L8 holds kernel against plain; the MoE's output, gradients
and losses within 1e-5 of their largest magnitude (f32 sums in another
order); telemetry and drop shares exactly.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as jmoe

from repro_torch import configs
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.launch.step_fns import init_train_state, make_train_step
from repro_torch.launch.train import train
from repro_torch.models.moe import moe

import torch_sharded_ranks as R

REL, ATOL = 1e-5, 1e-6
CASES = [(w, shape) for w in (2, 4) for shape in R.MESHES[w]]


@pytest.fixture(scope="module")
def pinned():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, pinned):
    """``{world: future of rank 0's results}``, both worlds spawned as the
    module starts so that the oracles compute meanwhile."""
    # made here: the base temporary directory is not made thread-safely
    tmps = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 4)}

    def spawn(world):
        tmp = tmps[world]
        return spawn_ranks(R.run, world, device="cpu",
                           init_file=tmp / "rendezvous",
                           args=(world, str(tmp)))

    with ThreadPoolExecutor(max_workers=2) as pool:
        yield {w: pool.submit(spawn, w) for w in (2, 4)}


def _unsharded(cfg, microbatches, seed):
    state = init_train_state(cfg, R.OPT, torch.Generator().manual_seed(0),
                             "cpu")
    step = make_train_step(cfg, R.OPT, microbatches)
    metrics = []
    for b in R.batches(cfg, seed):
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    params = {f"params.{k}": p.detach().numpy()
              for k, p in state.params.named_parameters()}
    return dict(metrics=metrics, params=params,
                telemetry=state.telemetry.numpy())


_ORACLES: dict = {}


def _oracle(key, fn):
    if key not in _ORACLES:
        _ORACLES[key] = fn()
    return _ORACLES[key]


def _hold_steps(got, want, what):
    assert len(got["metrics"]) == len(want["metrics"]) == R.STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert set(g) == set(w), what
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= REL * abs(w[k]), (what, i, k, g, w)
        assert g["lr"] == w["lr"], (what, i)
        for k in ("lb_loss", "dropped"):
            if k in w:
                assert abs(g[k] - w[k]) <= REL * max(abs(w[k]), 1.0), \
                    (what, i, k, g[k], w[k])
    assert list(got["params"]) == list(want["params"]), what
    for k, v in want["params"].items():
        err = float(np.abs(got["params"][k] - v).max())
        assert err <= ATOL, (what, k, err)
    np.testing.assert_array_equal(got["telemetry"], want["telemetry"])


@pytest.mark.parametrize("world,shape", CASES, ids=str)
def test_sharded_smollm_step_matches_one_device(worlds, world, shape):
    """Reduced SmolLM-135M, two steps of 2 microbatches: the sharded step
    (FSDP over data, TP over model) equals the single-device one."""
    want = _oracle("smollm", lambda: _unsharded(
        configs.get(R.SMOL, reduced=True), R.SMOL_MICROBATCHES, seed=1))
    got = worlds[world].result()[shape]["smollm"]
    _hold_steps(got, want, f"smollm {shape}")


@pytest.mark.parametrize("world,shape", CASES, ids=str)
def test_sharded_kimi_step_with_expert_parallelism(worlds, world, shape):
    """Reduced Kimi-K2 drop-free (capacity factor E / K), two steps: the
    sharded step, experts split over model where it has two ranks, equals
    the single-device one, telemetry exactly."""
    want = _oracle("kimi", lambda: _unsharded(R.kimi_config(), 1, seed=2))
    got = worlds[world].result()[shape]["kimi"]
    _hold_steps(got, want, f"kimi {shape}")
    assert want["telemetry"].sum() == 2 * R.B * R.S * 2 * \
        R.kimi_config().top_k  # two MoE layers, two steps


def _jmoe(x, ids, cf):
    cfg = jconfigs.get(R.KIMI, reduced=True)
    _, _, _, params = R.moe_inputs(configs.get(R.KIMI, reduced=True))

    def tree(d):
        return {k: tree(v) if isinstance(v, dict) else jnp.asarray(v.numpy())
                for k, v in d.items()}

    y, aux = jmoe.moe(tree(params), jnp.asarray(x), cfg,
                      token_ids=jnp.asarray(ids), capacity_factor=cf)
    return np.asarray(y), {k: np.asarray(v) for k, v in aux.items()}


def _moe_grads(cf):
    """The port's single-device layer: the gradients of the rank's loss."""
    cfg = configs.get(R.KIMI, reduced=True)
    x, ids, proj, params = R.moe_inputs(cfg)
    leaves = [params[k] for k in ("router", "w_gate", "w_up", "w_down")]
    leaves += [params["shared"][k] for k in ("w_gate", "w_up", "w_down")]
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe(params, xt, cfg, token_ids=torch.from_numpy(ids),
                 capacity_factor=R.capacity(cfg, cf))
    loss = torch.sum(y * torch.from_numpy(proj)) + \
        0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return [g.numpy() for g in torch.autograd.grad(loss, [xt] + leaves)]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, (what, err, scale)


@pytest.mark.parametrize("cf", R.MOE_CFS)
@pytest.mark.parametrize("world,shape", CASES, ids=str)
def test_expert_parallel_moe_matches_its_oracles(worlds, world, shape, cf):
    """Drop-free: the output, aux and gradients equal the single-device
    layer's (``repro``'s output and aux; the port's gradients). At capacity
    1.25: the per-shard rule — ``repro``'s ``moe`` with no context on each
    data shard's rows, with lb_loss and the z-loss global (they do not
    depend on the capacity, so the whole batch's), the dropped share the
    shards' mean and the telemetry their sum."""
    got = worlds[world].result()[shape][("moe", cf)]
    cfg = configs.get(R.KIMI, reduced=True)
    x, ids, _, _ = R.moe_inputs(cfg)
    cap = R.capacity(cfg, cf)
    y_all, aux_all = _oracle(("jmoe", "all", cf), lambda: _jmoe(x, ids, cap))
    if cf == "drop-free":
        _close(got["y"], y_all, "y")
        assert got["dropped"] == 0.0 == float(aux_all["dropped"])
        np.testing.assert_array_equal(got["telemetry"], aux_all["telemetry"])
        want = _oracle(("grads", cf), lambda: _moe_grads(cf))
        _close(got["x_grad"], want[0], "x grad")
        for i, (g, w) in enumerate(zip(got["weight_grads"], want[1:])):
            _close(g, w, f"weight grad {i}")
    else:
        n_data = shape[0]
        n = x.shape[0] // n_data
        shards = [_oracle(("jmoe", r, n_data, cf), lambda r=r: _jmoe(
            x[r * n:(r + 1) * n], ids[r * n:(r + 1) * n], cap))
            for r in range(n_data)]
        _close(got["y"], np.concatenate([s[0] for s in shards]), "y")
        dropped = np.mean([float(s[1]["dropped"]) for s in shards])
        assert abs(got["dropped"] - dropped) <= 1e-6, (got["dropped"],
                                                       dropped)
        assert got["dropped"] > 0.0
        np.testing.assert_array_equal(
            got["telemetry"], sum(s[1]["telemetry"] for s in shards))
    for k in ("lb_loss", "z_loss"):
        assert abs(got[k] - float(aux_all[k])) <= REL * abs(float(
            aux_all[k])), (k, got[k], float(aux_all[k]))


@pytest.mark.parametrize("world,shape", CASES, ids=str)
def test_sharded_resume_continues_exactly(worlds, world, shape, tmp_path):
    """SmolLM's trainer over the mesh: 3 steps, then a resume to 6 from
    the checkpoint (full leaves from rank 0, re-sharded), gives the same
    losses as 6 steps straight, bit for bit, and the port's unsharded
    resume's within 1e-5."""
    got = worlds[world].result()[shape]["resume"]
    kw = dict(R.RESUME, device="cpu")
    want = _oracle("resume", lambda: (
        train(**kw, steps=R.RESUME_SPLIT, ckpt_dir=str(tmp_path)),
        train(**kw, steps=6, resume=True, ckpt_dir=str(tmp_path))))
    assert got["first"] == got["straight"][:R.RESUME_SPLIT]
    assert got["resumed"] == got["straight"][R.RESUME_SPLIT:]
    for g, w in zip(got["first"] + got["resumed"], want[0] + want[1]):
        assert abs(g - w) <= REL * abs(w), (g, w)


def test_chip_smoke_phase_l10_rehearses_on_the_cpu(monkeypatch, capsys,
                                                   pinned, tmp_path):
    """``chip_smoke``'s L10 at the reduced configs on the CPU (a one-rank
    gloo group in this process, the flash kernels' plain versions, the
    CLI as a gloo rank) with the card's synchronisation and events
    stubbed: every comparison must hold, and the launch check only the
    card can pass must fail here."""
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
    for name, value in (("LM_REDUCED", True), ("TRAIN_BATCH", 2),
                        ("TRAIN_SEQ", 32), ("TRAIN_MICROBATCHES", 2),
                        ("TRAIN_STEPS", 20), ("TRAIN_LR", 3e-3),
                        ("TRAIN_CHECK_SEQ", 32)):
        monkeypatch.setattr(chip_smoke, name, value)
    l8 = dict(step_ms=1.0, losses=train(
        chip_smoke.TRAIN_ARCH, steps=chip_smoke.TRAIN_STEPS, smoke=True,
        batch_size=2, seq_len=32, ckpt_every=0, microbatches=2,
        log_every=100, seed=chip_smoke.SEED, lr_peak=3e-3, device="cpu",
        ckpt_dir=str(tmp_path)))
    out = chip_smoke.sharded_train_phase(torch.device("cpu"), "[cpu]", l8)
    assert out["loss_rel_to_l8"] <= chip_smoke.TRAIN_REL
    assert out["moe"]["telemetry_equal"]
    assert out["moe"]["collectives"]["all_gather"]["calls"] >= 8
    assert out["cli"]["exit"] == 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(AssertionError, match="L10: flash launches"):
        chip_smoke.check_sharded_train_on_the_card(
            configs.get(chip_smoke.TRAIN_ARCH, reduced=True), out)
    text = capsys.readouterr().out
    assert "L10 sharded train" in text and "L10 one step" in text
    assert "expert-parallel branch" in text and "L10 launch.train" in text
