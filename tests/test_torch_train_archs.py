"""The port's training loss and its gradient for every architecture of
the registry, against the JAX package on the CPU at the reduced configs
(batch 2 x 32): ``repro_torch.models.lm.loss_fn`` differentiated by
autograd (every global GQA layer through the flash ``FlashAttention``
function and its plain backward) against
``jax.value_and_grad(repro.models.lm.loss_fn, has_aux=True)`` on the same
parameters (carried by ``lm.from_jax_params``) and the same batch; the
JAX gradient tree goes through the same mapping, so every leaf is
compared with its counterpart by name.

Tolerances (f32 on both sides; the same math in another order of
operations): the loss within LOSS_REL = 1e-5 of its value; each leaf's
gradient within GRAD_REL = 1e-4 of that leaf's largest |gradient|
(RECURRENT_GRAD_REL = 5e-4 for the archs with recurrent mixers, whose
backward carries f32 sums through every step of the scans, and whose
forward already holds 5e-5 in ``tests/test_torch_lm_archs.py``); the aux
losses within 1e-5 absolute; the MoE telemetry exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm

import repro_torch.configs as tconfigs
from repro_torch.models import lm as tlm

RECURRENT = ("jamba_15_large_398b", "xlstm_13b")
LOSS_REL, GRAD_REL, RECURRENT_GRAD_REL, AUX_TOL = 1e-5, 1e-4, 5e-4, 1e-5
B, S, FRAMES = 2, 32, 16


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.frontend == "vision":
        batch["prefix_emb"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frame_emb"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jcfg = jconfigs.get(arch, reduced=True)
    tcfg = tconfigs.get(arch, reduced=True)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg)

    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))
    (jloss, jaux), jgrads = grad_fn(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    tp = tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, params))
    tp.requires_grad_(True)
    tloss, taux = tlm.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    names, leaves = zip(*tp.named_parameters())
    tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True)

    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    assert set(jaux) == set(taux)
    for k in ("lb_loss", "z_loss", "dropped"):
        assert abs(float(jaux[k]) - float(taux[k])) < AUX_TOL, k
    np.testing.assert_array_equal(np.asarray(jaux["telemetry"]),
                                  taux["telemetry"].numpy())

    want = dict(tlm.from_jax_params(
        tcfg, jax.tree.map(np.asarray, jgrads)).named_parameters())
    assert set(want) == set(names)
    rel = RECURRENT_GRAD_REL if arch in RECURRENT else GRAD_REL
    worst = {}
    for name, g in zip(names, tgrads):
        w = want[name].detach().numpy()
        got = np.zeros_like(w) if g is None else g.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        worst[name] = float(np.abs(got - w).max()) / scale
    bad = {k: v for k, v in worst.items() if v > rel}
    assert not bad, bad
