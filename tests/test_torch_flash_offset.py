"""The flash kernels' query offset on the CPU: ``flash_attention_plain``
and ``flash_attention_backward_plain`` (and ``attention()``'s autograd
function through them) with ``q_offset`` against the reference's
``repro.models.attention._attn_block(q_offset=...)`` and its ``jax.grad``.

A block of ``Lq`` query rows sits at absolute positions ``q_offset ..
q_offset + Lq - 1`` of an L-long sequence and attends causally to all L
keys (the "sp" fallback's rank at ``q_offset = r L / tp``). GQA as the
split layers run it (3 query heads over 1 KV head, SmolLM's local
shape; 4 over 2), a length that is not a multiple of a tile, offsets 0,
L/2 and 3L/4. ``q_offset = 0`` on the whole sequence is the unsplit
call. Tolerance: f32 on both sides, 1e-5 of the largest magnitude of
each output, as ``tests/test_torch_train.py`` holds the gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _attn_block

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import attention

TOL = 1e-5
SHAPES = [(2, 3, 1, 96, 16), (1, 4, 2, 64, 64)]  # B, Hq, Hkv, L, dh


def _inputs(B, Hq, Hkv, L, dh, Lq):
    rng = np.random.default_rng(L + dh + Lq)
    q = rng.standard_normal((B, Hq, Lq, dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, L, dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, L, dh)).astype(np.float32)
    do = rng.standard_normal((B, Hq, Lq, dh)).astype(np.float32)
    return q, k, v, do


def _reference(q, k, v, do, off):
    """The reference's block attention and the gradient of sum(out do)."""
    g = q.shape[1] // k.shape[1]
    dh = q.shape[-1]

    def f(a, b, c):
        return _attn_block(a, jnp.repeat(b, g, axis=1),
                           jnp.repeat(c, g, axis=1), off, dh, True, 0)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(do))]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _cases():
    for B, Hq, Hkv, L, dh in SHAPES:
        yield B, Hq, Hkv, L, dh, 0, L
        for off in (L // 2, 3 * L // 4):
            yield B, Hq, Hkv, L, dh, off, L // 4


@pytest.mark.parametrize("B,Hq,Hkv,L,dh,off,Lq", list(_cases()))
def test_plain_versions_at_an_offset_match_the_reference(B, Hq, Hkv, L, dh,
                                                         off, Lq):
    q, k, v, do = _inputs(B, Hq, Hkv, L, dh, Lq)
    want, (dq, dk, dv) = _reference(q, k, v, do, off)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fk.flash_attention_plain(tq, tk, tv, True, lse=True,
                                        q_offset=off)
    _close(out, want, "out")
    got = fk.flash_attention_backward_plain(tq, tk, tv, out, lse, tdo, True,
                                            q_offset=off)
    for g, w, name in zip(got, (dq, dk, dv), ("dq", "dk", "dv")):
        _close(g, w, name)
    # the rows' log-sum-exp: each row's keys 0 .. off + i
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, Hq // Hkv, 1)) / \
        np.sqrt(dh)
    s = np.where(np.arange(L)[None, :] <= off + np.arange(Lq)[:, None], s,
                 -np.inf)
    m = s.max(-1)
    ref_lse = m + np.log(np.exp(s - m[..., None]).sum(-1))
    _close(lse, ref_lse, "lse")


@pytest.mark.parametrize("off", [0, 48])
def test_autograd_function_takes_the_offset(off):
    """``attention(q, k, v, q_offset=)`` through ``FlashAttention`` (plain
    forward with lse, plain backward on the CPU: no launch) equals the
    reference and its gradient."""
    B, Hq, Hkv, L, dh, Lq = 1, 3, 1, 96, 16, 48
    q, k, v, do = _inputs(B, Hq, Hkv, L, dh, Lq)
    want, grads = _reference(q, k, v, do, off)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = (fk.flash_attention_kernel.launches,
              fk.flash_attention_backward_kernel.launches)
    out = attention(*ts, causal=True, q_offset=off)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    assert (fk.flash_attention_kernel.launches,
            fk.flash_attention_backward_kernel.launches) == before
    _close(out.detach(), want, "out")
    for g, w, name in zip(got, grads, ("dq", "dk", "dv")):
        _close(g, w, name)


def test_offset_zero_is_the_unsplit_call():
    """``q_offset=0`` gives the call without it, bit for bit."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 3, 1, 96, 16, 96))
    a, la = fk.flash_attention_plain(q, k, v, True, lse=True)
    b, lb = fk.flash_attention_plain(q, k, v, True, lse=True, q_offset=0)
    assert torch.equal(a, b) and torch.equal(la, lb)
    ga = fk.flash_attention_backward_plain(q, k, v, a, la, do, True)
    gb = fk.flash_attention_backward_plain(q, k, v, a, la, do, True, 0)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_split_rows_rebuild_the_whole_sequence():
    """The blocks of rows at offsets 0, L/4, L/2 and 3L/4 joined are the
    whole sequence's attention (the "sp" fallback's identity)."""
    B, Hq, Hkv, L, dh = 2, 3, 1, 96, 16
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(B, Hq, Hkv, L, dh, L))
    whole = fk.flash_attention_plain(q, k, v, True)
    n = L // 4
    parts = [fk.flash_attention_plain(q[:, :, r * n:(r + 1) * n].contiguous(),
                                      k, v, True, q_offset=r * n)
             for r in range(4)]
    _close(torch.cat(parts, 2), whole.numpy(), "joined")


def test_wrapper_rejects_a_negative_offset():
    with pytest.raises(ValueError, match="q_offset"):
        fk._check_offset(-1)
