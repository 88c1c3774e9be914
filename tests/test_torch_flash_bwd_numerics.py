"""The CUDA flash backward's roundings, emulated in plain torch on the CPU,
against ``jax.grad`` of the JAX reference attention and the port's plain
backward, at the tolerances the card's tests hold the kernel to.

``csrc/flash_attention_bwd.cu`` computes on the tensor cores in two
kernels. The dq kernel walks tiles of BT keys: S = q k^T and dP = dout
v^T, P = exp2(S scale log2(e) - lse log2(e)) (0 where the causal rule
masks), dS = P (dP - D), dq += dS k. The dkdv kernel walks each KV head's
query heads and, for each, tiles of BT queries: S^T = k q^T and dP^T =
v dout^T, then dV += P^T dout and dK += dS^T q. Its f32 variant splits
every operand x into hi = tf32(x) and lo = tf32(x - hi) (round to nearest,
ties away from zero) and takes each product as hi.hi + hi.lo + lo.hi: the
score products keep hi.hi and the lo terms apart until the tile's end, and
the gradient products sum each tile's terms from zero before they join the
gradient. Its bf16 variant multiplies bf16 operands exactly with f32 sums
and rounds P and dS to bf16 before their products. Above dh=128 each
score's dot is two dots over the halves of dh (a warp pair's), added in
f32. ``emulate_backward`` repeats those tiles and roundings; its sums are
torch's f32 sums, in their own order. The tolerances are the card's,
unchanged: max |d| over the largest |reference| of dq, dk and dv below
1e-5 in f32 and 1e-2 in bf16. Single-pass TF32 (the lo terms dropped) is
shown to fail the f32 one, so the card's check catches a kernel that
dropped them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import reference_attention

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_plain, flash_attention_plain)

from test_torch_flash_numerics import HEAD_DIMS, SPLIT_ABOVE, split, tf32

LOG2E = np.float32(1.4426950408889634)
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The emulation's matmuls are small: one intra-op thread is faster
    alone and does not spin against the other test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tile_rows(dh: int, mode: str) -> int:
    """BT, the rows of a streamed tile (keys in dq, queries in dkdv)."""
    if mode == "bf16":
        return 64 if dh <= 64 else 32
    return 64 if dh <= 32 else 32 if dh <= 128 else 16


def score_product(a, b, mode: str):
    """a @ b as a score product's MMAs take it: split-TF32 with the hi.hi
    and the lo terms in two sums, added at the tile's end."""
    if mode == "split":
        (ah, al), (bh, bl) = split(a), split(b)
        return ah @ bh + (al @ bh + ah @ bl)
    if mode == "single":
        return tf32(a) @ tf32(b)
    return a @ b  # bf16 operands: exact products, f32 sums


def grad_product(a, b, mode: str):
    """One tile's a @ b as a gradient product's MMAs take it, summed from
    zero; in bf16 a (P or dS) is rounded to bf16 first."""
    if mode == "split":
        (ah, al), (bh, bl) = split(a), split(b)
        return al @ bh + ah @ bl + ah @ bh
    if mode == "single":
        return tf32(a) @ tf32(b)
    return a.to(torch.bfloat16).float() @ b


def emulate_backward(q, k, v, out, lse, dout, causal: bool, mode: str):
    """(dq, dk, dv) by the kernels' arithmetic on CPU tensors; ``mode`` is
    "split" (the f32 variant), "single" (single-pass TF32, which it must
    not be) or "bf16". Lq = Lk; the grads come back in q's dtype."""
    B, Hq, L, dh = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    bt = tile_rows(dh, mode)
    hd = dh // (2 if dh > SPLIT_ABOVE else 1)
    scale = np.float32(1.0 / np.sqrt(dh))
    sl2 = float(scale * LOG2E)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    l2 = lse * float(LOG2E)
    dd = (dof * of).sum(-1)

    def scores(a, b):
        return sum(score_product(a[..., h:h + hd],
                                 b[..., h:h + hd].transpose(-1, -2), mode)
                   for h in range(0, dh, hd))

    idx = torch.arange(L)
    # the dq kernel: key tiles
    kr, vr = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    dq = torch.zeros(B, Hq, L, dh)
    for k0 in range(0, L, bt):
        kt, vt = kr[:, :, k0:k0 + bt], vr[:, :, k0:k0 + bt]
        p = torch.exp2(scores(qf, kt) * sl2 - l2[..., None])
        if causal:
            p = p.masked_fill(idx[:, None] < idx[None, k0:k0 + bt], 0.0)
        ds = p * (scores(dof, vt) - dd[..., None])
        dq = dq + grad_product(ds, kt, mode)
    # the dkdv kernel: each KV head's query heads, query tiles of each
    qg, dog = (t.reshape(B, Hkv, g, L, dh) for t in (qf, dof))
    l2g, ddg = (t.reshape(B, Hkv, g, L) for t in (l2, dd))
    dk, dv = torch.zeros(B, Hkv, L, dh), torch.zeros(B, Hkv, L, dh)
    for hh in range(g):
        for m0 in range(0, L, bt):
            qt, dot = qg[:, :, hh, m0:m0 + bt], dog[:, :, hh, m0:m0 + bt]
            pt = torch.exp2(scores(kf, qt) * sl2
                            - l2g[:, :, hh, None, m0:m0 + bt])
            if causal:
                pt = pt.masked_fill(idx[None, m0:m0 + bt] < idx[:, None], 0.0)
            dst = pt * (scores(vf, dot) - ddg[:, :, hh, None, m0:m0 + bt])
            dv = dv + grad_product(pt, dot, mode)
            dk = dk + grad_product(dst, qt, mode)
    return ((dq * float(scale)).to(q.dtype), (dk * float(scale)).to(k.dtype),
            dv.to(v.dtype))


def rel_errors(got, want) -> list:
    """max |d| of dq, dk and dv, each over the largest |want| of the three
    (the card's measure)."""
    scale = max(float(w.float().abs().max()) for w in want)
    return [float((a.float() - b.float()).abs().max()) / scale
            for a, b in zip(got, want)]


def inputs(Hkv, group, L, dh, dtype, seed):
    """q, k, v, dout as torch tensors in ``dtype`` (f32 arrays first)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                             ).to(dtype)
            for s in ((1, Hkv * group, L, dh), (1, Hkv, L, dh),
                      (1, Hkv, L, dh), (1, Hkv * group, L, dh))]


@functools.lru_cache(maxsize=None)
def _jax_grad(causal):
    def f(q, k, v, do):
        return jax.grad(lambda a, b, c: jnp.sum(
            reference_attention(a, b, c, causal) * do), argnums=(0, 1, 2))(
            q, k, v)
    return jax.jit(f)


def jax_grads(q, k, v, do, causal):
    """jax.grad of the reference attention on the same values, in f32."""
    got = _jax_grad(causal)(*[jnp.asarray(t.float().numpy())
                              for t in (q, k, v, do)])
    return [torch.from_numpy(np.array(x)) for x in got]


CASES = [pytest.param(dh, grp, causal, dtype,
                      id=f"dh{dh}-g{grp}-{'causal' if causal else 'full'}"
                      f"-{str(dtype)[6:]}")
         for dh in HEAD_DIMS for grp in (1, 4) for causal in (True, False)
         for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("dh,group,causal,dtype", CASES)
def test_backward_roundings_hold_the_card_tolerance(dh, group, causal,
                                                    dtype):
    """A ragged length (130: past every tile size) with GQA (g = 4) and
    without, against the plain backward and jax.grad."""
    q, k, v, do = inputs(2, group, 130, dh, dtype, seed=7 * dh + group)
    out, lse = flash_attention_plain(q, k, v, causal, lse=True)
    mode = "bf16" if dtype == torch.bfloat16 else "split"
    got = emulate_backward(q, k, v, out, lse, do, causal, mode)
    for a, t in zip(got, (q, k, v)):
        assert a.dtype == dtype and a.shape == t.shape
    for ref in (flash_attention_backward_plain(q, k, v, out, lse, do, causal),
                jax_grads(q, k, v, do, causal)):
        errs = rel_errors(got, ref)
        assert max(errs) < TOL[dtype], errs


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_single_pass_tf32_fails_the_f32_tolerance(dh):
    q, k, v, do = inputs(2, 4, 130, dh, torch.float32, seed=dh)
    out, lse = flash_attention_plain(q, k, v, True, lse=True)
    want = flash_attention_backward_plain(q, k, v, out, lse, do, True)
    err_split = max(rel_errors(
        emulate_backward(q, k, v, out, lse, do, True, "split"), want))
    err_single = max(rel_errors(
        emulate_backward(q, k, v, out, lse, do, True, "single"), want))
    assert err_split < TOL[torch.float32] <= err_single, (err_split,
                                                          err_single)
