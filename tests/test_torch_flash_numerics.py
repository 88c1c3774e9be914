"""The CUDA flash kernel's roundings, emulated in plain torch on the CPU,
against the JAX kernel (Pallas interpret mode) and the port's plain
version, at the tolerances the card's tests hold the kernel to.

``csrc/flash_attention.cu`` computes on the tensor cores. Its f32 variant
splits every operand x into hi = tf32(x) and lo = tf32(x - hi) (round to
nearest, ties away from zero) and takes each product as
hi.hi + hi.lo + lo.hi with f32 sums; its bf16 variant multiplies the f32
scores by the scale after the product and rounds the softmax weights to
bf16 before the product with V, while the row sum takes them unrounded.
Both run the online softmax over tiles of 32 keys (64 for f32 below
dh=128) in the log2 domain. ``emulate`` repeats those roundings and
tiles; its sums are torch's f32 sums, in their own order. The
tolerances are the card's, unchanged: f32 |d| < 2e-5, bf16
|d| <= 2**-7 max(|want|, 1). Single-pass TF32 (the lo terms dropped) is
shown to fail the f32 one, so the card's check catches a kernel that
dropped them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as j_flash

from repro_torch.kernels.flash_attention.kernel import flash_attention_plain

LOG2E = 1.4426950408889634
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 by bit ops: add half of the 13 dropped bits to the
    magnitude's bits (ties go away from zero) and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, mode: str):
    """a @ b as the kernel's MMAs take it, every sum in f32."""
    if mode == "split":
        (ah, al), (bh, bl) = split(a), split(b)
        return al @ bh + ah @ bl + ah @ bh
    if mode == "single":
        return tf32(a) @ tf32(b)
    return a @ b  # bf16 operands: exact products, f32 sums


def emulate(q, k, v, causal: bool, mode: str):
    """The kernel's arithmetic on CPU tensors; ``mode`` is "split" (its f32
    variant), "single" (single-pass TF32, which it must not be) or "bf16".
    Returns the output in q's dtype."""
    B, Hq, Lq, dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    bk = 32 if mode == "bf16" or dh == 128 else 64
    scale = np.float32(1.0 / (dh ** 0.5))
    qf = q.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    if mode == "bf16":
        sl2 = float(np.float32(scale * np.float32(LOG2E)))
    else:
        qf, sl2 = qf * float(scale), float(np.float32(LOG2E))
    m = torch.full((B, Hq, Lq, 1), NEG_INF)
    l = torch.zeros(B, Hq, Lq, 1)
    acc = torch.zeros(B, Hq, Lq, dh)
    i = torch.arange(Lq)[:, None]
    for k0 in range(0, Lk, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = product(qf, kt.transpose(-1, -2), mode) * sl2
        if causal:
            j = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(i < j, NEG_INF)
        m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_cur)
        p = torch.exp2(s - m_cur)
        l = l * alpha + p.sum(-1, keepdim=True)
        if mode == "bf16":
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha + product(p, vt, mode)
        m = m_cur
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def within(got, want) -> tuple:
    """(max |got - want|, whether every element is within the card's
    tolerance for got's dtype)."""
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        ok = bool((d <= 2.0 ** -7 * want.float().abs().clamp_min(1)).all())
    else:
        ok = float(d.max()) < 2e-5
    return float(d.max()), ok


def inputs(Hkv, group, L, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((1, Hkv * group, L, dh), (1, Hkv, L, dh),
                      (1, Hkv, L, dh))]


# causal at a ragged length (not a multiple of the 64-key tile); the JAX
# wrapper takes non-causal calls only at its 128-row block multiple
CASES = [pytest.param(dh, grp, causal, dtype,
                      id=f"dh{dh}-g{grp}-{'causal' if causal else 'full'}"
                      f"-{dtype}")
         for dh in HEAD_DIMS for grp in (1, 4) for causal in (True, False)
         for dtype in ("f32", "bf16")]


@pytest.mark.parametrize("dh,group,causal,dtype", CASES)
def test_kernel_roundings_hold_the_card_tolerance(dh, group, causal, dtype):
    L = 100 if causal else 128
    arrs = inputs(2, group, L, dh, seed=dh + group + L)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    want_jax = torch.from_numpy(np.asarray(j_flash(
        *[jnp.asarray(a, jdt) for a in arrs], causal=causal,
        impl="pallas_interpret").astype(jnp.float32))).to(tdt)
    q, k, v = [torch.from_numpy(a).to(tdt) for a in arrs]
    want = flash_attention_plain(q, k, v, causal)
    got = emulate(q, k, v, causal, "bf16" if dtype == "bf16" else "split")
    assert got.dtype == tdt and got.shape == q.shape
    for ref in (want, want_jax):
        err, ok = within(got, ref)
        assert ok, (dtype, err)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_single_pass_tf32_fails_the_f32_tolerance(dh):
    q, k, v = map(torch.from_numpy, inputs(2, 4, 100, dh, seed=dh))
    want = flash_attention_plain(q, k, v, True)
    err_split, ok_split = within(emulate(q, k, v, True, "split"), want)
    err_single, ok_single = within(emulate(q, k, v, True, "single"), want)
    assert ok_split and not ok_single, (err_split, err_single)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the last bit tf32 keeps above 1
    x = torch.tensor([1.0 + 2.0 ** -11,         # a tie: away from zero
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23,  # below the tie: down
                      one + 2.0 ** -11,              # a tie above an odd
                      3.0e-3, -7.5], dtype=torch.float32)
    got = tf32(x).tolist()
    assert got[:4] == [one, -one, 1.0, one + 2.0 ** -10]
    # hi + lo keeps every bit of x to 2**-22 relative
    hi, lo = split(x)
    assert bool(((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all())
    assert bool((tf32(hi) == hi).all() and (tf32(lo) == lo).all())
