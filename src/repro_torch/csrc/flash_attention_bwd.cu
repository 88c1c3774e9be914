// The gradient of causal GQA flash attention: given q, k, v, the forward's
// out and per-row log-sum-exp lse (flash_attention.cu with a non-null
// lse) and dout, the gradients dq, dk and dv.
//
// Replaces no TPU kernel: the JAX flash kernel
// (repro/kernels/flash_attention/kernel.py flash_attention_kernel) has no
// VJP, and the JAX trainer differentiates its masked XLA attention
// instead. The port's global GQA layers run the CUDA forward, so a
// gradient step through them needs this backward. The formulas, those of
// flash_attention_backward_plain in kernels/flash_attention/kernel.py:
//   S = q k^T scale, P = exp(S - lse) (0 where the top-left causal rule
//   q_offset + i >= j masks, or j >= Lk; query row i sits at absolute
//   position q_offset + i, as in the forward), D = rowsum(dout o out),
//   dV = P^T dout, dS = P o (dout v^T - D),
//   dq = dS k scale, dk = dS^T q scale,
// dk and dv summed over the g = Hq / Hkv query heads of each KV head.
//
// Design: two kernels on the tensor cores through mma.sync (the forward's
// machinery, mma.cuh), no atomics, so every gradient is a fixed sum in a
// fixed order (bitwise repeatable, as exact resume needs).
//   - lsk_flash_bwd_dq: one block per (b Hq, 64 query rows), heaviest
//     tiles first; each warp owns 16 rows. Q and dout are staged once (and
//     D = rowsum(dout o out) is computed from them and written for the
//     second kernel); K and V tiles of BT keys stream through a two-stage
//     cp.async ring. Per tile: S = Q K^T and dP = dout V^T, P and dS in
//     registers (exponent in the log2 domain by ex2.approx), dq += dS K.
//   - lsk_flash_bwd_dkdv: one block per (b Hkv, 64 keys), heaviest key
//     tiles first; each warp owns 16 keys, whose dK and dV stay in f32
//     registers. It walks the g query heads and, for each, the query tiles
//     from its keys' diagonal on (query rows i >= n0 - q_offset; Q, dout,
//     lse and D through the ring). It computes the transposed tile,
//     S^T = K Q^T and dP^T = V dout^T, so that P^T and dS^T come out in
//     the accumulator layout and feed dV += P^T dout and dK += dS^T q as
//     A operands.
//   So both kernels run one tile shape: 16 own rows against a streamed
//   tile (two score products whose B operand is a tile's rows, as the
//   forward's K), then products whose A operand is a score accumulator
//   and whose B operand is a tile's rows read down the columns (as the
//   forward's V).
//   - f32: split-TF32 m16n8k8, each operand split by cvt.rna into tf32 hi
//     and lo as it is loaded (hi.hi + hi.lo + lo.hi). The score products
//     keep hi.hi and the lo terms in two accumulators; the gradient
//     products start each tile's sum over its BT keys or queries from
//     zero, per 8-column group, and add it into the f32 gradient registers
//     (one accumulator chained through the whole walk loses accuracy: the
//     forward measured 9.3e-6 against 2.2e-6). The score products permute
//     dh within each 8-column group (k = t is column 2t, k = t+4 column
//     2t+1) so that a thread loads its A and B elements as float2; the
//     gradient products take an accumulator's columns 2t and 2t+1 as the
//     MMA's k = t and t+4, swapped for t >= 2, and read the B rows to
//     match: at a row stride of dh + 8 floats both the float2 loads of a
//     tile's rows and these scalar loads down its columns are free of bank
//     conflicts.
//   - bf16: m16n8k16 with f32 sums. Operands stay bf16 in shared memory;
//     A and B of the score products by ldmatrix, B of the gradient
//     products by ldmatrix.trans. P and dS are rounded to bf16 for their
//     products (as FlashAttention-2), and the products chain into the
//     gradient registers. Gradients are written in the input type.
//   - above dh=128, and in the f32 dkdv kernel from dh=128, a pair of warps
//     shares each 16 rows, each owning half of dh (the forward's SPLIT):
//     each computes its half of every score's dot, the pair adds the two
//     through shared memory, and each then multiplies into its own half of
//     the gradient's columns.
//   - registers (ptxas on sm_90a): 96-255 a thread. The f32 dkdv kernel at
//     dh=128 took 255 and spilled unsplit, 173 split, and 12 % less time
//     at Qwen3-8B's launch on an H100; at dh=96 and in bf16 the split took
//     10 % and 27 % more, and so did 16-query tiles for bf16 dkdv at
//     dh=128 (13 %), which runs at 255 with 20 bytes of spill stores.
//     Where ptxas caps a kernel below 255 for occupancy (168: three
//     blocks an SM), it spills 4-16 bytes.
//   - streamed tiles of BT rows: 64 for bf16 to dh=64 and f32 to dh=32,
//     16 for f32 at dh=256 (whose dq kernel takes 227,840 B of shared
//     memory of the 232,448 a block may have), 32 otherwise.
//
// Bound: operations. A causal backward is taken as 2.5 times the
// forward's 4 dh flops per kept (i, j) pair (FlashAttention-2's
// accounting: five dh-deep products against the forward's two); these
// kernels do 14 dh (S and dP in both kernels, dq, dk, dv), 1.4 times
// that. f32 at split-TF32's 3 MMAs a product over 495 TFLOP/s, bf16 over
// 989. On an H100 (PERF.md) the pair reaches 0.16-0.17 of that bound at
// SmolLM-135M's training launch (dh=64, f32), 0.12 at Qwen3-8B's (dh=128),
// 0.085 at dh=256 and 0.15-0.16 in bf16 at dh=128: 2.7x, 2.2x, 1.5x and 17x
// less time than the first design (f32 FMAs on the SIMT cores), and
// faster than SDPA's f32 backward at dh=64. mma.sync with operands split
// as they are loaded (each warp splits the whole streamed tile again)
// reaches a part of the tensor rate. What remains: the FA3 shape (wgmma
// from shared memory fed by TMA; tf32 wgmma needs K-major B, so transposed
// copies of q and dout), and one S a tile pair with dq by ordered
// accumulation (10 dh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int ROWS = 64;  // a block's own rows: queries (dq), keys (dkdv)
constexpr int ROW_WARPS = ROWS / 16;
constexpr float LOG2E = 1.4426950408889634f;

// KV: the dkdv kernel's (its warps hold two gradients, dK and dV, where
// the dq kernel's hold one)
template <typename T, int DH, bool KV>
struct Bwd {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // a pair of warps shares each 16 rows, each owning half of dh: above
  // dh=128, and in the f32 dkdv kernel at dh=128 (see "registers" above)
  static constexpr int SPLIT = DH > 128 || (KV && !BF16 && DH == 128) ? 2 : 1;
  static constexpr int DW = DH / SPLIT;  // dh columns a warp owns
  static constexpr int WARPS = ROW_WARPS * SPLIT;
  static constexpr int THREADS = 32 * WARPS;
  // rows of a streamed tile: keys (dq), queries (dkdv)
  static constexpr int BT =
      BF16 ? (DH <= 64 ? 64 : 32) : (DH <= 32 ? 64 : (DH <= 128 ? 32 : 16));
  static constexpr int NT = BT / 8;  // n8 column tiles of a score tile
  static constexpr int ND = DW / 8;  // n8 column tiles of a warp's gradient
  static constexpr int S = DH + 8;   // row stride of every tile, elements
  static constexpr int OWN = ROWS * S;
  static constexpr int TILE = BT * S;
  // the pair's partial scores and dP: [2][SPLIT][ROWS][XS] f32, rows padded
  // so that the float2 stores and loads are free of bank conflicts
  static constexpr int XS = BT + 8;
  static constexpr int X = SPLIT > 1 ? 2 * SPLIT * ROWS * XS : 0;
  // own rows (2 matrices), a two-stage ring of 2 tiles, then f32: the
  // exchange and the row statistics (dq: lse and D of its own rows; dkdv:
  // the ring's lse and D of each tile's queries)
  static constexpr size_t bytes = (size_t)(2 * OWN + 4 * TILE) * sizeof(T) +
                                  (size_t)(X + (KV ? 4 * BT : 2 * ROWS)) * 4;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows r0 .. r0 + R - 1 of two [L, DH] matrices at one offset into shared
// memory at row stride DH + 8, by cp.async; rows at or past L as zeros
template <typename T, int DH, int R, int NTHREADS>
__device__ __forceinline__ void load_rows(T* d1, T* d2, const T* s1,
                                          const T* s2, int64_t base, int r0,
                                          int L, int tid) {
  constexpr int CH = DH * (int)sizeof(T) / 16;  // 16 B chunks a row
  constexpr int EPC = 16 / (int)sizeof(T);
  for (int e = tid; e < R * CH; e += NTHREADS) {
    const int r = e / CH, c = (e % CH) * EPC, i = r0 + r;
    const bool ok = i < L;
    const int64_t off = base + (int64_t)(ok ? i : 0) * DH + c;
    cp_async16(d1 + r * (DH + 8) + c, s1 + off, ok);
    cp_async16(d2 + r * (DH + 8) + c, s2 + off, ok);
  }
}

template <typename T>
__device__ __forceinline__ void zero(T& a) {
#pragma unroll
  for (int n = 0; n < (int)(sizeof(T) / sizeof(a[0])); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

// s = A B^T: this warp's 16 rows of A (A points at its first row and
// column) against the NT * 8 rows of a tile B, over DW columns. f32:
// split-TF32 with the hi.hi and lo terms in two accumulators, k = t the
// column 2t and k = t + 4 the column 2t + 1 of each 8-column group, in A
// and B alike
template <int DW, int NT, int S>
__device__ __forceinline__ void scores(const float* A, const float* B,
                                       int lane, float (&s)[NT][4]) {
  const int g = lane / 4, t4 = lane % 4;
  float sl[NT][4];
  zero(s);
  zero(sl);
  const float* pa = A + g * S + 2 * t4;
  const float* pb = B + g * S + 2 * t4;
#pragma unroll 2
  for (int ks = 0; ks < DW / 8; ++ks) {
    const float2 x0 = *reinterpret_cast<const float2*>(pa + 8 * ks);
    const float2 x1 = *reinterpret_cast<const float2*>(pa + 8 * S + 8 * ks);
    uint32_t ah[4], al[4];
    split(x0.x, ah[0], al[0]);
    split(x1.x, ah[1], al[1]);
    split(x0.y, ah[2], al[2]);
    split(x1.y, ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 y =
          *reinterpret_cast<const float2*>(pb + n * 8 * S + 8 * ks);
      uint32_t bh0, bl0, bh1, bl1;
      split(y.x, bh0, bl0);
      split(y.y, bh1, bl1);
      mma_split(s[n], sl[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += sl[n][e];
}

// bf16: A fragments by ldmatrix, B's by ldmatrix x4 (b0, b1 of column
// tiles n and n + 1)
template <int DW, int NT, int S>
__device__ __forceinline__ void scores(const __nv_bfloat16* A,
                                       const __nv_bfloat16* B, int lane,
                                       float (&s)[NT][4]) {
  zero(s);
  const __nv_bfloat16* pa =
      A + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
  const __nv_bfloat16* pb =
      B + ((lane & 7) + (lane >> 4) * 8) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < DW / 16; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, pa + 16 * ks);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t kb[4];
      ldsm_x4(kb, pb + n * 8 * S + 16 * ks);
      mma_bf16(s[n], af, kb[0], kb[1]);
      mma_bf16(s[n + 1], af, kb[2], kb[3]);
    }
  }
}

// acc += x B: x a score accumulator (16 rows by the tile's NT * 8 rows of
// B), B's rows read down DW columns from B (its first column). f32: the
// MMA's k = t and t + 4 are x's columns 2t and 2t + 1 of each 8-column
// group, swapped for t >= 2 (so that the 8 rows a load instruction reads
// fall in 8 different bank groups at a row stride of dh + 8), and each
// 8-column group of acc gets this tile's sum from a zeroed accumulator
template <int ND, int NT, int S>
__device__ __forceinline__ void product(float (&acc)[ND][4],
                                        const float (&x)[NT][4],
                                        const float* B, int lane) {
  const int g = lane / 4, t4 = lane % 4;
  const bool swp = t4 >= 2;
  uint32_t ah[NT][4], al[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split(swp ? x[j][1] : x[j][0], ah[j][0], al[j][0]);  // row g, k = t
    split(swp ? x[j][3] : x[j][2], ah[j][1], al[j][1]);  // row g + 8
    split(swp ? x[j][0] : x[j][1], ah[j][2], al[j][2]);  // row g, k = t + 4
    split(swp ? x[j][2] : x[j][3], ah[j][3], al[j][3]);
  }
  // row 2t + swp is k = t; k = t + 4 is the other of the two
  const float* pb = B + (2 * t4 + swp) * S + g;
  const int d1 = swp ? -S : S;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* pj = pb + 8 * j * S + 8 * n;
      uint32_t bh0, bl0, bh1, bl1;
      split(pj[0], bh0, bl0);
      split(pj[d1], bh1, bl1);
      mma_split(t, t, ah[j], al[j], bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
  }
}

// bf16: x rounded to bf16 (the m16n8 accumulators of two adjacent column
// tiles are the m16n8k16 A fragment as they stand), B by ldmatrix.trans
// (b0, b1 of column tiles n and n + 1); chained into acc
template <int ND, int NT, int S>
__device__ __forceinline__ void product(float (&acc)[ND][4],
                                        const float (&x)[NT][4],
                                        const __nv_bfloat16* B, int lane) {
  const __nv_bfloat16* p =
      B + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
  for (int u = 0; u < NT / 2; ++u) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * u][0], x[2 * u][1]);
    pa[1] = pack_bf16(x[2 * u][2], x[2 * u][3]);
    pa[2] = pack_bf16(x[2 * u + 1][0], x[2 * u + 1][1]);
    pa[3] = pack_bf16(x[2 * u + 1][2], x[2 * u + 1][3]);
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      uint32_t vb[4];
      ldsm_x4_t(vb, p + 16 * u * S + 8 * n);
      mma_bf16(acc[n], pa, vb[0], vb[1]);
      mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
    }
  }
}

// the pair adds its two halves of each score's and dP's dot; a + b ==
// b + a, so both warps hold the same sums from here on
template <int NT, int XS>
__device__ __forceinline__ void pair_add(float (&s)[NT][4],
                                         float (&dp)[NT][4], float* sX,
                                         int half, int r0, int lane,
                                         int pair) {
  constexpr int Q = 2 * ROWS * XS;  // one quantity's two halves
  const int g = lane / 4, t4 = lane % 4;
  float* mine = sX + (half * ROWS + r0 + g) * XS + 2 * t4;
  const float* other = sX + ((1 - half) * ROWS + r0 + g) * XS + 2 * t4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    store2(mine + 8 * n, s[n][0], s[n][1]);
    store2(mine + 8 * XS + 8 * n, s[n][2], s[n][3]);
    store2(mine + Q + 8 * n, dp[n][0], dp[n][1]);
    store2(mine + Q + 8 * XS + 8 * n, dp[n][2], dp[n][3]);
  }
  pair_sync(pair);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 a = *reinterpret_cast<const float2*>(other + 8 * n);
    const float2 b = *reinterpret_cast<const float2*>(other + 8 * XS + 8 * n);
    const float2 c = *reinterpret_cast<const float2*>(other + Q + 8 * n);
    const float2 d =
        *reinterpret_cast<const float2*>(other + Q + 8 * XS + 8 * n);
    s[n][0] += a.x;
    s[n][1] += a.y;
    s[n][2] += b.x;
    s[n][3] += b.y;
    dp[n][0] += c.x;
    dp[n][1] += c.y;
    dp[n][2] += d.x;
    dp[n][3] += d.y;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(Bwd<T, DH, false>::THREADS)
    lsk_flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ out,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ delta, T* __restrict__ dq,
                            int Hq, int Hkv, int Lq, int Lk, int causal,
                            int q_off, float scale) {
  using C = Bwd<T, DH, false>;
  constexpr int BT = C::BT, NT = C::NT, ND = C::ND, S = C::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + C::OWN;
  T* sK0 = sdO + C::OWN;  // ring slot s: K at sK0 + s TILE, V at sV0 + s TILE
  T* sV0 = sK0 + 2 * C::TILE;
  float* sX = reinterpret_cast<float*>(sV0 + 2 * C::TILE);
  float* sL = sX + C::X;  // lse log2(e) of the block's rows
  float* sD = sL + ROWS;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x;  // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // heaviest first
  const int pair = warp % ROW_WARPS, half = warp / ROW_WARPS;
  const int r0 = 16 * pair, c0 = C::DW * half;
  const int b = bh / Hq, h = bh % Hq;
  const int64_t q_base = (int64_t)bh * Lq * DH;
  const int64_t kv_base = ((int64_t)b * Hkv + h / (Hq / Hkv)) * Lk * DH;

  int n_tiles = (Lk + BT - 1) / BT;
  if (causal)
    n_tiles = min(n_tiles, (q_off + min(q0 + ROWS, Lq) - 1) / BT + 1);

  load_rows<T, DH, ROWS, C::THREADS>(sQ, sdO, q, dout, q_base, q0, Lq, tid);
  if (n_tiles > 0)
    load_rows<T, DH, BT, C::THREADS>(sK0, sV0, k, v, kv_base, 0, Lk, tid);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  // D = rowsum(dout o out): a warp a row, out read once from memory
  for (int r = warp; r < ROWS; r += C::WARPS) {
    const int i = q0 + r;
    float acc = 0.f;
    if (i < Lq) {
      const T* po = out + q_base + (int64_t)i * DH;
      for (int c = 4 * lane; c < DH; c += 128)
        acc = dot4(acc, load4(po + c), load4(sdO + r * S + c));
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      sD[r] = acc;
      sL[r] = i < Lq ? lse[(int64_t)bh * Lq + i] * LOG2E : 0.f;
      if (i < Lq) delta[(int64_t)bh * Lq + i] = acc;
    }
  }
  __syncthreads();
  const float l2[2] = {sL[r0 + g], sL[r0 + g + 8]};
  const float dd[2] = {sD[r0 + g], sD[r0 + g + 8]};
  const float sl2 = scale * LOG2E;

  float acc[ND][4];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    if (t + 1 < n_tiles)
      load_rows<T, DH, BT, C::THREADS>(sK0 + ((t + 1) & 1) * C::TILE,
                                       sV0 + ((t + 1) & 1) * C::TILE, k, v,
                                       kv_base, k0 + BT, Lk, tid);
    cp_commit();
    const T* sK = sK0 + (t & 1) * C::TILE;
    const T* sV = sV0 + (t & 1) * C::TILE;
    // a tile wholly above this warp's rows adds nothing: skip it
    if (!causal || k0 <= q_off + q0 + r0 + 15) {
      float s[NT][4], dp[NT][4];
      scores<C::DW, NT, S>(sQ + r0 * S + c0, sK + c0, lane, s);
      scores<C::DW, NT, S>(sdO + r0 * S + c0, sV + c0, lane, dp);
      if constexpr (C::SPLIT > 1)
        pair_add<NT, C::XS>(s, dp, sX, half, r0, lane, pair);
      const bool masked = k0 + BT > Lk || q0 + r0 + 16 > Lq ||
                          (causal && k0 + BT - 1 > q_off + q0 + r0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(fmaf(s[n][e], sl2, -l2[e >> 1]));
          if (masked) {
            const int i = q0 + r0 + g + (e >> 1) * 8;
            const int j = k0 + 8 * n + 2 * t4 + (e & 1);
            if (j >= Lk || i >= Lq || (causal && q_off + i < j)) p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - dd[e >> 1]);  // dS
        }
      product<ND, NT, S>(acc, dp, sK + c0, lane);
    }
    cp_wait_all();    // tile t + 1 has landed
    __syncthreads();  // and every warp is done with slot t & 1
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + r0 + g + 8 * r;
    if (i >= Lq) continue;
    T* p = dq + q_base + (int64_t)i * DH + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(p + 8 * n, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(Bwd<T, DH, true>::THREADS)
    lsk_flash_bwd_dkdv_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int Hq,
                              int Hkv, int Lq, int Lk, int causal, int q_off,
                              float scale) {
  using C = Bwd<T, DH, true>;
  constexpr int BT = C::BT, NT = C::NT, ND = C::ND, S = C::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + C::OWN;
  T* sQ0 = sV + C::OWN;  // ring slot s: q at sQ0 + s TILE, dout at sdO0 + ..
  T* sdO0 = sQ0 + 2 * C::TILE;
  float* sX = reinterpret_cast<float*>(sdO0 + 2 * C::TILE);
  float* sL0 = sX + C::X;  // slot s: the tile's lse at sL0 + s BT
  float* sD0 = sL0 + 2 * BT;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bkv = blockIdx.x;       // b * Hkv + kv head
  const int n0 = blockIdx.y * ROWS;  // tile 0 has the most query rows
  const int pair = warp % ROW_WARPS, half = warp / ROW_WARPS;
  const int r0 = 16 * pair, c0 = C::DW * half;
  const int b = bkv / Hkv, hk = bkv % Hkv, grp = Hq / Hkv;
  const int64_t kv_base = (int64_t)bkv * Lk * DH;

  // query rows i >= n0 - q_off are the only ones a causal key n0.. can
  // reach; the walk is grp heads of n_m query tiles each
  const int m_first = causal ? max(n0 - q_off, 0) : 0;
  const int n_m = Lq > m_first ? (Lq - m_first + BT - 1) / BT : 0;
  const int n_tiles = grp * n_m;
  auto load_tile = [&](int t) {
    const int slot = t & 1, m0 = m_first + (t % n_m) * BT;
    const int bh = b * Hq + hk * grp + t / n_m;
    load_rows<T, DH, BT, C::THREADS>(sQ0 + slot * C::TILE,
                                     sdO0 + slot * C::TILE, q, dout,
                                     (int64_t)bh * Lq * DH, m0, Lq, tid);
    for (int e = tid; e < BT; e += C::THREADS) {
      const int i = m0 + e;
      const bool ok = i < Lq;
      const int64_t off = (int64_t)bh * Lq + (ok ? i : 0);
      cp_async4(sL0 + slot * BT + e, lse + off, ok);
      cp_async4(sD0 + slot * BT + e, delta + off, ok);
    }
  };

  load_rows<T, DH, ROWS, C::THREADS>(sK, sV, k, v, kv_base, n0, Lk, tid);
  if (n_tiles > 0) load_tile(0);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  const float sl2 = scale * LOG2E;

  float dk_acc[ND][4], dv_acc[ND][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_commit();
    const int m0 = m_first + (t % n_m) * BT;
    const T* sQ = sQ0 + (t & 1) * C::TILE;
    const T* sdO = sdO0 + (t & 1) * C::TILE;
    const float* sL = sL0 + (t & 1) * BT;
    const float* sD = sD0 + (t & 1) * BT;
    // a query tile wholly before this warp's keys adds nothing: skip it
    if (!causal || q_off + m0 + BT - 1 >= n0 + r0) {
      float s[NT][4], dp[NT][4];  // S^T and dP^T: keys by queries
      scores<C::DW, NT, S>(sK + r0 * S + c0, sQ + c0, lane, s);
      scores<C::DW, NT, S>(sV + r0 * S + c0, sdO + c0, lane, dp);
      if constexpr (C::SPLIT > 1)
        pair_add<NT, C::XS>(s, dp, sX, half, r0, lane, pair);
      const bool masked = m0 + BT > Lq || n0 + r0 + 16 > Lk ||
                          (causal && q_off + m0 < n0 + r0 + 15);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 lv = *reinterpret_cast<const float2*>(sL + 8 * n + 2 * t4);
        const float2 dv2 =
            *reinterpret_cast<const float2*>(sD + 8 * n + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? lv.y : lv.x, d = (e & 1) ? dv2.y : dv2.x;
          float p = exp2_ftz(fmaf(s[n][e], sl2, -l * LOG2E));
          if (masked) {
            const int j = n0 + r0 + g + (e >> 1) * 8;
            const int i = m0 + 8 * n + 2 * t4 + (e & 1);
            if (i >= Lq || j >= Lk || (causal && q_off + i < j)) p = 0.f;
          }
          s[n][e] = p;                     // P^T
          dp[n][e] = p * (dp[n][e] - d);   // dS^T
        }
      }
      product<ND, NT, S>(dv_acc, s, sdO + c0, lane);
      product<ND, NT, S>(dk_acc, dp, sQ + c0, lane);
    }
    cp_wait_all();    // tile t + 1 has landed
    __syncthreads();  // and every warp is done with slot t & 1
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = n0 + r0 + g + 8 * r;
    if (j >= Lk) continue;
    const int64_t off = kv_base + (int64_t)j * DH + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      store2(dk + off + 8 * n, dk_acc[n][2 * r] * scale,
             dk_acc[n][2 * r + 1] * scale);
      store2(dv + off + 8 * n, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// the JAX kernel's scale: 1.0 / (dh ** 0.5) in double, then to f32
template <int DH>
float scale_of() {
  return (float)(1.0 / sqrt((double)DH));
}

template <int DH, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const float* lse, float* delta, void* dq,
              int B, int Hq, int Hkv, int Lq, int Lk, int causal, int q_off,
              cudaStream_t stream) {
  using C = Bwd<T, DH, false>;
  const size_t smem = C::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      lsk_flash_bwd_dq_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Lq + ROWS - 1) / ROWS));
  lsk_flash_bwd_dq_kernel<T, DH><<<grid, C::THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, (const T*)dout,
      lse, delta, (T*)dq, Hq, Hkv, Lq, Lk, causal, q_off, scale_of<DH>());
  return (int)cudaGetLastError();
}

template <int DH, typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lk,
                int causal, int q_off, cudaStream_t stream) {
  using C = Bwd<T, DH, true>;
  const size_t smem = C::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      lsk_flash_bwd_dkdv_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hkv), (unsigned)((Lk + ROWS - 1) / ROWS));
  lsk_flash_bwd_dkdv_kernel<T, DH><<<grid, C::THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Hq, Hkv, Lq, Lk, causal, q_off, scale_of<DH>());
  return (int)cudaGetLastError();
}

#define LSK_BWD_HEAD_DIMS(X) X(16) X(32) X(64) X(96) X(128) X(256)

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                int B, int Hq, int Hkv, int Lq, int Lk, int dh, int causal,
                int q_off, cudaStream_t s) {
  switch (dh) {
#define LSK_CASE(D)                                                        \
  case D:                                                                  \
    return launch_dq<D, T>(q, k, v, out, dout, lse, delta, dq, B, Hq, Hkv, \
                           Lq, Lk, causal, q_off, s);
    LSK_BWD_HEAD_DIMS(LSK_CASE)
#undef LSK_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dkdv(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lk,
                  int dh, int causal, int q_off, cudaStream_t s) {
  switch (dh) {
#define LSK_CASE(D)                                                      \
  case D:                                                                \
    return launch_dkdv<D, T>(q, k, v, dout, lse, delta, dk, dv, B, Hq,   \
                             Hkv, Lq, Lk, causal, q_off, s);
    LSK_BWD_HEAD_DIMS(LSK_CASE)
#undef LSK_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int check_args(int B, int Hq, int Hkv, int Lq, int Lk, int q_off,
               std::initializer_list<const void*> ptrs) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Lq < 0 || Lk < 0 || q_off < 0 ||
      (Lq + ROWS - 1) / ROWS > 65535 || (Lk + ROWS - 1) / ROWS > 65535 ||
      B < 0)
    return (int)cudaErrorInvalidValue;
  // cp.async and the vector loads and stores move 16 B at a time
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

// D (delta, f32 [B, Hq, Lq]) and dq; run before lsk_flash_bwd_dkdv, which
// reads delta
extern "C" int lsk_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* out, const void* dout,
                                const void* lse, void* delta, void* dq, int B,
                                int Hq, int Hkv, int Lq, int Lk, int dh,
                                int causal, int is_bf16, int q_offset,
                                void* stream) {
  if (B == 0 || Hq == 0 || Lq == 0) return 0;
  const int rc =
      check_args(B, Hq, Hkv, Lq, Lk, q_offset, {q, k, v, out, dout, dq});
  if (rc) return rc;
  if ((uintptr_t)lse % 4 || (uintptr_t)delta % 4)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch_dq<__nv_bfloat16>(q, k, v, out, dout,
                                              (const float*)lse,
                                              (float*)delta, dq, B, Hq, Hkv,
                                              Lq, Lk, dh, causal, q_offset, s)
                 : dispatch_dq<float>(q, k, v, out, dout, (const float*)lse,
                                      (float*)delta, dq, B, Hq, Hkv, Lq, Lk,
                                      dh, causal, q_offset, s);
}

extern "C" int lsk_flash_bwd_dkdv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Hq, int Hkv,
                                  int Lq, int Lk, int dh, int causal,
                                  int is_bf16, int q_offset, void* stream) {
  if (B == 0 || Hkv == 0 || Lk == 0) return 0;
  const int rc =
      check_args(B, Hq, Hkv, Lq, Lk, q_offset, {q, k, v, dout, dk, dv});
  if (rc) return rc;
  if ((uintptr_t)lse % 4 || (uintptr_t)delta % 4)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16
             ? dispatch_dkdv<__nv_bfloat16>(q, k, v, dout, (const float*)lse,
                                            (const float*)delta, dk, dv, B,
                                            Hq, Hkv, Lq, Lk, dh, causal,
                                            q_offset, s)
             : dispatch_dkdv<float>(q, k, v, dout, (const float*)lse,
                                    (const float*)delta, dk, dv, B, Hq, Hkv,
                                    Lq, Lk, dh, causal, q_offset, s);
}
