// Causal GQA attention by online softmax (flash attention) for the LM
// substrate: out[b,h,i] = sum_j softmax_j(scale q[b,h,i] . k[b,h/g,j])
// v[b,h/g,j], g = Hq / Hkv, scale = 1/sqrt(dh).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// flash_attention_kernel (body _flash_body) and computes what that body
// computes: the causal mask on absolute positions with its top-left rule
// i >= j (masked scores -1e30), a running max m, sum l and dh-wide
// accumulator per row in f32, the result acc / max(l, 1e-30) cast to the
// input type. Ragged lengths are masked here (keys j >= Lk score -1e30,
// rows i >= Lq are not stored), so the wrapper pads nothing.
//
// Design: FlashAttention-2 on the tensor cores through mma.sync.
//   - one block of 4 warps per (query head of one batch row, 64-row query
//     tile); each warp owns 16 query rows. The tiles of one head run
//     heaviest-first, so the long causal rows start early. Query head h
//     reads KV head h / g in place (no repeat copy).
//   - K and V tiles of BK keys stream through a 2-stage ring in dynamic
//     shared memory, filled by cp.async (16 B a thread, coalesced; rows
//     j >= Lk zero-filled through the src-size operand); tile t+1's copy
//     overlaps tile t's math, one barrier a tile. Rows are padded (8
//     elements for Q and K, 8 bf16 or 4 f32 for V) so that every fragment
//     load below is free of bank conflicts.
//   - S = Q K^T and O += P V run on the tensor cores; S, P, O and the
//     running m and l stay in registers for the whole KV loop. Row max
//     and sum reduce over each row's quad with __shfl_xor_sync; the sum
//     stays per thread until the epilogue. Exponentials are ex2.approx with a
//     log2(e) prescale (masked scores are set to -1e30 after it).
//   - bf16: mma m16n8k16 bf16 with f32 accumulation. Q fragments live in
//     registers (ldmatrix once), K through ldmatrix, V through
//     ldmatrix.trans. The scale multiplies the f32 scores after the
//     product, where JAX scales q before the dot: the two differ only by
//     f32 rounding. P is rounded to bf16 for P V (the m16n8 accumulators
//     of two adjacent key tiles are the m16n8k16 A fragment as they
//     stand); l sums P before that rounding.
//   - f32: split-TF32. Each operand x is split into hi = tf32(x) and
//     lo = tf32(x - hi), both by cvt.rna (raw f32 bits fed to a tf32 MMA
//     would be truncated and break the error bound), and each product is
//     hi.hi + hi.lo + lo.hi on mma m16n8k8 tf32 with f32 accumulation
//     (lo.lo, ~2^-22 relative, is dropped): ~2^-21 relative a product,
//     ~1e-6 on an output at these shapes, where single-pass TF32 gives
//     ~1e-4 and fails the 2e-5 check. Q is scaled in f32 first, as JAX
//     does, and kept in shared memory (its hi and lo fragments for
//     dh=128 would not fit the register budget beside O); fragments are
//     split as they are loaded. The m16n8 accumulator holds keys 2t and
//     2t+1 of each 8-key group where the m16n8k8 A fragment wants k = t
//     and t+4: P V takes the MMA's k = t as key 2t and k = t+4 as key
//     2t+1, and reads V's rows 2t and 2t+1 to match (a permutation of
//     the sum's terms; no pass through shared memory). The same
//     permutation over dh within each 8-column group lets a thread load
//     its Q and K elements as one float2. The tensor cores round each
//     MMA's sum at the scale of its accumulator, so long chains through
//     one accumulator lose accuracy: S keeps its hi.hi and lo terms in
//     two accumulators, and each tile's P V starts from zero and joins O
//     by one fmaf with alpha. On an H100 at Qwen3-8B's launch this took
//     the largest error from 9.3e-6 to 2.2e-6 and the time down by a
//     quarter (the chains are shorter and independent).
//   - causal KV tiles wholly above the diagonal are not visited, by the
//     block or, within the last tile, by a warp: such a tile would leave
//     m unchanged, give alpha = 1 and add p = 0. Tile 0 is visited first,
//     and every row keeps key 0, so each running max is finite before a
//     -1e30 score appears and masked scores add exactly 0.
//
// Bound: operations, on the tensor cores. A causal call needs 4 dh flops
// per kept (i, j) pair, B Hq dh L(L+1)/2 * 4. bf16: over 989 TFLOP/s
// ([2,32,2048,128]: 6.875e10 flops, 0.070 ms). f32 at f32 accuracy:
// 3 x flops over the 495 TFLOP/s dense TF32 rate, split-TF32 being the
// cheapest way the card has to that accuracy (Qwen3-8B's launch
// [1,32,8192,128]: 3 x 5.498e11, 3.33 ms; its 0.34 GB of q, k, v and out
// take 0.1 ms at 3.35 TB/s). mma.sync reaches a part of the card's
// tensor rate that wgmma reaches in full; the FA3 shape (a TMA producer
// warp feeding warp-specialised wgmma consumers) is the next redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int DH>
struct Tile {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // 32-key tiles for bf16 and for f32 at dh=128 (f32: two blocks fit an
  // SM; bf16: three, and 20 % less time at [2,32,2048,128] on an H100);
  // 64 for the f32 head dims whose registers and shared memory allow it
  static constexpr int BK = (BF16 || DH == 128) ? 32 : 64;
  static constexpr int NT = BK / 8;       // n8 key tiles of S
  static constexpr int ND = DH / 8;       // n8 column tiles of O
  static constexpr int QS = DH + 8;       // Q and K row stride, elements
  static constexpr int VS = BF16 ? DH + 8 : DH + 4;
  static constexpr int Q = BQ * QS;       // elements
  static constexpr int K = BK * QS;
  static constexpr int V = BK * VS;
  static constexpr int CH = DH * (int)sizeof(T) / 16;  // 16 B chunks a row
  static constexpr int EPC = 16 / (int)sizeof(T);      // elements a chunk
  static constexpr size_t bytes = (size_t)(Q + 2 * (K + V)) * sizeof(T);
};

// 2^x, flushing results below 2^-126 to zero (p that small adds nothing
// next to l >= 1); ex2.approx's error is 2 ulp, as exp2f's
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo + O(2^-22 |x|), hi and lo each a tf32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// a b in split-TF32: c += hi.hi, cl += lo.hi + hi.lo (c and cl may be
// one accumulator). Apart, they are two independent MMA chains and c's
// is a third as long: an MMA rounds its sum at the scale of its
// accumulator, so the fewer MMAs the full-size sum passes through, the
// closer the result (cl's roundings are at its own ~2^-11 smaller scale)
__device__ __forceinline__ void mma_split(float (&c)[4], float (&cl)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  mma_tf32(cl, al, bh0, bh1);
  mma_tf32(cl, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the KV tile of keys k0 .. k0 + BK - 1 into ring slot (sK, sV)
template <typename T, int DH>
__device__ __forceinline__ void load_kv(T* sK, T* sV, const T* k, const T* v,
                                        int64_t kv_base, int k0, int Lk,
                                        int tid) {
  using C = Tile<T, DH>;
  for (int e = tid; e < C::BK * C::CH; e += THREADS) {
    const int r = e / C::CH, c = (e % C::CH) * C::EPC, j = k0 + r;
    const bool ok = j < Lk;
    const int64_t off = kv_base + (int64_t)(ok ? j : 0) * DH + c;
    cp_async16(sK + r * C::QS + c, k + off, ok);
    cp_async16(sV + r * C::VS + c, v + off, ok);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    lsk_flash_attention_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ out,
                               int Hq, int Hkv, int Lq, int Lk, int causal,
                               float scale) {
  using C = Tile<T, DH>;
  constexpr int BK = C::BK, NT = C::NT, ND = C::ND;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK0 = sQ + C::Q;  // ring slot s: K at sK0 + s K, V at sV0 + s V
  T* sV0 = sK0 + 2 * C::K;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row group, column
  const int bh = blockIdx.x;              // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int r0 = 16 * warp;               // this warp's first row
  const int b = bh / Hq, h = bh % Hq;
  const int64_t q_base = (int64_t)bh * Lq * DH;
  const int64_t kv_base = ((int64_t)b * Hkv + h / (Hq / Hkv)) * Lk * DH;

  const int q_last = min(q0 + BQ, Lq) - 1;
  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q_last / BK + 1);

  // stage Q (rows i >= Lq as zeros) and KV tile 0
  if constexpr (C::BF16) {
    for (int e = tid; e < BQ * C::CH; e += THREADS) {
      const int r = e / C::CH, c = (e % C::CH) * C::EPC, i = q0 + r;
      cp_async16(sQ + r * C::QS + c,
                 q + q_base + (int64_t)(i < Lq ? i : 0) * DH + c, i < Lq);
    }
  } else {  // f32: scaled on the way in, as JAX scales q before the dot
    for (int e = tid; e < BQ * C::CH; e += THREADS) {
      const int r = e / C::CH, c = (e % C::CH) * 4, i = q0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < Lq)
        x = *reinterpret_cast<const float4*>(q + q_base + (int64_t)i * DH + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      *reinterpret_cast<float4*>(sQ + r * C::QS + c) = x;
    }
  }
  if (n_tiles > 0) load_kv<T, DH>(sK0, sV0, k, v, kv_base, 0, Lk, tid);
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // bf16: this warp's Q fragments, once, in registers
  uint32_t qf[C::BF16 ? DH / 16 : 1][4];
  if constexpr (C::BF16) {
    const T* p = sQ + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * C::QS +
                 (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) ldsm_x4(qf[ks], p + 16 * ks);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};          // this thread's part of the running sum
  // scores to the log2 domain: bf16 scales here, f32 scaled Q already
  const float sl2 = C::BF16 ? scale * LOG2E : LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    if (t + 1 < n_tiles)
      load_kv<T, DH>(sK0 + ((t + 1) & 1) * C::K, sV0 + ((t + 1) & 1) * C::V,
                     k, v, kv_base, k0 + BK, Lk, tid);
    cp_commit();
    const T* sK = sK0 + (t & 1) * C::K;
    const T* sV = sV0 + (t & 1) * C::V;

    // a tile wholly above this warp's rows changes nothing: skip it
    if (!causal || k0 <= q0 + r0 + 15) {
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;

      // ---- S = Q K^T
      if constexpr (C::BF16) {
        // x4: b0, b1 of key tiles n and n + 1
        const T* p = sK + ((lane & 7) + (lane >> 4) * 8) * C::QS +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t kb[4];
            ldsm_x4(kb, p + n * 8 * C::QS + 16 * ks);
            mma_bf16(s[n], qf[ks], kb[0], kb[1]);
            mma_bf16(s[n + 1], qf[ks], kb[2], kb[3]);
          }
      } else {
        // k = t4 is column 2 t4 and k = t4 + 4 is column 2 t4 + 1 of each
        // 8-column group, in Q and K alike
        float sl[NT][4];  // the lo terms of S
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sl[n][e] = 0.f;
        const float* pq = sQ + (r0 + g) * C::QS + 2 * t4;
        const float* pk = sK + g * C::QS + 2 * t4;
#pragma unroll 2
        for (int ks = 0; ks < DH / 8; ++ks) {
          const float2 x0 = *reinterpret_cast<const float2*>(pq + 8 * ks);
          const float2 x1 =
              *reinterpret_cast<const float2*>(pq + 8 * C::QS + 8 * ks);
          uint32_t ah[4], al[4];
          split(x0.x, ah[0], al[0]);
          split(x1.x, ah[1], al[1]);
          split(x0.y, ah[2], al[2]);
          split(x1.y, ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float2 y =
                *reinterpret_cast<const float2*>(pk + n * 8 * C::QS + 8 * ks);
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

      // ---- online softmax, in registers
      const bool masked = k0 + BK > Lk || (causal && k0 + BK - 1 > q0 + r0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * sl2;
          if (masked) {
            const int i = q0 + r0 + g + (e >> 1) * 8;
            const int j = k0 + 8 * n + 2 * t4 + (e & 1);
            if (j >= Lk || (causal && i < j)) x = NEG_INF;
          }
          s[n][e] = x;
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_cur = fmaxf(m[r], mx);
        alpha[r] = exp2_ftz(m[r] - m_cur);
        m[r] = m_cur;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          s[n][2 * r] = exp2_ftz(s[n][2 * r] - m_cur);
          s[n][2 * r + 1] = exp2_ftz(s[n][2 * r + 1] - m_cur);
          sum += s[n][2 * r] + s[n][2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + sum;
      }

      // ---- O = alpha O + P V
      if constexpr (C::BF16) {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
        // x4.trans: b0, b1 of column tiles n and n + 1
        const T* p = sV + ((lane & 7) + ((lane >> 3) & 1) * 8) * C::VS +
                     (lane >> 4) * 8;
#pragma unroll
        for (int u = 0; u < BK / 16; ++u) {
          uint32_t pa[4];
          pa[0] = pack_bf16(s[2 * u][0], s[2 * u][1]);
          pa[1] = pack_bf16(s[2 * u][2], s[2 * u][3]);
          pa[2] = pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]);
          pa[3] = pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3]);
#pragma unroll
          for (int n = 0; n < ND; n += 2) {
            uint32_t vb[4];
            ldsm_x4_t(vb, p + 16 * u * C::VS + 8 * n);
            mma_bf16(o[n], pa, vb[0], vb[1]);
            mma_bf16(o[n + 1], pa, vb[2], vb[3]);
          }
        }
      } else {
        // k = t4 is key 2 t4 and k = t4 + 4 is key 2 t4 + 1 of the group:
        // the accumulator's own layout, matched by V's rows
        // this tile's P V starts from zero in its own accumulator, so no
        // MMA rounds at the scale of the whole row's O and the MMAs do not
        // wait for alpha
        float pv[ND][4];
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
        const float* pV = sV + 2 * t4 * C::VS + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t ah[4], al[4];
          split(s[j][0], ah[0], al[0]);
          split(s[j][2], ah[1], al[1]);
          split(s[j][1], ah[2], al[2]);
          split(s[j][3], ah[3], al[3]);
          const float* pj = pV + 8 * j * C::VS;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            uint32_t bh0, bl0, bh1, bl1;
            split(pj[8 * n], bh0, bl0);
            split(pj[C::VS + 8 * n], bh1, bl1);
            mma_split(pv[n], pv[n], ah, al, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n][e] = fmaf(o[n][e], alpha[e >> 1], pv[n][e]);
      }
    }
    cp_wait_all();  // tile t + 1 has landed
    __syncthreads();  // and every warp is done with slot t & 1
  }

  // ---- epilogue: the quad's sums, acc / max(l, 1e-30), rows i < Lq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + r0 + g + 8 * r;
    if (i >= Lq) continue;
    T* po = out + q_base + (int64_t)i * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(po + 8 * n, o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Lq, int Lk, int causal, cudaStream_t stream) {
  const size_t smem = Tile<T, DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      lsk_flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Lq + BQ - 1) / BQ));
  // the JAX kernel's scale: 1.0 / (dh ** 0.5) in double, then to f32
  const float scale = (float)(1.0 / sqrt((double)DH));
  lsk_flash_attention_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Lq, Lk,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int Lq, int Lk, int dh, int causal,
             cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<16, T>(q, k, v, out, B, Hq, Hkv, Lq, Lk, causal, stream);
    case 32:
      return launch<32, T>(q, k, v, out, B, Hq, Hkv, Lq, Lk, causal, stream);
    case 64:
      return launch<64, T>(q, k, v, out, B, Hq, Hkv, Lq, Lk, causal, stream);
    case 128:
      return launch<128, T>(q, k, v, out, B, Hq, Hkv, Lq, Lk, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int lsk_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int Hq, int Hkv, int Lq,
                                   int Lk, int dh, int causal, int is_bf16,
                                   void* stream) {
  if (B == 0 || Hq == 0 || Lq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (Lq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  // cp.async and the vector loads and stores move 16, 8 or 4 B at a time
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Lq, Lk,
                                           dh, causal, s)
                 : dispatch<float>(q, k, v, out, B, Hq, Hkv, Lq, Lk, dh,
                                   causal, s);
}
