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
//   i >= j masks, or j >= Lk), D = rowsum(dout o out),
//   dV = P^T dout, dS = P o (dout v^T - D),
//   dq = dS k scale, dk = dS^T q scale,
// dk and dv summed over the g = Hq / Hkv query heads of each KV head.
//
// Design: two kernels, no atomics, so every gradient is a fixed sum in a
// fixed order (bitwise repeatable, as exact resume needs).
//   - lsk_flash_bwd_dq: one block of 256 threads per (b Hq, 64 query
//     rows). It stages its rows of q and dout, computes D for them (and
//     writes it for the second kernel), then walks the key tiles the
//     causal rule admits: S and dout v^T for the block, P and dS, and
//     dq += dS k, the dq rows in registers for the whole walk.
//   - lsk_flash_bwd_dkdv: one block per (b Hkv, key tile), heaviest key
//     tiles first. It stages its keys and values once and walks the g
//     query heads of its group and, for each, the query tiles at or after
//     its first key, recomputing P from lse and dS from D; dk and dv rows
//     stay in f32 registers across the group.
//   Every tile lives in shared memory in f32 (bf16 inputs are widened as
//   they are staged), rows padded by 4 floats so that the 16-byte loads
//   of 8 rows by a warp fall in 8 different bank groups. Products are
//   f32 FMAs on the SIMT cores: a thread computes a row of a tile by 16 B
//   shared loads, 4 FMAs each. Gradients are written in the input type.
//   - registers (ptxas on sm_90a): 106-180 a thread, no spills; capping
//     them at 128 for two blocks an SM spilled at every head dim above 16
//     and was no faster on an H100 (SmolLM-135M's layer 40.6 ms against
//     39.1).
//   - head dims 16, 32, 64, 96, 128 and 256; at 96 and above the key (dq)
//     and query (dkdv) tiles are 32 rows, so that a block's tiles fit
//     shared memory (dq at dh=256: 208.6 KB of 227).
//
// Bound: operations. A causal backward is taken as 2.5 times the
// forward's 4 dh flops per kept (i, j) pair; these kernels do 14 dh
// (S and dout v^T twice, dq, dk, dv), on f32 SIMT FMAs (67 TFLOP/s), a
// first design: the next is mma.sync or wgmma with split-TF32 as the
// forward's, and one S per tile pair (FA2's backward).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int THREADS = 256;

template <int DH>
struct Bwd {
  static constexpr int DS = DH + 4;  // f32 row stride of a staged tile
  // dq kernel: BQ query rows a block, key tiles of BK
  static constexpr int BQ = 64;
  static constexpr int BK = DH <= 64 ? 64 : 32;
  // dkdv kernel: BN keys a block, query tiles of BM
  static constexpr int BN = DH <= 128 ? 64 : 32;
  static constexpr int BM = DH <= 64 ? 64 : 32;
  static constexpr size_t dq_bytes =
      ((size_t)(2 * BQ + 2 * BK) * DS + (size_t)BQ * (BK + 1) + 2 * BQ) *
      sizeof(float);
  static constexpr size_t dkdv_bytes =
      ((size_t)(2 * BN + 2 * BM) * DS + (size_t)2 * BM * (BN + 1) + 2 * BM) *
      sizeof(float);
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
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ void axpy4(float (&acc)[4], float s, float4 x) {
  acc[0] = fmaf(s, x.x, acc[0]);
  acc[1] = fmaf(s, x.y, acc[1]);
  acc[2] = fmaf(s, x.z, acc[2]);
  acc[3] = fmaf(s, x.w, acc[3]);
}

// rows r0 .. r0 + R - 1 of a [L, DH] matrix into shared memory as f32 at
// row stride DH + 4; rows at or past L as zeros
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int R,
                                      int L) {
  constexpr int C4 = DH / 4;
  for (int e = threadIdx.x; e < R * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, i = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < L) x = load4(src + (int64_t)i * DH + c);
    store4(dst + r * Bwd<DH>::DS + c, x);
  }
}

// S and dP of one tile pair: rows A (q) and A2 (dout) of this thread's
// row against NJ columns of B (k) and B2 (v), columns tc + TPR j
template <int DH, int TPR, int NJ>
__device__ __forceinline__ void scores(const float* a, const float* a2,
                                       const float* B, const float* B2,
                                       int tc, float (&s)[NJ],
                                       float (&dp)[NJ]) {
  constexpr int DS = Bwd<DH>::DS;
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    const float4 x = load4(a + d), o = load4(a2 + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tc + TPR * j;
      s[j] = dot4(s[j], x, load4(B + c * DS + d));
      dp[j] = dot4(dp[j], o, load4(B2 + c * DS + d));
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    lsk_flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ out,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ delta, T* __restrict__ dq,
                            int Hq, int Hkv, int Lq, int Lk, int causal,
                            float scale) {
  using C = Bwd<DH>;
  constexpr int BQ = C::BQ, BK = C::BK, DS = C::DS, XS = BK + 1;
  constexpr int TPR = THREADS / BQ;  // threads a query row
  constexpr int NJ = BK / TPR;       // S columns a thread
  constexpr int NU = DH / 4 / TPR;   // 4-column groups of dq a thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * DS;
  float* sK = sdO + BQ * DS;
  float* sV = sK + BK * DS;
  float* sdS = sV + BK * DS;  // [BQ][XS]
  float* sL = sdS + BQ * XS;
  float* sD = sL + BQ;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;  // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int b = bh / Hq, h = bh % Hq;
  const int64_t q_base = (int64_t)bh * Lq * DH;
  const int64_t kv_base = ((int64_t)b * Hkv + h / (Hq / Hkv)) * Lk * DH;

  stage<T, DH>(sQ, q + q_base, q0, BQ, Lq);
  stage<T, DH>(sdO, dout + q_base, q0, BQ, Lq);
  __syncthreads();
  // D = rowsum(dout o out): a warp a row, out read once from memory
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int i = q0 + r;
    float acc = 0.f;
    if (i < Lq) {
      const T* po = out + q_base + (int64_t)i * DH;
      for (int c = 4 * lane; c < DH; c += 128)
        acc = dot4(acc, load4(po + c), load4(sdO + r * DS + c));
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      sD[r] = acc;
      sL[r] = i < Lq ? lse[(int64_t)bh * Lq + i] : 0.f;
      if (i < Lq) delta[(int64_t)bh * Lq + i] = acc;
    }
  }

  const int r = tid / TPR, tc = tid % TPR, i = q0 + r;
  float acc[NU][4];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;

  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Lq) - 1) / BK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's dq pass is done with sK and sdS
    stage<T, DH>(sK, k + kv_base, k0, BK, Lk);
    stage<T, DH>(sV, v + kv_base, k0, BK, Lk);
    __syncthreads();
    float s[NJ], dp[NJ];
    scores<DH, TPR, NJ>(sQ + r * DS, sdO + r * DS, sK, sV, tc, s, dp);
    const float l_i = sL[r], d_i = sD[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tc + TPR * j, jj = k0 + c;
      const bool ok = i < Lq && jj < Lk && (!causal || jj <= i);
      const float p = ok ? expf(s[j] * scale - l_i) : 0.f;
      sdS[r * XS + c] = p * (dp[j] - d_i);
    }
    __syncthreads();
    // dq += dS k over this tile's keys
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float ds = sdS[r * XS + c];
#pragma unroll
      for (int u = 0; u < NU; ++u)
        axpy4(acc[u], ds, load4(sK + c * DS + 4 * (tc + TPR * u)));
    }
  }
  if (i < Lq) {
#pragma unroll
    for (int u = 0; u < NU; ++u)
      store4(dq + q_base + (int64_t)i * DH + 4 * (tc + TPR * u),
             make_float4(acc[u][0] * scale, acc[u][1] * scale,
                         acc[u][2] * scale, acc[u][3] * scale));
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    lsk_flash_bwd_dkdv_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int Hq,
                              int Hkv, int Lq, int Lk, int causal,
                              float scale) {
  using C = Bwd<DH>;
  constexpr int BN = C::BN, BM = C::BM, DS = C::DS, XS = BN + 1;
  constexpr int TPR = THREADS / BM;  // S pass: threads a query row
  constexpr int NJ = BN / TPR;
  constexpr int TPK = THREADS / BN;  // dk/dv pass: threads a key row
  constexpr int NU = DH / 4 / TPK;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BN * DS;
  float* sQ = sV + BN * DS;
  float* sdO = sQ + BM * DS;
  float* sP = sdO + BM * DS;  // [BM][XS]
  float* sdS = sP + BM * XS;
  float* sL = sdS + BM * XS;
  float* sD = sL + BM;

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x;  // b * Hkv + kv head
  const int n0 = blockIdx.y * BN;  // tile 0 has the most query rows
  const int b = bkv / Hkv, hk = bkv % Hkv, g = Hq / Hkv;
  const int64_t kv_base = (int64_t)bkv * Lk * DH;

  stage<T, DH>(sK, k + kv_base, n0, BN, Lk);
  stage<T, DH>(sV, v + kv_base, n0, BN, Lk);

  const int r = tid / TPR, tc = tid % TPR;   // S pass
  const int n = tid / TPK, tc2 = tid % TPK;  // dk/dv pass
  float dk_acc[NU][4], dv_acc[NU][4];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[u][e] = dv_acc[u][e] = 0.f;

  // query rows i >= n0 are the only ones a causal key n0.. can reach
  const int m_first = causal ? (n0 / BM) * BM : 0;
  for (int hh = 0; hh < g; ++hh) {
    const int bh = b * Hq + hk * g + hh;
    const int64_t q_base = (int64_t)bh * Lq * DH;
    for (int m0 = m_first; m0 < Lq; m0 += BM) {
      __syncthreads();  // the last pass is done with sQ, sdO, sP, sdS
      stage<T, DH>(sQ, q + q_base, m0, BM, Lq);
      stage<T, DH>(sdO, dout + q_base, m0, BM, Lq);
      for (int e = tid; e < BM; e += THREADS) {
        const int i = m0 + e;
        sL[e] = i < Lq ? lse[(int64_t)bh * Lq + i] : 0.f;
        sD[e] = i < Lq ? delta[(int64_t)bh * Lq + i] : 0.f;
      }
      __syncthreads();
      float s[NJ], dp[NJ];
      scores<DH, TPR, NJ>(sQ + r * DS, sdO + r * DS, sK, sV, tc, s, dp);
      const int i = m0 + r;
      const float l_i = sL[r], d_i = sD[r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tc + TPR * j, jj = n0 + c;
        const bool ok = i < Lq && jj < Lk && (!causal || jj <= i);
        const float p = ok ? expf(s[j] * scale - l_i) : 0.f;
        sP[r * XS + c] = p;
        sdS[r * XS + c] = p * (dp[j] - d_i);
      }
      __syncthreads();
      // dv += P^T dout, dk += dS^T q over this tile's query rows
#pragma unroll 4
      for (int mm = 0; mm < BM; ++mm) {
        const float p = sP[mm * XS + n], ds = sdS[mm * XS + n];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int c = 4 * (tc2 + TPK * u);
          axpy4(dv_acc[u], p, load4(sdO + mm * DS + c));
          axpy4(dk_acc[u], ds, load4(sQ + mm * DS + c));
        }
      }
    }
  }
  const int j = n0 + n;
  if (j < Lk) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int64_t off = kv_base + (int64_t)j * DH + 4 * (tc2 + TPK * u);
      store4(dk + off, make_float4(dk_acc[u][0] * scale, dk_acc[u][1] * scale,
                                   dk_acc[u][2] * scale,
                                   dk_acc[u][3] * scale));
      store4(dv + off, make_float4(dv_acc[u][0], dv_acc[u][1], dv_acc[u][2],
                                   dv_acc[u][3]));
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
              int B, int Hq, int Hkv, int Lq, int Lk, int causal,
              cudaStream_t stream) {
  const size_t smem = Bwd<DH>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      lsk_flash_bwd_dq_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq),
                  (unsigned)((Lq + Bwd<DH>::BQ - 1) / Bwd<DH>::BQ));
  lsk_flash_bwd_dq_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, (const T*)dout,
      lse, delta, (T*)dq, Hq, Hkv, Lq, Lk, causal, scale_of<DH>());
  return (int)cudaGetLastError();
}

template <int DH, typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lk,
                int causal, cudaStream_t stream) {
  const size_t smem = Bwd<DH>::dkdv_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      lsk_flash_bwd_dkdv_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hkv),
                  (unsigned)((Lk + Bwd<DH>::BN - 1) / Bwd<DH>::BN));
  lsk_flash_bwd_dkdv_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Hq, Hkv, Lq, Lk, causal, scale_of<DH>());
  return (int)cudaGetLastError();
}

#define LSK_BWD_HEAD_DIMS(X) X(16) X(32) X(64) X(96) X(128) X(256)

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                int B, int Hq, int Hkv, int Lq, int Lk, int dh, int causal,
                cudaStream_t s) {
  switch (dh) {
#define LSK_CASE(D)                                                        \
  case D:                                                                  \
    return launch_dq<D, T>(q, k, v, out, dout, lse, delta, dq, B, Hq, Hkv, \
                           Lq, Lk, causal, s);
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
                  int dh, int causal, cudaStream_t s) {
  switch (dh) {
#define LSK_CASE(D)                                                      \
  case D:                                                                \
    return launch_dkdv<D, T>(q, k, v, dout, lse, delta, dk, dv, B, Hq,   \
                             Hkv, Lq, Lk, causal, s);
    LSK_BWD_HEAD_DIMS(LSK_CASE)
#undef LSK_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int check_args(int B, int Hq, int Hkv, int Lq, int Lk,
               std::initializer_list<const void*> ptrs) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Lq < 0 || Lk < 0 ||
      (Lq + 63) / 64 > 65535 || (Lk + 31) / 32 > 65535 || B < 0)
    return (int)cudaErrorInvalidValue;
  // the 16-byte loads and stores of f32 tiles, 8-byte of bf16
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
                                int causal, int is_bf16, void* stream) {
  if (B == 0 || Hq == 0 || Lq == 0) return 0;
  const int rc = check_args(B, Hq, Hkv, Lq, Lk, {q, k, v, out, dout, dq});
  if (rc) return rc;
  if ((uintptr_t)lse % 4 || (uintptr_t)delta % 4)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch_dq<__nv_bfloat16>(q, k, v, out, dout,
                                              (const float*)lse,
                                              (float*)delta, dq, B, Hq, Hkv,
                                              Lq, Lk, dh, causal, s)
                 : dispatch_dq<float>(q, k, v, out, dout, (const float*)lse,
                                      (float*)delta, dq, B, Hq, Hkv, Lq, Lk,
                                      dh, causal, s);
}

extern "C" int lsk_flash_bwd_dkdv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Hq, int Hkv,
                                  int Lq, int Lk, int dh, int causal,
                                  int is_bf16, void* stream) {
  if (B == 0 || Hkv == 0 || Lk == 0) return 0;
  const int rc = check_args(B, Hq, Hkv, Lq, Lk, {q, k, v, dout, dk, dv});
  if (rc) return rc;
  if ((uintptr_t)lse % 4 || (uintptr_t)delta % 4)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16
             ? dispatch_dkdv<__nv_bfloat16>(q, k, v, dout, (const float*)lse,
                                            (const float*)delta, dk, dv, B,
                                            Hq, Hkv, Lq, Lk, dh, causal, s)
             : dispatch_dkdv<float>(q, k, v, dout, (const float*)lse,
                                    (const float*)delta, dk, dv, B, Hq, Hkv,
                                    Lq, Lk, dh, causal, s);
}
