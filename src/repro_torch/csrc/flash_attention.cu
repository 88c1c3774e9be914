// Causal GQA attention by online softmax (flash attention) for the LM
// substrate: out[b,h,i] = sum_j softmax_j(scale q[b,h,i] . k[b,h/g,j])
// v[b,h/g,j], g = Hq / Hkv, scale = 1/sqrt(dh) applied to q before the dot.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// flash_attention_kernel (body _flash_body) and computes what that body
// computes: the causal mask on absolute positions with its top-left rule
// i >= j (masked scores -1e30), a running max m, sum l and dh-wide
// accumulator per row in f32, the result acc / max(l, 1e-30) cast to the
// input type; bf16 inputs are widened on load. Ragged lengths are masked
// here (keys j >= Lk score -1e30, rows i >= Lq are not stored), so the
// wrapper pads nothing.
//
// Design (simple and exact first; plain f32 FMAs, no tensor cores — TF32
// would not hold the tolerance the model is checked to):
//   - one block of 256 threads per (query head of one batch row, 64-row
//     query tile); the tiles of one head run heaviest-first, so the long
//     causal rows start early;
//   - the scaled Q tile, one 64-row K tile and one 64-row V tile and the
//     64 x 64 score tile live in dynamic shared memory (~115 KB at dh=128,
//     above the 48 KB default: cudaFuncSetAttribute each launch);
//   - each thread computes a 4 x 4 block of scores (rows 4*ty.., columns
//     tx + 16*j) and owns a 4 x dh/16 block of the accumulator in
//     registers; each warp runs the online-softmax update of 8 rows with
//     shuffles; K rows are padded by one float so the 16 column threads
//     hit 16 banks;
//   - GQA reads KV head h / g in place (no repeat copy);
//   - causal KV tiles wholly above the diagonal are not visited: such a
//     tile would leave m unchanged, give alpha = 1 and add p = 0, so
//     skipping it is exact.
//
// Bound: operations. A causal call needs 4 dh flops per kept (i, j) pair,
// B Hq dh L(L+1)/2 * 4 ~ 5.5e11 at Qwen3-8B's 8,192 tokens (8.2 ms at the
// card's 67 TFLOP/s f32 without tensor cores), against 0.34 GB of q, k, v
// and out (0.1 ms at 3.35 TB/s). This first design is held by shared-
// memory traffic (about one shared load per two FMAs) rather than by the
// FMA rate; wgmma/TMA tiles are the later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key rows per tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float lsk_ld(const float* p) { return *p; }
__device__ __forceinline__ float lsk_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void lsk_st(float* p, float x) { *p = x; }
__device__ __forceinline__ void lsk_st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DH>
struct Layout {  // shared-memory layout, in floats
  static constexpr int QS = DH + 4;  // Q row stride: rows 4 apart, 16 banks apart
  static constexpr int KS = DH + 1;  // K row stride: 16 column threads, 16 banks
  static constexpr int SS = BK + 1;  // score row stride
  static constexpr int Q = BQ * QS;
  static constexpr int K = BK * KS;
  static constexpr int V = BK * DH;
  static constexpr int S = BQ * SS;
  static constexpr size_t bytes =
      (size_t)(Q + K + V + S + 3 * BQ) * sizeof(float);
};

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
    lsk_flash_attention_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ out,
                               int Hq, int Hkv, int Lq, int Lk, int causal,
                               float scale) {
  using L = Layout<DH>;
  constexpr int NC = DH / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + L::Q;
  float* sV = sK + L::K;
  float* sS = sV + L::V;
  float* sM = sS + L::S;  // running max per row
  float* sL = sM + BQ;    // running sum per row
  float* sA = sL + BQ;    // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * Hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = bh / Hq, h = bh % Hq;
  const int group = Hq / Hkv;
  const int64_t q_base = (int64_t)bh * Lq * DH;
  const int64_t kv_base = ((int64_t)b * Hkv + h / group) * Lk * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, c = e % DH, i = q0 + r;
    sQ[r * L::QS + c] =
        i < Lq ? lsk_ld(q + q_base + (int64_t)i * DH + c) * scale : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int q_last = min(q0 + BQ, Lq) - 1;
  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q_last / BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Q is staged; the last tile's readers are done
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int r = e / DH, c = e % DH, j = k0 + r;
      const bool ok = j < Lk;
      const int64_t off = kv_base + (int64_t)j * DH + c;
      sK[r * L::KS + c] = ok ? lsk_ld(k + off) : 0.f;
      sV[e] = ok ? lsk_ld(v + off) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(4 * ty + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tx + 16 * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, c = tx + 16 * j;
        const int qi = q0 + r, kj = k0 + c;
        const bool keep = kj < Lk && (!causal || qi >= kj);
        sS[r * L::SS + c] = keep ? s[i][j] : NEG_INF;
      }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w + 7
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float x0 = sS[r * L::SS + lane], x1 = sS[r * L::SS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[r];
      const float m_cur = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_cur), p1 = expf(x1 - m_cur);
      sS[r * L::SS + lane] = p0;
      sS[r * L::SS + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_cur;
        sA[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[4 * ty + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(4 * ty + i) * L::SS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[kk * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, qi = q0 + r;
    if (qi >= Lq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* o = out + q_base + (int64_t)qi * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) lsk_st(o + tx + 16 * c, acc[i][c] / l);
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Lq, int Lk, int causal, cudaStream_t stream) {
  const size_t smem = Layout<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      lsk_flash_attention_kernel<DH, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Lq + BQ - 1) / BQ));
  // the JAX kernel's scale: 1.0 / (dh ** 0.5) in double, then to f32
  const float scale = (float)(1.0 / sqrt((double)DH));
  lsk_flash_attention_kernel<DH, T><<<grid, THREADS, smem, stream>>>(
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
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Lq, Lk,
                                           dh, causal, s)
                 : dispatch<float>(q, k, v, out, B, Hq, Hkv, Lq, Lk, dh,
                                   causal, s);
}
