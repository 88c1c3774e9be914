// Edge-weight probe walk on window-reduced planes, one thread per
// (shard, query).
//
// Replaces the TPU kernel repro/kernels/sketch_query/kernel.py
// sketch_query_kernel_sharded (body _query_body). Per query the s x 2
// candidates are walked in probe-major, twin-minor order; the first key
// match returns cw and pw[le], the first EMPTY proves the edge absent, and
// a walk that finds neither sets go_pool (resolved by the wrapper's pool
// lookup). pw is read only on a match. No padding of the query batch.
//
// Bound: bytes, at best; in practice the latency of a few scattered loads
// per thread (the planes are gathered from L2/HBM, not staged: at d=2048
// one shard's key plane alone is 32 MiB).
#include "common.cuh"

__global__ void lsk_query_kernel(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const int* __restrict__ keys,  // [nq, s]
    const int* __restrict__ le,    // [nq] or null (no edge label)
    const int* __restrict__ key_plane, const int* __restrict__ cw,  // [S,2,d,d]
    const int* __restrict__ pw,                                     // [S,2,d,d,c]
    int* __restrict__ w_out, int* __restrict__ wl_out,
    int* __restrict__ go_pool,  // [S, nq]
    int S, int nq, int s, int d, int c) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)S * nq) return;
  const int sh = (int)(tid / nq);
  const int64_t q = tid - (int64_t)sh * nq;
  int w = 0, wl = 0;
  bool done = false;
  for (int pi = 0; pi < s && !done; ++pi) {
    const int r = rows[q * s + pi], cc = cols[q * s + pi];
    const int kk = keys[q * s + pi];
    for (int tz = 0; tz < 2; ++tz) {
      const int64_t cell = (((int64_t)sh * 2 + tz) * d + r) * d + cc;
      const int cur = key_plane[cell];
      if (cur == kk) {
        w = cw[cell];
        if (le != nullptr) wl = pw[cell * c + le[q]];
        done = true;
        break;
      }
      if (cur == LSK_EMPTY) {
        done = true;
        break;
      }
    }
  }
  w_out[tid] = w;
  wl_out[tid] = wl;
  go_pool[tid] = done ? 0 : 1;
}

extern "C" int lsk_sketch_query(const int* rows, const int* cols,
                                const int* keys, const int* le,
                                const int* key_plane, const int* cw,
                                const int* pw, int* w_out, int* wl_out,
                                int* go_pool, int S, int nq, int s, int d,
                                int c, void* stream) {
  const long long n = (long long)S * nq;
  if (n == 0) return 0;
  const int threads = 128;
  const int blocks = (int)((n + threads - 1) / threads);
  lsk_query_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      rows, cols, keys, le, key_plane, cw, pw, w_out, wl_out, go_pool, S, nq,
      s, d, c);
  return (int)cudaGetLastError();
}
