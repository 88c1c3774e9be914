// Vertex-aggregate row (or column) scan on window-reduced planes, one
// block per (query, shard).
//
// Replaces the TPU kernel repro/kernels/vertex_scan/kernel.py
// vertex_scan_kernel_sharded (body _scan_body). For each of the query's r
// candidate lines the block reads d cells x 2 twins, decodes each
// occupied key's (index, fingerprint) of the line-owning side and sums cw
// (and pw[le]) over the cells that match (i, f). Sums are exact: uint32
// accumulation is addition mod 2^32, the int32 wrap of the reference, in
// any order. "out" reads rows (coalesced); "in" reads columns natively
// (stride d, uncoalesced) and decodes the destination fields (ib, fb) —
// no transposed, re-packed copy of the planes. Decoding uses floor
// division and modulo (jnp semantics) and runs only after the EMPTY mask.
//
// Bound: bytes — the 2 x d keys of each distinct line a batch scans (a
// query has r lines inside its label block, so queries share lines; each
// query's CUDA block re-reads its own), plus cw/pw on the matching cells.
#include "common.cuh"

#define LSK_IDX_RADIX 16

template <bool IN>
__global__ void lsk_vertex_scan_kernel(
    const int* __restrict__ lines,  // [nq, r]
    const int* __restrict__ f,      // [nq]
    const int* __restrict__ le,     // [nq] or null
    const int* __restrict__ key_plane, const int* __restrict__ cw,  // [S,2,d,d]
    const int* __restrict__ pw,                                     // [S,2,d,d,c]
    int* __restrict__ w_out, int* __restrict__ wl_out,              // [S, nq]
    int nq, int r, int d, int c, int F) {
  const int q = blockIdx.x, sh = blockIdx.y;
  const int fq = f[q];
  const int lq = le != nullptr ? le[q] : 0;
  unsigned acc_w = 0u, acc_wl = 0u;
  for (int i = 0; i < r; ++i) {
    const int line = lines[(int64_t)q * r + i];
    for (int tz = 0; tz < 2; ++tz) {
      const int64_t plane = ((int64_t)sh * 2 + tz) * d * d;
      for (int j = threadIdx.x; j < d; j += blockDim.x) {
        const int64_t cell = IN ? plane + (int64_t)j * d + line
                                : plane + (int64_t)line * d + j;
        const int kv = key_plane[cell];
        if (kv == LSK_EMPTY) continue;
        const int rest = lsk_floordiv(kv, F);
        const int idx = lsk_floordiv(rest, F);
        bool match;
        if (IN) {
          match = lsk_floormod(idx, LSK_IDX_RADIX) == i &&
                  lsk_floormod(kv, F) == fq;
        } else {
          match = lsk_floordiv(idx, LSK_IDX_RADIX) == i &&
                  lsk_floormod(rest, F) == fq;
        }
        if (match) {
          acc_w += (unsigned)cw[cell];
          if (le != nullptr) acc_wl += (unsigned)pw[cell * c + lq];
        }
      }
    }
  }
  // block reduction: warp shuffles, then one partial per warp
  __shared__ unsigned red_w[32], red_wl[32];
  for (int o = 16; o > 0; o >>= 1) {
    acc_w += __shfl_down_sync(0xffffffffu, acc_w, o);
    acc_wl += __shfl_down_sync(0xffffffffu, acc_wl, o);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    red_w[wid] = acc_w;
    red_wl[wid] = acc_wl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned tw = 0u, twl = 0u;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
      tw += red_w[k];
      twl += red_wl[k];
    }
    w_out[(int64_t)sh * nq + q] = (int)tw;
    wl_out[(int64_t)sh * nq + q] = (int)twl;
  }
}

extern "C" int lsk_vertex_scan(const int* lines, const int* f, const int* le,
                               const int* key_plane, const int* cw,
                               const int* pw, int* w_out, int* wl_out, int S,
                               int nq, int r, int d, int c, int F,
                               int direction_in, void* stream) {
  if ((long long)S * nq == 0) return 0;
  const dim3 grid(nq, S);
  const int threads = 256;
  if (direction_in)
    lsk_vertex_scan_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
        lines, f, le, key_plane, cw, pw, w_out, wl_out, nq, r, d, c, F);
  else
    lsk_vertex_scan_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
        lines, f, le, key_plane, cw, pw, w_out, wl_out, nq, r, d, c, F);
  return (int)cudaGetLastError();
}
