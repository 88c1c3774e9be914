// Cell-owner decode of window-reduced key planes: for every cell of
// key_plane [S, 2, d, d], the packed vertex ids of the source (row side)
// and destination (column side) that own it; EMPTY where unoccupied.
//
// Replaces the TPU kernel repro/kernels/heavy_hitters/kernel.py
// cell_decode_kernel_sharded (body _decode_body, with _chain_select,
// _block_lookup and _decode_side). One CUDA block per (shard, twin, row)
// line; its threads stride over the d columns, so a warp reads and writes
// 128 contiguous bytes. Per occupied cell and side: unpack (idx, f) with
// floor // and % (C's / and % truncate), replay the r-step LCG chain
// x = (1103515245 x + 12345) & 0x7FFFFFFF from f in uint32 (unsigned
// multiply wraps like the reference's uint32) and latch entry idx, find
// the line's block as searchsorted(starts, line, right) - 1 (a negative
// block indexes from the end, as a negative index does in the plain
// version), then s = floor_mod(line - start - sel, width) with the
// difference wrapped in 32 bits, and vid = (block * 2048 + s) * F + f with
// int32 wrap. The block table (2 * nb ints) is staged in shared memory.
//
// Bound: bytes — one read of the key plane and one write of each output,
// 12 bytes a cell. The chain is ~r dependent integer steps a side, far
// under the card's integer rate.
#include "common.cuh"

#define LSK_IDX_RADIX 16
#define LSK_LCG_T 1103515245u
#define LSK_LCG_I 12345u
#define LSK_M_MASK 0x7FFFFFFFu

__device__ __forceinline__ int lsk_decode_side(int line, int idx, int f,
                                               const int* s_start,
                                               const int* s_width, int nb,
                                               int r, int F) {
  int m = -1;
  for (int b = 0; b < nb; ++b) m += (s_start[b] <= line);
  const int mi = m < 0 ? m + nb : m;
  unsigned x = (LSK_LCG_T * (unsigned)f + LSK_LCG_I) & LSK_M_MASK;
  unsigned sel = 0u;
  for (int i = 0; i < r; ++i) {  // run to r, latch at idx: uniform warps
    sel = (i == idx) ? x : sel;
    x = (LSK_LCG_T * x + LSK_LCG_I) & LSK_M_MASK;
  }
  const int diff = (int)((unsigned)line - (unsigned)s_start[mi] - sel);
  const int s = lsk_floormod(diff, s_width[mi]);
  return (int)(((unsigned)m * 2048u + (unsigned)s) * (unsigned)F +
               (unsigned)f);
}

__global__ void lsk_cell_decode_kernel(
    const int* __restrict__ key_plane,  // [S, 2, d, d]
    const int* __restrict__ starts, const int* __restrict__ widths,  // [nb]
    int* __restrict__ vid_src, int* __restrict__ vid_dst,  // [S, 2, d, d]
    int d, int nb, int r, int F) {
  extern __shared__ int s_blk[];  // starts [nb], then widths [nb]
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    s_blk[b] = starts[b];
    s_blk[nb + b] = widths[b];
  }
  __syncthreads();
  const int row = (int)(blockIdx.x % (unsigned)d);
  const int64_t base = (int64_t)blockIdx.x * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    const int64_t cell = base + col;
    const int kv = key_plane[cell];
    if (kv == LSK_EMPTY) {
      vid_src[cell] = LSK_EMPTY;
      vid_dst[cell] = LSK_EMPTY;
      continue;
    }
    const int fb = lsk_floormod(kv, F);
    const int rest = lsk_floordiv(kv, F);
    const int fa = lsk_floormod(rest, F);
    const int idx = lsk_floordiv(rest, F);
    const int ia = lsk_floordiv(idx, LSK_IDX_RADIX);
    const int ib = lsk_floormod(idx, LSK_IDX_RADIX);
    vid_src[cell] = lsk_decode_side(row, ia, fa, s_blk, s_blk + nb, nb, r, F);
    vid_dst[cell] = lsk_decode_side(col, ib, fb, s_blk, s_blk + nb, nb, r, F);
  }
}

extern "C" int lsk_cell_decode(const int* key_plane, const int* starts,
                               const int* widths, int* vid_src, int* vid_dst,
                               int S, int d, int nb, int r, int F,
                               void* stream) {
  const long long n_lines = (long long)S * 2 * d;
  if (n_lines == 0) return 0;
  const int threads = d < 256 ? ((d + 31) / 32) * 32 : 256;
  const size_t smem = 2 * (size_t)nb * sizeof(int);
  lsk_cell_decode_kernel<<<(unsigned)n_lines, threads, smem,
                           (cudaStream_t)stream>>>(
      key_plane, starts, widths, vid_src, vid_dst, d, nb, r, F);
  return (int)cudaGetLastError();
}
