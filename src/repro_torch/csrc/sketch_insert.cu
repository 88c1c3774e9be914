// Block-binned first-fit LSketch insert, one warp per (shard, bin).
//
// Replaces the TPU kernel repro/kernels/sketch_insert/kernel.py
// sketch_insert_kernel_sharded (body _insert_body). Same result bit for
// bit: per edge, in stream order within its (shard, row-block, col-block)
// bin, the s probes x 2 twins are tested in probe-major, twin-minor order;
// the first cell whose key matches or is EMPTY wins (only for w > 0):
// set the key, add w to C[.., slot] and to P[.., slot, le]. Edges with no
// winner keep inserted == 0 and go to the pool pass.
//
// Design: the bins are read straight from the bin-sorted stream (order,
// offs, counts) — no padded [n^2, max_bin] bins. The 32 lanes test up to
// 32 candidates at once; __ballot_sync + __ffs picks the first winner in
// paper order, looping over lane groups when 2s > 32. All s probes of an
// edge fall in one tile, so every cell belongs to exactly one bin: the
// winning lane writes key/C/P in the state layout with plain stores, no
// atomics, and no current-slot plane gather or write-back.
//
// Bound: latency. Each edge is a chain of dependent global loads (order ->
// probe coordinates -> key cells) followed by a store the next edge must
// see, so a bin's walk is sequential; the bytes moved are small. Later
// work: stage the (2, b, b) key tile in shared memory where it fits.
#include "common.cuh"

__global__ void lsk_insert_binned_kernel(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const int* __restrict__ keys,  // [S, B, s] absolute coords, stream order
    const int* __restrict__ w, const int* __restrict__ le,  // [S, B]
    const int* __restrict__ slot,                           // [S]
    const int* __restrict__ order,                          // [S, B]
    const int* __restrict__ offs, const int* __restrict__ counts,  // [S, nb2]
    int* key, int* C, int* P,  // [S,d,d,2], [S,d,d,2,k], [S,d,d,2,k,c]
    int* inserted,             // [S, B], zeroed by the caller
    int S, int B, int s, int d, int nb2, int k, int c, int max_bin) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= S * nb2) return;  // uniform for the whole warp
  const int sh = warp / nb2;
  const int n = min(counts[warp], max_bin);
  const int base = offs[warp];
  const int64_t sB = (int64_t)sh * B;
  const int sl = slot[sh];
  const int ncand = 2 * s;
  volatile int* vkey = key;

  for (int t = 0; t < n; ++t) {
    const int64_t e = sB + order[sB + base + t];
    const int wi = w[e];
    int winner = -1;
    int r = 0, cc = 0, kk = 0;
    for (int g = 0; g < ncand; g += 32) {
      const int q = g + lane;
      bool ok = false;
      if (q < ncand) {
        const int pi = q >> 1, tz = q & 1;
        r = rows[e * s + pi];
        cc = cols[e * s + pi];
        kk = keys[e * s + pi];
        const int cur = vkey[(((int64_t)sh * d + r) * d + cc) * 2 + tz];
        ok = (cur == kk) || (cur == LSK_EMPTY);
      }
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (m) {
        winner = g + __ffs(m) - 1;
        break;
      }
    }
    if (winner >= 0 && wi > 0 && lane == (winner & 31)) {
      const int64_t cell = (((int64_t)sh * d + r) * d + cc) * 2 + (winner & 1);
      vkey[cell] = kk;
      const int64_t ci = cell * k + sl;
      C[ci] += wi;
      P[ci * c + le[e]] += wi;
      inserted[e] = 1;
    }
    __syncwarp();  // the next edge's lanes must see this edge's key write
  }
}

extern "C" int lsk_sketch_insert(
    const int* rows, const int* cols, const int* keys, const int* w,
    const int* le, const int* slot, const int* order, const int* offs,
    const int* counts, int* key, int* C, int* P, int* inserted, int S, int B,
    int s, int d, int nb2, int k, int c, int max_bin, void* stream) {
  const int threads = 128;
  const long long n_threads = (long long)S * nb2 * 32;
  if (n_threads == 0) return 0;
  const int blocks = (int)((n_threads + threads - 1) / threads);
  lsk_insert_binned_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      rows, cols, keys, w, le, slot, order, offs, counts, key, C, P, inserted,
      S, B, s, d, nb2, k, c, max_bin);
  return (int)cudaGetLastError();
}
