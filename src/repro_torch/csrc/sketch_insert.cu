// Block-binned first-fit LSketch insert as a gathered walk: three launches.
//
// Replaces the TPU kernel repro/kernels/sketch_insert/kernel.py:324
// sketch_insert_kernel_sharded (body _insert_body). Same result bit for
// bit: per edge, in stream order within its (shard, row-block, col-block)
// bin, the s probes x 2 twins are tested in probe-major, twin-minor order;
// the first cell whose key matches or is EMPTY wins (only for w > 0):
// set the key, add w to C[.., slot] and to P[.., slot, le]. Edges with no
// winner keep inserted == 0 and go to the pool pass.
//
// Why the walk can be split. All s probes of an edge lie in one b-tile, so
// bins own disjoint cells. During a flush a cell changes at most once,
// from EMPTY to a key; a cell that was not EMPTY before the flush never
// changes. C and P are write-only int32 adds, which commute. So a
// candidate's current value is its pre-flush value, unless that was EMPTY
// and an earlier edge of the same bin claimed the cell. Only the choice of
// the landing cell is sequential (as in sketch_insert_stream_walk).
//
//   (a) lsk_insert_gather, a thread per (candidate, sorted position): finds
//       the position's bin (binary search over the shard's bin offsets),
//       and for a walked edge writes the candidate's pre-flush key value,
//       cell id and probe key, and the edge's weight, candidate-major
//       ([2s, S*B]): bins are contiguous in sorted order, so 32 edges of a
//       bin are 32 consecutive ints of each candidate row. All loads are
//       independent.
//   (b) lsk_insert_walk, one warp (one block) per (shard, bin). 32 edges'
//       inputs at a time are staged in shared memory by cp.async,
//       double-buffered (the next chunk is in flight while this one is
//       walked). A chunk is walked in speculative rounds: lane j decides
//       edge j from the state at the round's start, testing its
//       candidates in paper order; a candidate that was EMPTY before the
//       flush is looked up in the bin's claim table (open addressing in
//       shared memory, cell -> key). An edge's decision can only be
//       changed by an earlier edge claiming the cell it claims (cells
//       only go from EMPTY to a key), so __match_any_sync over the claimed
//       cells finds the first lane with an earlier same-cell claimer; the
//       lanes before it commit (claims into the table, by atomicCAS from
//       where their lookup ended; the landing candidate to `land`), and
//       the next round starts at it. The first active lane always
//       commits, so a chunk takes 1 to 32 rounds; each round is a few
//       shared-memory steps per lane. No global load is on the chain.
//   (c) lsk_insert_counters, a thread per sorted position: for a landed
//       edge, stores the key (the same value again for a match), adds w to
//       C and P with int32 atomics (exact; edges of one bin share cells)
//       and sets inserted.
//
// The claim table holds T / 2 claims (T from the wrapper: the smallest
// power of two >= 2 x the flush's largest walked bin fill, at most 2^14).
// A bin's claims past T / 2 (in stream order) are stored to the key plane
// instead, and once there are any, a lookup that misses the table reads
// the key plane through L2 (volatile; the stores are the same warp's,
// ordered by __syncwarp). That path is exact too. At the paper deployment
// (b = 512) the labels skew the bins: the largest of a 65,536-edge flush
// holds ~5,800 edges (the mean ~980), T = 2^14 holds 8,192 claims, and the
// key plane is never read on the chain.
//
// Bound: the rounds of the longest bin (its length / 32 when no two edges
// of a chunk claim one cell; each repeat of a new edge in a chunk adds a
// round), and the gather's 2s random 4-byte reads an edge. The (2, b, b)
// key tile is not staged: at b = 512 it is 2 MiB against 227 KB of shared
// memory a block, and the gather reads only the cells the edges probe.
#include "common.cuh"

#define LSK_WALK_CHUNK 32

// upper bound on the per-edge candidate count staged by the walk
#define LSK_MAX_CAND 64

__device__ __forceinline__ unsigned lsk_hash_cell(int cell, int log2t) {
  return ((unsigned)cell * 2654435761u) >> (32 - log2t);
}

__device__ __forceinline__ void lsk_cp_async4(int* smem, const int* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(gmem));
}

// one thread per (candidate, sorted position)
__global__ void lsk_insert_gather(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const int* __restrict__ keys, const int* __restrict__ w,
    const int* __restrict__ order, const int* __restrict__ offs,
    const int* __restrict__ counts, const int* __restrict__ key,
    int* __restrict__ g_pre, int* __restrict__ g_cell,
    int* __restrict__ g_key, int* __restrict__ g_w, int* __restrict__ land,
    int S, int B, int s, int d, int nb2, int max_bin) {
  const long long SB = (long long)S * B;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= SB * 2 * s) return;
  const int q = (int)(i / SB);
  const long long p = i - q * SB;
  const int sh = (int)(p / B);
  const int pl = (int)(p - (long long)sh * B);
  if (q == 0) land[p] = -1;
  // the last bin whose offset is <= pl: among bins with equal offsets
  // (empty ones) that is the one that holds pl, if any does
  const int* o = offs + (long long)sh * nb2;
  int lo = 0, hi = nb2 - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (o[mid] <= pl) lo = mid; else hi = mid - 1;
  }
  const int t = pl - o[lo];
  if (t < 0 || t >= min(counts[(long long)sh * nb2 + lo], max_bin)) {
    if (q == 0) g_w[p] = 0;  // not walked
    return;
  }
  const long long e = (long long)sh * B + order[p];
  if (q == 0) g_w[p] = w[e];
  const int pi = q >> 1;
  const int cell = (rows[e * s + pi] * d + cols[e * s + pi]) * 2 + (q & 1);
  g_cell[i] = cell;
  g_key[i] = keys[e * s + pi];
  g_pre[i] = key[(long long)sh * d * d * 2 + cell];
}

__global__ void lsk_insert_walk(
    const int* __restrict__ offs, const int* __restrict__ counts,
    const int* __restrict__ g_pre, const int* __restrict__ g_cell,
    const int* __restrict__ g_key, const int* __restrict__ g_w, int* land,
    int* key, int S, int B, int s, int d, int nb2, int max_bin, int log2t) {
  extern __shared__ int smem[];
  const int T = 1 << log2t;
  const int ncand = 2 * s;
  const int stage = 3 * ncand * LSK_WALK_CHUNK + LSK_WALK_CHUNK;
  int* tab_cell = smem;         // [T], -1 = free
  int* tab_key = tab_cell + T;  // [T]
  int* stg = tab_key + T;       // two staging buffers of `stage` ints:
  // pre [ncand][CHUNK], cell [ncand][CHUNK], key [ncand][CHUNK], w [CHUNK]

  const long long SB = (long long)S * B;
  const int bin = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned lt = (1u << lane) - 1u;  // the lanes before this one
  const int sh = bin / nb2;
  const int n = min(counts[bin], max_bin);
  const long long base = (long long)sh * B + offs[bin];
  volatile int* vkey = key + (long long)sh * d * d * 2;
  for (int i = lane; i < T; i += 32) tab_cell[i] = -1;
  const int cap = T >> 1;  // claims the table holds
  int n_claims = 0;        // uniform across the warp

  // stage chunk c0's inputs into buffer buf by cp.async (off the chain)
  auto issue = [&](int c0, int buf) {
    int* st = stg + buf * stage;
    if (lane < min(LSK_WALK_CHUNK, n - c0)) {
      const long long p = base + c0 + lane;
      for (int q = 0; q < ncand; ++q) {
        const int o = q * LSK_WALK_CHUNK + lane;
        lsk_cp_async4(st + o, g_pre + q * SB + p);
        lsk_cp_async4(st + ncand * LSK_WALK_CHUNK + o, g_cell + q * SB + p);
        lsk_cp_async4(st + 2 * ncand * LSK_WALK_CHUNK + o,
                      g_key + q * SB + p);
      }
      lsk_cp_async4(st + 3 * ncand * LSK_WALK_CHUNK + lane, g_w + p);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (n > 0) issue(0, 0);
  for (int c0 = 0, buf = 0; c0 < n; c0 += LSK_WALK_CHUNK, buf ^= 1) {
    if (c0 + LSK_WALK_CHUNK < n) {
      issue(c0 + LSK_WALK_CHUNK, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp();  // every lane's copies of this chunk (and the table init)
    const int m = min(LSK_WALK_CHUNK, n - c0);
    const int* st_pre = stg + buf * stage;
    const int* st_cell = st_pre + ncand * LSK_WALK_CHUNK;
    const int* st_key = st_cell + ncand * LSK_WALK_CHUNK;
    const int* st_w = st_key + ncand * LSK_WALK_CHUNK;
    const bool live = lane < m && st_w[lane] > 0;
    for (int start = 0; start < m;) {
      // lane j decides edge j from the state at the round's start
      int wq = -1, wcell = 0, wkey = 0;
      bool claim = false;
      unsigned hfree = 0;  // where a missed lookup ended: a free slot then
      if (live && lane >= start) {
        for (int q = 0; q < ncand; ++q) {
          const int o = q * LSK_WALK_CHUNK + lane;
          const int cell = st_cell[o], kk = st_key[o];
          int cur = st_pre[o];
          bool cl = false;
          unsigned hf = 0;
          if (cur == LSK_EMPTY) {
            unsigned h = lsk_hash_cell(cell, log2t);
            while (true) {
              const int tc = tab_cell[h];
              if (tc == cell) { cur = tab_key[h]; break; }
              if (tc == -1) {
                hf = h;
                if (n_claims > cap) cur = vkey[cell];  // past the table
                break;
              }
              h = (h + 1) & (T - 1);
            }
            cl = cur == LSK_EMPTY;
          }
          if (cl || cur == kk) {
            wq = q, wcell = cell, wkey = kk, claim = cl, hfree = hf;
            break;
          }
        }
      }
      // an earlier lane claiming the same cell voids this lane's decision
      const unsigned same = __match_any_sync(0xffffffffu,
                                             claim ? wcell : -2 - lane);
      const unsigned bad = __ballot_sync(0xffffffffu, claim && (same & lt));
      const int end = bad ? __ffs(bad) - 1 : m;
      const bool commit = live && lane >= start && lane < end && wq >= 0;
      const unsigned claims = __ballot_sync(0xffffffffu, commit && claim);
      if (commit) {
        land[base + c0 + lane] = wq;
        if (claim) {
          if (n_claims + __popc(claims & lt) < cap) {
            unsigned h = hfree;
            while (atomicCAS(tab_cell + h, -1, wcell) != -1)
              h = (h + 1) & (T - 1);
            tab_key[h] = wkey;
          } else {
            vkey[wcell] = wkey;  // the table is full: the key plane holds it
          }
        }
      }
      n_claims += __popc(claims);  // > cap: misses read the key plane
      start = end;
      __syncwarp();  // the next round's lookups see this round's claims
    }
  }
}

__global__ void lsk_insert_counters(
    const int* __restrict__ order, const int* __restrict__ le,
    const int* __restrict__ slot, const int* __restrict__ g_cell,
    const int* __restrict__ g_key, const int* __restrict__ g_w,
    const int* __restrict__ land, int* key, int* C, int* P, int* inserted,
    int S, int B, int d, int k, int c) {
  const long long SB = (long long)S * B;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= SB) return;
  const int q = land[p];
  if (q < 0) return;
  const int sh = (int)(p / B);
  const long long e = (long long)sh * B + order[p];
  const long long cell = (long long)sh * d * d * 2 + g_cell[q * SB + p];
  const int wi = g_w[p];
  key[cell] = g_key[q * SB + p];
  const long long ci = cell * k + slot[sh];
  atomicAdd(C + ci, wi);
  atomicAdd(P + ci * c + le[e], wi);
  inserted[e] = 1;
}

extern "C" int lsk_sketch_insert(
    const int* rows, const int* cols, const int* keys, const int* w,
    const int* le, const int* slot, const int* order, const int* offs,
    const int* counts, int* key, int* C, int* P, int* inserted, int* g_pre,
    int* g_cell, int* g_key, int* g_w, int* land, int S, int B, int s, int d,
    int nb2, int k, int c, int max_bin, int log2t, void* stream) {
  const long long n_pos = (long long)S * B;
  if (n_pos == 0 || nb2 == 0) return 0;
  if (2 * s > LSK_MAX_CAND || log2t < 1 || log2t > 14)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const int blocks = (int)((n_pos + threads - 1) / threads);
  const int g_blocks = (int)((n_pos * 2 * s + threads - 1) / threads);
  lsk_insert_gather<<<g_blocks, threads, 0, st>>>(
      rows, cols, keys, w, order, offs, counts, key, g_pre, g_cell, g_key,
      g_w, land, S, B, s, d, nb2, max_bin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ((size_t)(2 << log2t) +
                       2 * (size_t)(3 * LSK_WALK_CHUNK * 2 * s +
                                    LSK_WALK_CHUNK)) * sizeof(int);
  err = cudaFuncSetAttribute(lsk_insert_walk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  lsk_insert_walk<<<S * nb2, 32, smem, st>>>(
      offs, counts, g_pre, g_cell, g_key, g_w, land, key, S, B, s, d, nb2,
      max_bin, log2t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lsk_insert_counters<<<blocks, threads, 0, st>>>(
      order, le, slot, g_cell, g_key, g_w, land, key, C, P, inserted, S, B,
      d, k, c);
  return (int)cudaGetLastError();
}
