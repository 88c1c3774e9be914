// Vertex-aggregate line scan on window-reduced planes, line-major.
//
// Replaces the TPU kernel repro/kernels/vertex_scan/kernel.py
// vertex_scan_kernel_sharded (body _scan_body): for each query's r
// candidate lines, sum cw (and pw[le]) over the cells of the line, in both
// twins, whose occupied key decodes to the query's (candidate index i,
// fingerprint f) on the line-owning side: (ia, fa) for "out" (rows),
// (ib, fb) for "in" (columns, read natively: no transposed copy of the
// planes). Decoding uses floor division and modulo (jnp semantics) after
// the EMPTY mask. Sums are uint32 additions, the int32 wrap of the
// reference, exact in any order.
//
// Bound: bytes. A batch's queries share lines (each query's r lines lie
// in its label block), so the least a batch reads is every shard's 2 x d
// keys of each distinct line once, plus cw / pw on the matching cells. A
// block per (query, shard) re-read its own r lines (~4.8x the distinct
// lines at the deployment) and read "in" columns one 4-byte word per
// 32-byte sector.
//
// Design: each reference is one (query q, candidate index i) pair,
// nq x r of them, kept as such (one query may name one line at two
// values of i, so references are never merged by (q, line)).
//   1. a counting sort groups the references by line on the card: a
//      histogram over the d lines (each reference keeps its rank in its
//      line), an exclusive scan, a scatter. No host read.
//   2. "out": one block per (line, shard); a line with no reference exits
//      at once. The block loads its line's references into shared memory
//      (below), reads the line's 2 x d keys once, coalesced, and decodes
//      each occupied cell once; cw (and pw[le]) are read only on a match.
//   3. "in": one block per (tile of 32 adjacent columns, shard); a tile
//      with no reference exits. Match keys carry the column in the tile;
//      each warp reads rows of the tile, 32 consecutive words a row: one
//      128-byte load, so the whole key plane is read once.
//   Groups (a pooled stack of tenants, repro/sketch/tenant.py): with G
//   groups the queries are G x Lq, group g's Lq in a row, and shard row sh
//   answers only its own group's, g = sh / (S / G). The sort keys each
//   reference by (group, line), so block (line, sh) reads the references
//   of its group on its line and nothing else: a pooled batch costs what
//   G separate handles' batches would, in one launch. G = 1 is the plain
//   stack.
//   Shared memory holds a chunk of a line's (or tile's) references: a
//   table of their match keys (f, i[, column]) with a dense id each, the
//   cw sum of each key and, with the edge label, its c per-label pw sums.
//   A batch repeats hub vertices (at the deployment up to 164 references
//   on one line), and duplicate queries share a key: a matching cell adds
//   its cw once and each of its pw values that is not 0 once, whatever
//   the number of duplicates. The block reads its cells in steps: while a
//   step's keys are in flight, the whole block adds the matching cells
//   the step before listed (their cw and pw loads in flight together),
//   so a hub's many matches cost no chain of dependent loads in one warp.
//   Measured on earlier shapes (NVIDIA H100 80GB HBM3, 700 W): partials
//   per reference made a matching cell cost two shared atomics per
//   duplicate (1.03 ms for "out"); adding each match in the thread that
//   found it left "in" at 0.23 ms. A line with more references than a
//   chunk walks them chunk by chunk. Each chunk ends with one global
//   uint32 atomicAdd per reference (with a non-zero sum) into
//   w[sh, q] / wl[sh, q].
#include "common.cuh"

// the packed key's index radix (16) is applied by shifts: floor
// division >> 4, floor modulo & 15
#define LSK_SCAN_CHUNK 512       // references a block matches at once
#define LSK_SCAN_OUT_CHUNK 128   // ... an "out" block
#define LSK_SCAN_TABLE_LOG2 10   // hash slots: twice the chunk
#define LSK_SCAN_TABLE (1 << LSK_SCAN_TABLE_LOG2)
#define LSK_SCAN_TILE 32         // columns of an "in" block
#define LSK_SCAN_OUT_UNROLL 8    // key loads in flight per thread: "out"
#define LSK_SCAN_IN_UNROLL 8     // and "in"
#define LSK_SCAN_LBATCH 16       // pw loads a matching cell issues at once
#define LSK_SCAN_LSUMS 7680      // per-label sums of a chunk (30 KB)
#define LSK_SCAN_OUT_THREADS 256
#define LSK_SCAN_IN_THREADS 512

// 1a. each reference's rank in its (group, line) bin, bin g * d + line
// for query q of group g = q / Lq (a line outside [0, d) ranks -1)
__global__ void lsk_scan_hist_kernel(const int* __restrict__ lines,
                                     int n_ref, int r, int Lq, int d,
                                     int* cnt, int* rank) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_ref) return;
  const int line = lines[t];
  const int bin = (t / r / Lq) * d + line;
  rank[t] = (line >= 0 && line < d) ? atomicAdd(cnt + bin, 1) : -1;
}

// 1b. off[j] = references in bins before j, off[n] = all (one block of
// 1024 threads walks the n = G x d counts in steps of 1024)
__global__ void __launch_bounds__(1024)
    lsk_scan_offsets_kernel(const int* __restrict__ cnt, int d, int* off) {
  __shared__ int warp_x[32];
  __shared__ int step_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < d; base += 1024) {
    const int j = base + threadIdx.x;
    const int v = j < d ? cnt[j] : 0;
    int x = v;  // inclusive scan in the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_x[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int wv = warp_x[lane];
      int wx = wv;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, wx, o);
        if (lane >= o) wx += y;
      }
      warp_x[lane] = wx - wv;
      if (lane == 31) step_total = wx;
    }
    __syncthreads();
    if (j < d) off[j] = carry + warp_x[warp] + x - v;
    carry += step_total;
    __syncthreads();  // warp_x and step_total are rewritten next step
  }
  if (threadIdx.x == 0) off[d] = carry;
}

// 1c. the references in (group, line) order, each as one record
// (reference t = q * r + i, f[q], le[q] or 0, its line)
__global__ void lsk_scan_scatter_kernel(const int* __restrict__ lines,
                                        const int* __restrict__ f,
                                        const int* __restrict__ le,
                                        const int* __restrict__ rank,
                                        const int* __restrict__ off,
                                        int n_ref, int r, int Lq, int d,
                                        int4* sorted) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_ref || rank[t] < 0) return;
  const int q = t / r, line = lines[t];
  sorted[off[(q / Lq) * d + line] + rank[t]] =
      make_int4(t, f[q], le != nullptr ? le[q] : 0, line);
}

// A chunk of a line's (or tile's) references in shared memory: a table
// of their match keys, a dense id per distinct key with its cw sum, and
// (dynamic shared memory, with the edge label) its c per-label pw sums.
// Each reference keeps its query, key id and label.
struct LskScanChunk {
  int key[LSK_SCAN_TABLE];  // match key of a slot, -1 free
  int kid[LSK_SCAN_TABLE];  // the slot's key id
  unsigned kw[LSK_SCAN_CHUNK];
  int rq[LSK_SCAN_CHUNK];
  int rk[LSK_SCAN_CHUNK];  // -1: the reference matches no cell
  int rl[LSK_SCAN_CHUNK];
  int n_keys;
  int n_hit[2];  // matching cells listed by the last two steps
};

__device__ __forceinline__ int lsk_scan_hash(int key) {
  return (int)(((unsigned)key * 0x9E3779B1u) >> (32 - LSK_SCAN_TABLE_LOG2));
}

// floor division and modulo by F, by shifts when F is a power of two
// (fsh = log2 F, else -1)
__device__ __forceinline__ int lsk_scan_div(int a, int F, int fsh) {
  return fsh >= 0 ? a >> fsh : lsk_floordiv(a, F);
}
__device__ __forceinline__ int lsk_scan_mod(int a, int F, int fsh) {
  return fsh >= 0 ? a & (F - 1) : lsk_floormod(a, F);
}

// Loads references sorted[lo, lo + m) into the chunk and zeroes its sums
// (kwl: m x c, or null). Match key: f * r + i ("out"), (f * r + i) * TILE
// + column - col0 ("in", col0 >= 0). A query whose f lies outside [0, F)
// matches no cell.
__device__ void lsk_scan_load_chunk(LskScanChunk& ch, unsigned* kwl,
                                    const int4* __restrict__ sorted, int lo,
                                    int m, int r, int F, int c, int col0) {
  for (int s = threadIdx.x; s < LSK_SCAN_TABLE; s += blockDim.x)
    ch.key[s] = -1;
  if (kwl != nullptr)
    for (int x = threadIdx.x; x < m * c; x += blockDim.x) kwl[x] = 0u;
  if (threadIdx.x == 0) {
    ch.n_keys = 0;
    ch.n_hit[0] = ch.n_hit[1] = 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const int4 rec = sorted[lo + t];  // (reference, f, label, line)
    const int q = rec.x / r, i = rec.x - q * r;
    ch.rq[t] = q;
    ch.rl[t] = rec.z;
    ch.rk[t] = -1;
    if (rec.y < 0 || rec.y >= F) continue;
    int key = rec.y * r + i;
    if (col0 >= 0) key = key * LSK_SCAN_TILE + (rec.w - col0);
    int s = lsk_scan_hash(key);
    for (;;) {
      const int prev = atomicCAS(&ch.key[s], -1, key);
      if (prev == -1) {  // a new key: its id, its sum from 0
        const int id = atomicAdd(&ch.n_keys, 1);
        ch.kw[id] = 0u;
        ch.kid[s] = id;
        break;
      }
      if (prev == key) break;
      s = (s + 1) & (LSK_SCAN_TABLE - 1);
    }
    ch.rk[t] = s;  // a slot until every id is written
  }
  __syncthreads();
  for (int t = threadIdx.x; t < m; t += blockDim.x)
    if (ch.rk[t] >= 0) ch.rk[t] = ch.kid[ch.rk[t]];
  __syncthreads();
}

// the key id of key in the chunk, or -1
__device__ __forceinline__ int lsk_scan_find(const LskScanChunk& ch,
                                             int key) {
  int s = lsk_scan_hash(key);
  for (;;) {
    const int k = ch.key[s];
    if (k == key) return ch.kid[s];
    if (k == -1) return -1;
    s = (s + 1) & (LSK_SCAN_TABLE - 1);
  }
}

// Adds the n matching cells a step listed (hcell: offset in the shard's
// plane, hkid: key id), every thread of the block taking its share: cw to
// the key's sum and each of the cell's c pw values that is not 0 to the
// key's per-label sum. The block's threads issue their loads together.
__device__ void lsk_scan_drain(LskScanChunk& ch, unsigned* kwl,
                               const int* hcell, const int* hkid, int n,
                               const int* __restrict__ cw,
                               const int* __restrict__ pw, int c) {
  for (int h = threadIdx.x; h < n; h += blockDim.x) {
    const long long cell = hcell[h];
    const int id = hkid[h];
    const unsigned cv = (unsigned)cw[cell];
    if (kwl == nullptr) {
      if (cv != 0u) atomicAdd(&ch.kw[id], cv);
      continue;
    }
    const int* prow = pw + cell * c;
    unsigned* krow = kwl + id * c;
    for (int l0 = 0; l0 < c; l0 += LSK_SCAN_LBATCH) {
      unsigned v[LSK_SCAN_LBATCH];
      if ((c & 3) == 0 && l0 + LSK_SCAN_LBATCH <= c) {  // 16-byte loads
#pragma unroll
        for (int j = 0; j < LSK_SCAN_LBATCH; j += 4) {
          const int4 x = *(const int4*)(prow + l0 + j);
          v[j] = (unsigned)x.x;
          v[j + 1] = (unsigned)x.y;
          v[j + 2] = (unsigned)x.z;
          v[j + 3] = (unsigned)x.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < LSK_SCAN_LBATCH; ++j)
          v[j] = l0 + j < c ? (unsigned)prow[l0 + j] : 0u;
      }
      if (l0 == 0 && cv != 0u) atomicAdd(&ch.kw[id], cv);
#pragma unroll
      for (int j = 0; j < LSK_SCAN_LBATCH; ++j)
        if (v[j] != 0u) atomicAdd(&krow[l0 + j], v[j]);
    }
  }
}

// appends a warp's matching cells (id >= 0) to the step's list; every
// lane of the warp calls it
__device__ __forceinline__ void lsk_scan_append(int* count, int* hcell,
                                                int* hkid, int off, int id) {
  const unsigned hit = __ballot_sync(0xffffffffu, id >= 0);
  if (hit == 0u) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(hit));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (id >= 0) {
    const int pos = base + __popc(hit & ((1u << lane) - 1u));
    hcell[pos] = off;
    hkid[pos] = id;
  }
}

// one atomic per reference with a non-zero sum, at its query's place
// q - q0 in the block's group
__device__ void lsk_scan_flush(LskScanChunk& ch, const unsigned* kwl, int m,
                               int c, int q0, unsigned* w_out,
                               unsigned* wl_out) {
  __syncthreads();
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const int id = ch.rk[t];
    if (id < 0) continue;
    const unsigned w = ch.kw[id];
    if (w != 0u) atomicAdd(w_out + ch.rq[t] - q0, w);
    if (kwl != nullptr) {
      const unsigned wl = kwl[id * c + ch.rl[t]];
      if (wl != 0u) atomicAdd(wl_out + ch.rq[t] - q0, wl);
    }
  }
  __syncthreads();  // the chunk is reloaded next
}

// Loads the chunk sorted[lo, lo + m) and matches the cells a block reads
// against it, in steps of U per thread: each step's keys are loaded, the
// chunk's table (first step) or the previous step's matching cells are
// done while they are in flight, then the keys are decoded, matched and
// the matches listed for the next step (ping-pong counters: two barriers
// a step). IN: cell offset e * d + lane of step row e (twin
// e / d, row e % d) in the tile; else e: twin e / d, column e % d of the
// line.
template <bool IN, int U, int THREADS>
__device__ void lsk_scan_cells(LskScanChunk& ch, unsigned* kwl, int* hcell,
                               int* hkid, const int4* __restrict__ sorted,
                               int lo, int m,
                               const int* __restrict__ key_plane,
                               const int* __restrict__ cw,
                               const int* __restrict__ pw, int sh, int line,
                               int r, int d, int c, int F, int fsh) {
  const long long plane0 = (long long)sh * 2 * d * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_step = IN ? U * (THREADS / 32) : U * THREADS;
  const int steps = (2 * d + per_step - 1) / per_step;
  const int col = line + lane;  // IN: this lane's column
  for (int it = 0; it <= steps; ++it) {
    int kv[U], off[U];
    if (it < steps) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int e;
        bool ok;
        if (IN) {
          e = (it * U + u) * (THREADS / 32) + warp;
          off[u] = e * d + col;
          ok = e < 2 * d && col < d;
        } else {
          e = (it * U + u) * THREADS + threadIdx.x;
          const int tz = e >= d;
          off[u] = (tz * d + line) * d + e - tz * d;
          ok = e < 2 * d;
        }
        kv[u] = ok ? key_plane[plane0 + off[u]] : LSK_EMPTY;
      }
    }
    if (it == 0)  // the chunk's table, while the first keys are in flight
      lsk_scan_load_chunk(ch, kwl, sorted, lo, m, r, F, c, IN ? line : -1);
    else  // the previous step's matching cells
      lsk_scan_drain(ch, kwl, hcell, hkid, ch.n_hit[(it - 1) & 1],
                     cw + plane0, pw + plane0 * c, c);
    __syncthreads();  // the list is drained
    if (threadIdx.x == 0) ch.n_hit[(it + 1) & 1] = 0;
    if (it == steps) break;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int id = -1;
      if (kv[u] != LSK_EMPTY) {
        const int rest = lsk_scan_div(kv[u], F, fsh);
        const int idx = lsk_scan_div(rest, F, fsh);
        const int ci = IN ? idx & 15 : idx >> 4;  // floor mod / by RADIX
        if (ci >= 0 && ci < r) {
          const int key = IN ? (lsk_scan_mod(kv[u], F, fsh) * r + ci) *
                                       LSK_SCAN_TILE + lane
                             : lsk_scan_mod(rest, F, fsh) * r + ci;
          id = lsk_scan_find(ch, key);
        }
      }
      lsk_scan_append(&ch.n_hit[it & 1], hcell, hkid, off[u], id);
    }
    __syncthreads();  // the list is complete
  }
}

// dynamic shared memory: the per-label sums (chunk x c, with the edge
// label), then the step's list of matching cells (offsets, key ids)
template <bool IN, int U, int THREADS>
__global__ void __launch_bounds__(THREADS)
    lsk_scan_kernel(const int4* __restrict__ sorted,
                    const int* __restrict__ off,
                    const int* __restrict__ key_plane,
                    const int* __restrict__ cw, const int* __restrict__ pw,
                    unsigned* w_out, unsigned* wl_out, int Lq, int per,
                    int r, int d, int c, int F, int fsh, int with_le,
                    int chunk) {
  // "out": block (line, shard); "in": block (tile of 32 columns, shard);
  // either reads the bins of its shard's group only
  const int line = IN ? blockIdx.x * LSK_SCAN_TILE : blockIdx.x;
  const int sh = blockIdx.y;
  const int grp = sh / per;
  const int* goff = off + grp * d;
  const int lo = goff[line];
  const int n = goff[IN ? min(line + LSK_SCAN_TILE, d) : line + 1] - lo;
  if (n == 0) return;
  __shared__ LskScanChunk ch;
  extern __shared__ int4 dyn4[];
  unsigned* dyn = (unsigned*)dyn4;
  unsigned* kwl = with_le ? dyn : nullptr;
  int* hcell = (int*)dyn + (with_le ? chunk * c : 0);
  int* hkid = hcell + U * THREADS;
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int m = min(chunk, n - c0);
    lsk_scan_cells<IN, U, THREADS>(ch, kwl, hcell, hkid, sorted, lo + c0, m,
                                   key_plane, cw, pw, sh, line, r, d, c, F,
                                   fsh);
    lsk_scan_flush(ch, kwl, m, c, grp * Lq, w_out + (long long)sh * Lq,
                   wl_out + (long long)sh * Lq);
  }
}

#define LSK_SCAN_OUT LSK_SCAN_OUT_UNROLL, LSK_SCAN_OUT_THREADS
#define LSK_SCAN_IN LSK_SCAN_IN_UNROLL, LSK_SCAN_IN_THREADS
#define LSK_MAX_DEVICES 64
static bool g_scan_attr[LSK_MAX_DEVICES];  // the attribute is set once

// nq = G x Lq queries, group g's Lq in a row; w_out, wl_out [S, Lq].
// scratch: sorted [nq * r] int4 records, then cnt [G d], off [G d + 1]
// and rank [nq * r] ints
extern "C" int lsk_vertex_scan(const int* lines, const int* f, const int* le,
                               const int* key_plane, const int* cw,
                               const int* pw, int* w_out, int* wl_out,
                               int* scratch, int S, int nq, int r, int d,
                               int c, int F, int direction_in, int groups,
                               void* stream) {
  if (groups <= 0 || S % groups != 0 || nq % groups != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)S * nq == 0) return 0;
  const int Lq = nq / groups, per = S / groups;
  // references a block takes at once ("out" blocks are many and short:
  // a smaller chunk keeps their shared memory small); a chunk's per-label
  // sums fill at most LSK_SCAN_LSUMS ints
  const int most_refs = direction_in ? LSK_SCAN_CHUNK : LSK_SCAN_OUT_CHUNK;
  const int chunk =
      le != nullptr ? min(most_refs, LSK_SCAN_LSUMS / c) : most_refs;
  if (r <= 0 || d <= 0 || F <= 0 || c <= 0 || chunk <= 0 ||
      (long long)F * r * LSK_SCAN_TILE > 0x7FFFFFFFLL ||
      2LL * d * d > 0x7FFFFFFFLL || (long long)groups * d > 0x7FFFFFFFLL ||
      (long long)nq * r * 4 > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_ref = nq * r;
  int4* sorted = (int4*)scratch;
  const int bins = groups * d;
  int* cnt = scratch + 4 * n_ref;
  int* off = cnt + bins;
  int* rank = off + bins + 1;
  cudaError_t err;
  if ((err = cudaMemsetAsync(w_out, 0, sizeof(int) * (size_t)S * Lq, st)) ||
      (err = cudaMemsetAsync(wl_out, 0, sizeof(int) * (size_t)S * Lq, st)) ||
      (err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)bins, st)))
    return (int)err;
  const int g = (n_ref + 255) / 256;
  lsk_scan_hist_kernel<<<g, 256, 0, st>>>(lines, n_ref, r, Lq, d, cnt,
                                          rank);
  lsk_scan_offsets_kernel<<<1, 1024, 0, st>>>(cnt, bins, off);
  lsk_scan_scatter_kernel<<<g, 256, 0, st>>>(lines, f, le, rank, off, n_ref,
                                             r, Lq, d, sorted);
  unsigned* w = (unsigned*)w_out;
  unsigned* wl = (unsigned*)wl_out;
  const int with_le = le != nullptr;
  // F a power of two (the deployment's 1,024) decodes by shifts: four
  // integer divisions less per occupied cell
  const int fsh = (F & (F - 1)) == 0 ? __builtin_ctz((unsigned)F) : -1;
  const int hcap = direction_in ? LSK_SCAN_IN_UNROLL * LSK_SCAN_IN_THREADS
                                : LSK_SCAN_OUT_UNROLL * LSK_SCAN_OUT_THREADS;
  const size_t smem =
      sizeof(int) * ((with_le ? (size_t)chunk * c : 0) + 2 * (size_t)hcap);
  int dev = 0;
  if ((err = cudaGetDevice(&dev))) return (int)err;
  if (dev >= LSK_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_scan_attr[dev]) {  // room for the largest dynamic shared memory
    const int most = (int)sizeof(int) *
                     (LSK_SCAN_LSUMS + 2 * LSK_SCAN_IN_UNROLL *
                                           LSK_SCAN_IN_THREADS);
    const cudaFuncAttribute attr =
        cudaFuncAttributeMaxDynamicSharedMemorySize;
    if ((err = cudaFuncSetAttribute(lsk_scan_kernel<true, LSK_SCAN_IN>,
                                    attr, most)) ||
        (err = cudaFuncSetAttribute(lsk_scan_kernel<false, LSK_SCAN_OUT>,
                                    attr, most)))
      return (int)err;
    g_scan_attr[dev] = true;
  }
  if (direction_in)
    lsk_scan_kernel<true, LSK_SCAN_IN>
        <<<dim3((d + LSK_SCAN_TILE - 1) / LSK_SCAN_TILE, S),
           LSK_SCAN_IN_THREADS, smem, st>>>(sorted, off, key_plane, cw, pw, w,
                                            wl, Lq, per, r, d, c, F, fsh,
                                            with_le, chunk);
  else
    lsk_scan_kernel<false, LSK_SCAN_OUT>
        <<<dim3(d, S), LSK_SCAN_OUT_THREADS, smem, st>>>(
            sorted, off, key_plane, cw, pw, w, wl, Lq, per, r, d, c, F, fsh,
            with_le, chunk);
  return (int)cudaGetLastError();
}
