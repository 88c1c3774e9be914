// Edge-weight probe walk on window-reduced planes, one half-warp per
// (shard, query), with the query's addressing and the pool lookup in the
// same launch.
//
// Replaces the TPU kernel repro/kernels/sketch_query/kernel.py
// sketch_query_kernel_sharded (body _query_body) and, in its fused entry,
// the whole of repro/kernels/sketch_query/ops.py::edge_query_planes for a
// [H, S] plane stack (its 5-dim branch). Per query the s x 2 candidates
// are walked in probe-major, twin-minor order; the first key match
// returns cw and pw[le], the first EMPTY proves the edge absent, and a
// walk that finds neither goes to the pool, where the first probe slot
// (of pool_probes, in order, empty slots included) holding the query's
// (src, dst) identity returns pool_cw and pool_pw[le].
//
// Bound: bytes, and of those few (a query reads ~16 key words, two
// counters and its inputs). What held the thread-per-query walk back was
// latency: up to 2s + 2 dependent loads from HBM (the key plane, 134 MB
// at the deployment, does not stay in the 50 MB L2), and around it a few
// hundred launches of emulated-uint32 addressing on the host.
//
// Design:
//   * a group of 16 lanes owns a (shard, query); lane j takes candidate j
//     (probe j / 2, twin j % 2) of a chunk of 16 and loads its key cell,
//     every chunk's loads in flight together; __ballot_sync of
//     (match | EMPTY) over the group, and its lowest set bit is the stop.
//     Walks with 2s > 16 take chunks of 16 in order and stop at the first
//     chunk with a stop. Two dependent round trips: keys, then counters;
//   * the counters at the stop are read for each of H horizons (an H
//     stride over cw / pw / pool_cw / pool_pw); key and pool_key are read
//     once, so a horizon sweep walks once per (shard, query);
//   * a group with no stop probes the pool: lane j takes slot
//     (base + j) mod Q in chunks of 16 and the lowest matching lane wins,
//     as the reference's argmax over every probe;
//   * the fused entry derives each lane's candidate from (src, la, dst,
//     lb) itself, in native uint32 (addressing.cuh), and buckets the edge
//     label; no addressing tensor is made on the host.
// Two C entries share the kernel: lsk_sketch_query keeps the TPU kernel's
// contract (rows / cols / keys / label bucket in; w, wl, go_pool out; no
// pool), lsk_edge_query takes raw queries and writes w, wl [H, S, B]
// after the pool.
//
// Groups (a pooled stack of tenants, repro/sketch/tenant.py): with G
// groups the fused entry takes G x B queries, group g's B in a row, and
// shard row sh answers only the queries of its own group sh / (S / G):
// the grid stays S x B, so a pooled batch costs what G separate handles'
// batches would, in one launch. G = 1 is the plain stack.
#include "addressing.cuh"

#define LSK_QGROUP 16          // lanes per (shard, query)
#define LSK_QTHREADS 128       // threads per block: 8 groups

struct LskQueryArgs {
  // the contract entry: probe cells, keys [B, s] and label buckets [B]
  const int* rows;
  const int* cols;
  const int* keys;
  // the fused entry: raw queries [B] (le is the raw edge label there)
  const int* src;
  const int* la;
  const int* dst;
  const int* lb;
  const int* le;      // [B] or null: no edge label
  const int* blocks;  // n_blocks starts, then n_blocks widths
  // planes: key [S, 2, d, d] and pool_key [S, Q, 2] once; the counters
  // with a leading horizon axis
  const int* key;
  const int* cw;       // [H, S, 2, d, d]
  const int* pw;       // [H, S, 2, d, d, c]
  const int* pool_key;
  const int* pool_cw;  // [H, S, Q]
  const int* pool_pw;  // [H, S, Q, c]
  int* w;              // [H, S, B]
  int* wl;             // [H, S, B]
  int* go_pool;        // [S, B] (contract entry only)
  int H, S, B, s, d, c, Q, probes, n_blocks, F, r;
  int per;  // shard rows a group: queries of row sh start at (sh/per) B
  uint32_t seed;
};

// The probe walk of one (shard, query) on its group: returns the index of
// the first candidate whose cell holds the query's key or EMPTY, or -1.
// Every lane gets the stop's cell offset in the shard's [2, d, d] planes
// and whether it matched. ``cand(pi, &row, &col, &key)`` gives probe pi.
template <class Cand>
__device__ __forceinline__ int lsk_walk(const int* __restrict__ kp, int s,
                                        int d, int lane, unsigned gmask,
                                        Cand cand, int64_t* cell,
                                        int* match) {
  const int n = 2 * s;
  for (int j0 = 0; j0 < n; j0 += LSK_QGROUP) {
    const int j = j0 + lane;
    int64_t cl = 0;
    int m = 0, stop = 0;
    if (j < n) {
      int row, col, key;
      cand(j >> 1, &row, &col, &key);
      cl = ((int64_t)(j & 1) * d + row) * d + col;
      const int cur = __ldg(kp + cl);
      m = cur == key;
      stop = m || cur == LSK_EMPTY;
    }
    const unsigned b = __ballot_sync(gmask, stop) & gmask;
    if (b) {
      const int owner = (__ffs(b) - 1) & (LSK_QGROUP - 1);
      *cell = __shfl_sync(gmask, (long long)cl, owner, LSK_QGROUP);
      *match = __shfl_sync(gmask, m, owner, LSK_QGROUP);
      return j0 + owner;
    }
  }
  return -1;
}

template <bool FUSED>
__global__ void __launch_bounds__(LSK_QTHREADS)
    lsk_probe_kernel(const LskQueryArgs a) {
  const int lane = threadIdx.x & (LSK_QGROUP - 1);
  const int64_t g = ((int64_t)blockIdx.x * LSK_QTHREADS + threadIdx.x) /
                    LSK_QGROUP;
  if (g >= (int64_t)a.S * a.B) return;  // whole groups only
  const unsigned gmask = 0xFFFFu << (threadIdx.x & 16);
  const int sh = (int)(g / a.B);
  const int q = (int)(g - (int64_t)sh * a.B);
  const int qi = (sh / a.per) * a.B + q;  // this row's group's query q
  const int64_t plane = 2 * (int64_t)a.d * a.d;
  const int* kp = a.key + sh * plane;

  int le = -1;
  LskVertex va, vb;
  int64_t cell = 0;
  int match = 0, stop;
  if constexpr (FUSED) {
    va = lsk_precompute(a.src[qi], a.la[qi], a.blocks, a.n_blocks, a.F,
                        a.seed);
    vb = lsk_precompute(a.dst[qi], a.lb[qi], a.blocks, a.n_blocks, a.F,
                        a.seed);
    if (a.le != nullptr) le = lsk_edge_label_bucket(a.le[qi], a.c, a.seed);
    stop = lsk_walk(kp, a.s, a.d, lane, gmask,
                    [&](int pi, int* row, int* col, int* key) {
                      lsk_edge_probe(va, vb, a.r, a.F, pi, row, col, key);
                    },
                    &cell, &match);
  } else {
    if (a.le != nullptr) le = a.le[qi];
    const int64_t qs = (int64_t)qi * a.s;
    stop = lsk_walk(kp, a.s, a.d, lane, gmask,
                    [&](int pi, int* row, int* col, int* key) {
                      *row = a.rows[qs + pi];
                      *col = a.cols[qs + pi];
                      *key = a.keys[qs + pi];
                    },
                    &cell, &match);
  }
  if constexpr (!FUSED)
    if (lane == 0) a.go_pool[g] = stop < 0;

  // where the answer's counters lie: a matrix cell, a pool slot or none
  const int* cnt = nullptr;  // cw or pool_cw at horizon 0, shard sh
  const int* lab = nullptr;  // pw or pool_pw likewise
  int64_t at = 0, hstride = 0;
  if (stop >= 0) {
    if (match) {
      cnt = a.cw;
      lab = a.pw;
      at = sh * plane + cell;
      hstride = a.S * plane;
    }
  } else if constexpr (FUSED) {
    const int base = lsk_pool_base(va.vid, vb.vid, a.Q, a.seed);
    const int* pk = a.pool_key + (int64_t)sh * a.Q * 2;
    for (int j0 = 0; j0 < a.probes; j0 += LSK_QGROUP) {
      const int j = j0 + lane;
      int slot = 0, m = 0;
      if (j < a.probes) {
        slot = (int)(((int64_t)base + j) % a.Q);
        m = __ldg(pk + 2 * slot) == va.vid &&
            __ldg(pk + 2 * slot + 1) == vb.vid;
      }
      const unsigned b = __ballot_sync(gmask, m) & gmask;
      if (b) {  // the first match among all probes
        const int owner = (__ffs(b) - 1) & (LSK_QGROUP - 1);
        slot = __shfl_sync(gmask, slot, owner, LSK_QGROUP);
        cnt = a.pool_cw;
        lab = a.pool_pw;
        at = (int64_t)sh * a.Q + slot;
        hstride = (int64_t)a.S * a.Q;
        break;
      }
    }
  }
  // lane h answers horizons h, h + 16, ...: their loads in flight together
  for (int h = lane; h < a.H; h += LSK_QGROUP) {
    int w = 0, wl = 0;
    if (cnt != nullptr) {
      const int64_t i = at + h * hstride;
      w = __ldg(cnt + i);
      if (le >= 0) wl = __ldg(lab + i * a.c + le);
    }
    const int64_t o = ((int64_t)h * a.S + sh) * a.B + q;
    a.w[o] = w;
    a.wl[o] = wl;
  }
}

static int lsk_launch_probe(const LskQueryArgs& a, bool fused, void* stream) {
  const long long n = (long long)a.S * a.B;
  if (n == 0 || a.H == 0) return 0;
  if (a.s <= 0 || a.d <= 0 || a.c <= 0 || a.H < 0 || a.per <= 0 ||
      n * LSK_QGROUP > 0x7FFFFFFFLL * LSK_QTHREADS)
    return (int)cudaErrorInvalidValue;
  const int blocks =
      (int)((n * LSK_QGROUP + LSK_QTHREADS - 1) / LSK_QTHREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (fused)
    lsk_probe_kernel<true><<<blocks, LSK_QTHREADS, 0, st>>>(a);
  else
    lsk_probe_kernel<false><<<blocks, LSK_QTHREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The TPU kernel's contract: w, wl, go_pool [S, nq]; no pool lookup.
extern "C" int lsk_sketch_query(const int* rows, const int* cols,
                                const int* keys, const int* le,
                                const int* key_plane, const int* cw,
                                const int* pw, int* w_out, int* wl_out,
                                int* go_pool, int S, int nq, int s, int d,
                                int c, void* stream) {
  LskQueryArgs a = {};
  a.rows = rows;
  a.cols = cols;
  a.keys = keys;
  a.le = le;
  a.key = key_plane;
  a.cw = cw;
  a.pw = pw;
  a.w = w_out;
  a.wl = wl_out;
  a.go_pool = go_pool;
  a.H = 1;
  a.S = S;
  a.B = nq;
  a.per = S;
  a.s = s;
  a.d = d;
  a.c = c;
  return lsk_launch_probe(a, false, stream);
}

// Raw edge queries (src, la, dst, lb, le [G x B]; le null without the
// label) against H horizons of planes: w, wl [H, S, B] after the pool
// lookup, shard row sh answering group sh / (S / G)'s B queries.
extern "C" int lsk_edge_query(const int* src, const int* la, const int* dst,
                              const int* lb, const int* le, const int* blocks,
                              const int* key_plane, const int* cw,
                              const int* pw, const int* pool_key,
                              const int* pool_cw, const int* pool_pw,
                              int* w_out, int* wl_out, int H, int S, int B,
                              int s, int d, int c, int Q, int probes,
                              int n_blocks, int F, int r, int seed,
                              int groups, void* stream) {
  if (Q <= 0 || probes < 0 || n_blocks <= 0 || F <= 0 || r <= 0 ||
      groups <= 0 || S % groups != 0 ||
      (long long)Q + probes > 0x7FFFFFFFLL ||
      (long long)groups * B > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  LskQueryArgs a = {};
  a.src = src;
  a.la = la;
  a.dst = dst;
  a.lb = lb;
  a.le = le;
  a.blocks = blocks;
  a.key = key_plane;
  a.cw = cw;
  a.pw = pw;
  a.pool_key = pool_key;
  a.pool_cw = pool_cw;
  a.pool_pw = pool_pw;
  a.w = w_out;
  a.wl = wl_out;
  a.H = H;
  a.S = S;
  a.B = B;
  a.per = S / groups;
  a.s = s;
  a.d = d;
  a.c = c;
  a.Q = Q;
  a.probes = probes;
  a.n_blocks = n_blocks;
  a.F = F;
  a.r = r;
  a.seed = (uint32_t)seed;
  return lsk_launch_probe(a, true, stream);
}
