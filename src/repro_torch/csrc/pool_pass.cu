// Stream-order additional-pool pass: a compaction across the card, then
// one walk block per shard.
//
// No TPU kernel computes this: it replaces the XLA while_loop of
// repro/kernels/sketch_insert/ops.py:42 (_pool_pass), whose port was a host
// loop over kernels/sketch_insert/ops.py::_pool_step (~27 small launches
// an item). Same result bit for bit: the eligible items of each shard, in
// stream order; an item with w_key > 0 claims the first of its pool probe
// slots that holds its (pid_src, pid_dst) or is EMPTY and adds w_count to
// pool_C[slot, sl] and pool_P[slot, sl, le]; an eligible item with no
// such slot adds its w_key to pool_lost. An item's probe slots are
// core/hashing.py::pool_slot_seq, computed here in uint32 for the
// eligible items only (the host computes nothing per item).
//
// Bound: the walk's chain of rounds in the largest shard; the bytes (the
// records, the plane in and out) are small beside it. Measured on the
// one-block design (stats buffer, NVIDIA H100 80GB HBM3, 700 W): at the
// deployment's last flush the nearly full shard's walk took 270 us of a
// 294 us launch, 117 rounds for 1,147 items, 78 of them voided by a lane
// carrying its slot's first claimer's pair; the in-block compaction of
// the shard's 32,768 items took 41 us.
//
// Design:
//   1. compaction across the card (grid (ceil(B / 1024), S)): each block
//      ranks a 1024-item chunk's eligible items by ballots and a warp scan,
//      writes their records (pid_src, pid_dst, w_count, w_key, sl, le,
//      first probe slot; 32 bytes) at chunk-local ranks and the chunk's
//      count. No host sync: a shard with nothing eligible walks nothing.
//   2. the walk (grid S): the block scans its shard's chunk counts, stages
//      the shard's pool_key plane ([Q, 2] int32: 128 KiB at Q = 16,384) in
//      dynamic shared memory when it fits (otherwise the walk reads and
//      writes it in global memory, with the same code), and one warp walks
//      the records in stream order: 32 ranks at a time, each found by a
//      binary search over the chunk offsets and staged by cp.async two
//      groups ahead, off the chain. A group is walked in speculative
//      rounds: lane j decides item j from the pool at the round's start,
//      its probe slots loaded 16 at a time, all in flight before any is
//      compared, then a bit scan (a single warp's chain of dependent
//      steps is what a round costs; tools/pool_round_costs.py splits it).
//      Slots only go from EMPTY to a key, so a decision can only be
//      voided by an earlier lane claiming the same slot X. If that earlier
//      lane is X's first claimer and carries this lane's (pid_src,
//      pid_dst), this lane's decision stands: it follows the same probe
//      sequence, every slot before X on it was neither EMPTY nor its pair
//      at the round's start and still is, so it finds X holding its pair
//      and adds there without claiming. Any other shared claim voids the
//      round from the later lane on (__match_any_sync finds it).
//      Committed claims are stores to the plane; the pool_C / pool_P adds
//      (int32 atomics, exact in any order) follow the group's last round;
//      pool_lost is summed in registers and added once.
//   3. the staged plane is written back.
// The shared-memory attribute is set once per device, not at each launch.
#include "common.cuh"

#define LSK_POOL_THREADS 1024  // a compaction chunk, and the walk's block
#define LSK_POOL_GROUP 32      // items a round decides at most
#define LSK_POOL_REC 8         // ints in an item's record (one padding)
#define LSK_POOL_PROBE_BATCH 16  // probe slots a lane loads at once
#define LSK_POOL_STAGES 3      // groups of records staged ahead + 1
#define LSK_MAX_DEVICES 64

// the optional stats row of a shard (int64; kernels/sketch_insert's
// POOL_STATS names them): rounds walked, rounds voided by a lane carrying
// its slot's first claimer's pair (never, under the same-pair rule) and
// by any other lane, eligible items, lanes committed by the same-pair
// rule, and globaltimer ns stamps: the compaction's start and end (over
// its blocks), the walk's start, the plane staged, the walk done, the
// plane written back
#define LSK_POOL_NSTAT 11
#define LSK_ST_ROUNDS 0
#define LSK_ST_VOID_SAME 1
#define LSK_ST_VOID_OTHER 2
#define LSK_ST_ITEMS 3
#define LSK_ST_MERGED 4
#define LSK_ST_T_COMPACT0 5
#define LSK_ST_T_COMPACT1 6
#define LSK_ST_T_WALK0 7
#define LSK_ST_T_STAGED 8
#define LSK_ST_T_WALKED 9
#define LSK_ST_T_WRITTEN 10

__device__ __forceinline__ long long lsk_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// core/hashing.py::pool_slot_seq's first slot, in uint32: the murmur3
// finalizer of (pid_src * 0x9E3779B9) ^ pid_dst with seed ^ 0x31, mod 2^31,
// mod Q
__device__ __forceinline__ int lsk_pool_base(int pid_src, int pid_dst,
                                             unsigned seed, int Q) {
  unsigned h = ((unsigned)pid_src * 0x9E3779B9u) ^ (unsigned)pid_dst;
  h ^= seed ^ 0x0031u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (int)((h & 0x7FFFFFFFu) % (unsigned)Q);
}

__device__ __forceinline__ void lsk_pool_cp_async16(int* smem,
                                                    const int* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem));
}

// ints the staged plane takes, rounded up to 16 bytes
__host__ __device__ __forceinline__ int lsk_pool_plane_ints(int Q) {
  return (2 * Q + 3) & ~3;
}

// 1. compaction: block (chunk, shard)
__global__ void __launch_bounds__(LSK_POOL_THREADS) lsk_pool_compact_kernel(
    const int* __restrict__ pid_src, const int* __restrict__ pid_dst,
    const int* __restrict__ w_count, const int* __restrict__ w_key,
    const int* __restrict__ sl, const int* __restrict__ le,
    const int* __restrict__ eligible,  // [S, B]
    int* __restrict__ rec,             // [S, B, LSK_POOL_REC]
    int* __restrict__ chunk_n,         // [S, n_chunks]
    long long* stats, int B, int Q, unsigned seed) {
  __shared__ int warp_n[32];
  __shared__ int warp_off[32];
  const int chunk = blockIdx.x, sh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long* st = stats != nullptr ? stats + (long long)sh * LSK_POOL_NSTAT
                                   : nullptr;
  if (st != nullptr && tid == 0)
    atomicMin(st + LSK_ST_T_COMPACT0, lsk_globaltimer());
  const int i = chunk * LSK_POOL_THREADS + tid;
  const long long e = (long long)sh * B + i;
  const bool f = i < B && eligible[e] != 0;
  const unsigned m = __ballot_sync(0xffffffffu, f);
  if (lane == 0) warp_n[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    const int v = warp_n[lane];
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    warp_off[lane] = x - v;
    if (lane == 31) {
      chunk_n[(long long)sh * gridDim.x + chunk] = x;
      if (st != nullptr) atomicAdd((unsigned long long*)st + LSK_ST_ITEMS,
                                   (unsigned long long)x);
    }
  }
  __syncthreads();
  if (f) {
    const int r = warp_off[warp] + __popc(m & ((1u << lane) - 1u));
    const int ps = pid_src[e], pd = pid_dst[e];
    int4* o = (int4*)(rec + ((long long)sh * B + chunk * LSK_POOL_THREADS +
                             r) * LSK_POOL_REC);
    o[0] = make_int4(ps, pd, w_count[e], w_key[e]);
    o[1] = make_int4(sl[e], le[e], lsk_pool_base(ps, pd, seed, Q), 0);
  }
  if (st != nullptr) {
    __syncthreads();
    if (tid == 0) atomicMax(st + LSK_ST_T_COMPACT1, lsk_globaltimer());
  }
}

// 2-3. the walk: block per shard
__global__ void __launch_bounds__(LSK_POOL_THREADS) lsk_pool_walk_kernel(
    const int* __restrict__ rec, const int* __restrict__ chunk_n,
    int* pool_key, int* pool_C, int* pool_P, int* pool_lost,
    long long* stats, int B, int n_chunks, int probes, int Q, int k, int c,
    int stage_plane) {
  extern __shared__ int4 smem4[];
  int* smem = (int*)smem4;
  const int sh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = LSK_POOL_REC;
  long long* st = stats != nullptr ? stats + (long long)sh * LSK_POOL_NSTAT
                                   : nullptr;
  if (st != nullptr && tid == 0) st[LSK_ST_T_WALK0] = lsk_globaltimer();
  int* plane_g = pool_key + (long long)sh * Q * 2;
  int* plane_s = smem;  // first: 16-byte aligned
  // LSK_POOL_STAGES groups of records, 16-byte aligned for cp.async
  int* stg = smem + (stage_plane ? lsk_pool_plane_ints(Q) : 0);
  int* coff = stg + LSK_POOL_STAGES * LSK_POOL_GROUP * R;  // [n_chunks + 1]
  const int* rec_sh = rec + (long long)sh * B * R;

  // the chunk offsets (exclusive scan of the counts, 32 at a time)
  if (warp == 0) {
    int carry = 0;
    for (int c0 = 0; c0 < n_chunks; c0 += 32) {
      const int v = c0 + lane < n_chunks
                        ? chunk_n[(long long)sh * n_chunks + c0 + lane]
                        : 0;
      int x = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (c0 + lane < n_chunks) coff[c0 + lane] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) coff[n_chunks] = carry;
  }
  if (stage_plane)
    for (int i = tid; i < 2 * Q; i += LSK_POOL_THREADS)
      plane_s[i] = plane_g[i];
  __syncthreads();  // the offsets and the staged plane are complete
  const int n = coff[n_chunks];
  if (st != nullptr && tid == 0) st[LSK_ST_T_STAGED] = lsk_globaltimer();

  if (warp == 0 && n > 0) {
    volatile int* pk = stage_plane ? plane_s : plane_g;
    const unsigned lt = (1u << lane) - 1u;  // the lanes before this one
    int lost = 0;
    long long n_rounds = 0, n_void = 0, n_merged = 0;
    // stage the records of ranks g0 .. g0 + 31 (lane j: rank g0 + j)
    auto issue = [&](int g0, int buf) {
      const int g = g0 + lane;
      if (g < n) {
        int lo = 0, hi = n_chunks;  // coff[lo] <= g < coff[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (coff[mid] <= g) lo = mid;
          else hi = mid;
        }
        const int* src =
            rec_sh + ((long long)lo * LSK_POOL_THREADS + g - coff[lo]) * R;
        int* dst = stg + (buf * LSK_POOL_GROUP + lane) * R;
        lsk_pool_cp_async16(dst, src);
        lsk_pool_cp_async16(dst + 4, src + 4);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    // LSK_POOL_STAGES groups in flight: one commit group a step, empty past
    // the last rank, so the group walked next is always complete after
    // wait_group LSK_POOL_STAGES - 1
    for (int b = 0; b < LSK_POOL_STAGES - 1; ++b)
      issue(b * LSK_POOL_GROUP, b);
    for (int g0 = 0, buf = 0; g0 < n; g0 += LSK_POOL_GROUP) {
      issue(g0 + (LSK_POOL_STAGES - 1) * LSK_POOL_GROUP,
            (buf + LSK_POOL_STAGES - 1) % LSK_POOL_STAGES);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(LSK_POOL_STAGES - 1));
      __syncwarp();
      const int m = min(LSK_POOL_GROUP, n - g0);
      const int* r = stg + (buf * LSK_POOL_GROUP + lane) * R;  // item lane
      const int ps = r[0], pd = r[1], wc = r[2], wk = r[3];
      const int isl = r[4], ile = r[5], base = r[6];
      int cslot = -1;  // the slot this lane's item adds at, once committed
      for (int start = 0; start < m;) {
        // lane j decides item j from the pool at the round's start
        const bool act = lane >= start && lane < m;
        int wslot = -1;
        bool claim = false;
        if (act) {
          // the probe slots LSK_POOL_PROBE_BATCH at a time: every row
          // loaded first (no branch between the loads, so they are in
          // flight together; past the last probe a load reads a valid
          // slot that is not looked at), then the first that is EMPTY or
          // holds the pair by a bit scan
          int slot = base;
          for (int q0 = 0; q0 < probes; q0 += LSK_POOL_PROBE_BATCH) {
            const int first = slot;
            long long row[LSK_POOL_PROBE_BATCH];  // (k0, k1) of each slot
#pragma unroll
            for (int u = 0; u < LSK_POOL_PROBE_BATCH; ++u) {
              row[u] = *(volatile long long*)(pk + 2 * slot);
              if (++slot == Q) slot = 0;
            }
            unsigned empty = 0u, stop = 0u;
#pragma unroll
            for (int u = 0; u < LSK_POOL_PROBE_BATCH; ++u) {
              const int k0 = (int)row[u], k1 = (int)(row[u] >> 32);
              const bool in = q0 + u < probes;
              empty |= (unsigned)(in && k0 == LSK_EMPTY) << u;
              stop |= (unsigned)(in && (k0 == LSK_EMPTY ||
                                        (k0 == ps && k1 == pd))) << u;
            }
            if (stop != 0u) {
              const int u = __ffs(stop) - 1;
              wslot = first + u;
              while (wslot >= Q) wslot -= Q;
              claim = ((empty >> u) & 1u) && wk > 0;  // a claim writes
              break;                                 // only with w_key > 0
            }
          }
        }
        // lanes claiming one slot: the first claimer keeps its claim, a
        // later lane with its pair adds there, any other voids the round
        const unsigned same = __match_any_sync(0xffffffffu,
                                               claim ? wslot : -2 - lane);
        const int lead = __ffs(same) - 1;
        const int lps = __shfl_sync(0xffffffffu, ps, lead);
        const int lpd = __shfl_sync(0xffffffffu, pd, lead);
        const bool later = claim && (same & lt) != 0u;
        const bool merge = later && lps == ps && lpd == pd;
        const unsigned bad = __ballot_sync(0xffffffffu, later && !merge);
        const int end = bad ? __ffs(bad) - 1 : m;
        if (act && lane < end) {  // commit
          if (wslot < 0) {
            lost += wk;
          } else if (wk > 0) {
            if (claim && !merge) {
              pk[2 * wslot] = ps;
              pk[2 * wslot + 1] = pd;
            }
            cslot = wslot;
          }
        }
        if (st != nullptr) {
          ++n_rounds;
          n_void += bad != 0u;
          n_merged += __popc(__ballot_sync(0xffffffffu, merge && lane < end));
        }
        start = end;
        __syncwarp();  // the next round's lanes see this round's claims
      }
      if (cslot >= 0) {  // the group's adds, off the rounds' chain
        const long long ci = ((long long)sh * Q + cslot) * k + isl;
        atomicAdd(pool_C + ci, wc);
        atomicAdd(pool_P + ci * c + ile, wc);
      }
      buf = (buf + 1) % LSK_POOL_STAGES;
      __syncwarp();  // the buffer is refilled next step
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    for (int o = 16; o > 0; o >>= 1)
      lost += __shfl_down_sync(0xffffffffu, lost, o);
    if (lane == 0 && lost != 0) atomicAdd(pool_lost + sh, lost);
    if (st != nullptr && lane == 0) {
      st[LSK_ST_ROUNDS] = n_rounds;
      st[LSK_ST_VOID_OTHER] = n_void;
      st[LSK_ST_MERGED] = n_merged;
    }
  }
  if (st != nullptr) {
    __syncthreads();
    if (tid == 0) st[LSK_ST_T_WALKED] = lsk_globaltimer();
  }

  // 3. write the staged plane back
  if (stage_plane) {
    __syncthreads();
    for (int i = tid; i < 2 * Q; i += LSK_POOL_THREADS)
      plane_g[i] = plane_s[i];
  }
  if (st != nullptr) {
    __syncthreads();
    if (tid == 0) st[LSK_ST_T_WRITTEN] = lsk_globaltimer();
  }
}

// the walk's dynamic shared memory a block may take on each device (set
// once per device)
static int g_walk_smem[LSK_MAX_DEVICES];

// scratch: rec [S, B, LSK_POOL_REC] then chunk counts [S, ceil(B / 1024)]
extern "C" int lsk_pool_pass(
    const int* pid_src, const int* pid_dst,
    const int* w_count, const int* w_key, const int* sl, const int* le,
    const int* eligible, int* pool_key, int* pool_C, int* pool_P,
    int* pool_lost, int* scratch, long long* stats, int S, int B, int probes,
    int Q, int k, int c, int seed, void* stream) {
  if (S == 0 || B == 0) return 0;
  if (Q <= 0 || probes <= 0 || (long long)Q + probes > 0x7FFFFFFFLL ||
      (long long)S * B * LSK_POOL_REC > 0x7FFFFFFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= LSK_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (g_walk_smem[dev] == 0) {
    int limit = 0;
    cudaFuncAttributes attr;
    if ((err = cudaDeviceGetAttribute(
             &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaFuncGetAttributes(&attr, lsk_pool_walk_kernel)))
      return (int)err;
    const int avail = limit - (int)attr.sharedSizeBytes;
    if ((err = cudaFuncSetAttribute(
             lsk_pool_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             avail)))
      return (int)err;
    g_walk_smem[dev] = avail;
  }
  const int n_chunks = (B + LSK_POOL_THREADS - 1) / LSK_POOL_THREADS;
  const size_t rest = sizeof(int) * ((size_t)LSK_POOL_STAGES *
                                     LSK_POOL_GROUP * LSK_POOL_REC +
                                     n_chunks + 1);
  const size_t plane = (size_t)lsk_pool_plane_ints(Q) * sizeof(int);
  const int stage_plane = plane + rest <= (size_t)g_walk_smem[dev];
  const size_t smem = rest + (stage_plane ? plane : 0);
  if (smem > (size_t)g_walk_smem[dev]) return (int)cudaErrorInvalidValue;
  int* rec = scratch;
  int* chunk_n = scratch + (long long)S * B * LSK_POOL_REC;
  cudaStream_t st = (cudaStream_t)stream;
  lsk_pool_compact_kernel<<<dim3(n_chunks, S), LSK_POOL_THREADS, 0, st>>>(
      pid_src, pid_dst, w_count, w_key, sl, le, eligible, rec, chunk_n,
      stats, B, Q, (unsigned)seed);
  lsk_pool_walk_kernel<<<S, LSK_POOL_THREADS, smem, st>>>(
      rec, chunk_n, pool_key, pool_C, pool_P, pool_lost, stats, B, n_chunks,
      probes, Q, k, c, stage_plane);
  return (int)cudaGetLastError();
}
