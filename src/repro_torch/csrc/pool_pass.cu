// Stream-order additional-pool pass, one block per shard.
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
// Design, per shard (block of 1024 threads):
//   1. compaction on the card: the block walks the shard's items in
//      chunks of 1024; ballots and a scan over the warps' counts give each
//      eligible item its rank in stream order, and its owning thread
//      writes the item's record (pid_src, pid_dst, w_count, w_key, sl, le,
//      its first probe slot) at that rank. No host sync: a shard with
//      nothing eligible walks nothing.
//   2. the shard's pool_key plane ([Q, 2] int32: 128 KiB at Q = 16,384)
//      is staged in dynamic shared memory when it fits; otherwise the walk
//      reads and writes it in global memory (volatile), with the same code.
//   3. one warp walks the records in rank order: 32 records at a time are
//      staged in shared memory by cp.async, double-buffered, off the
//      chain, and walked in speculative rounds: lane j decides item j
//      from the pool at the round's start (its probe slots in order, the
//      first that holds its pair or is EMPTY). Slots only go from EMPTY
//      to a key, so a decision can only be voided by an earlier item
//      claiming the same slot: __match_any_sync over the claimed slots
//      finds the first such lane, the lanes before it commit (the key
//      claims are shared-memory stores, the pool_C / pool_P adds int32
//      atomics, exact), and the next round starts at it. pool_lost is
//      summed in registers and added once.
//   4. the staged plane is written back.
//
// Bound: the rounds of the largest shard (its eligible count / 32 when no
// two items of a chunk claim one slot), the compaction's pass over the
// shard's B items, and the plane's staging; the bytes (the records, the
// plane in and out) are small beside them.
#include "common.cuh"

#define LSK_POOL_THREADS 1024
#define LSK_POOL_CHUNK 32
#define LSK_POOL_REC 7  // ints in an item's record

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

__device__ __forceinline__ void lsk_pool_cp_async4(int* smem,
                                                   const int* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(gmem));
}

__global__ void __launch_bounds__(LSK_POOL_THREADS) lsk_pool_pass_kernel(
    const int* __restrict__ pid_src, const int* __restrict__ pid_dst,
    const int* __restrict__ w_count, const int* __restrict__ w_key,
    const int* __restrict__ sl, const int* __restrict__ le,
    const int* __restrict__ eligible,  // [S, B]
    int* pool_key, int* pool_C, int* pool_P, int* pool_lost,
    int* rec,  // [S, B, LSK_POOL_REC] scratch
    int B, int probes, int Q, int k, int c, unsigned seed, int stage_plane) {
  extern __shared__ int smem[];
  __shared__ int warp_n[32];
  __shared__ int warp_off[32];
  __shared__ int chunk_n;
  const int sh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = LSK_POOL_REC;
  const long long sB = (long long)sh * B;
  int* rec_sh = rec + sB * R;

  // 1. compaction: rank in stream order, record at the rank
  int n = 0;
  for (int c0 = 0; c0 < B; c0 += LSK_POOL_THREADS) {
    const int i = c0 + tid;
    const bool f = i < B && eligible[sB + i] != 0;
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
      if (lane == 31) chunk_n = x;
    }
    __syncthreads();
    if (f) {
      const int r = n + warp_off[warp] + __popc(m & ((1u << lane) - 1u));
      int* o = rec_sh + (long long)r * R;
      const long long e = sB + i;
      o[0] = pid_src[e];
      o[1] = pid_dst[e];
      o[2] = w_count[e];
      o[3] = w_key[e];
      o[4] = sl[e];
      o[5] = le[e];
      o[6] = lsk_pool_base(o[0], o[1], seed, Q);
    }
    n += chunk_n;
    __syncthreads();  // chunk_n and warp_off are rewritten next chunk
  }

  // 2. the shard's pool_key plane
  int* plane_g = pool_key + (long long)sh * Q * 2;
  int* stg = smem;  // two staging buffers of LSK_POOL_CHUNK * R ints
  int* plane_s = smem + 2 * LSK_POOL_CHUNK * R;
  if (stage_plane)
    for (int i = tid; i < 2 * Q; i += LSK_POOL_THREADS)
      plane_s[i] = plane_g[i];
  __syncthreads();  // the records and the staged plane are complete

  // 3. one warp walks the records in stream order, in speculative rounds
  if (warp == 0 && n > 0) {
    volatile int* pk = stage_plane ? plane_s : plane_g;
    const unsigned lt = (1u << lane) - 1u;  // the lanes before this one
    int lost = 0;
    auto issue = [&](int c0, int buf) {
      const int m = min(LSK_POOL_CHUNK, n - c0);
      const int* src = rec_sh + (long long)c0 * R;
      int* dst = stg + buf * LSK_POOL_CHUNK * R;
      for (int i = lane; i < m * R; i += 32)
        lsk_pool_cp_async4(dst + i, src + i);
      asm volatile("cp.async.commit_group;\n" ::);
    };
    issue(0, 0);
    for (int c0 = 0, buf = 0; c0 < n; c0 += LSK_POOL_CHUNK, buf ^= 1) {
      if (c0 + LSK_POOL_CHUNK < n) {
        issue(c0 + LSK_POOL_CHUNK, buf ^ 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncwarp();
      const int m = min(LSK_POOL_CHUNK, n - c0);
      const int* r = stg + buf * LSK_POOL_CHUNK * R + lane * R;  // item lane
      for (int start = 0; start < m;) {
        // lane j decides item j from the pool at the round's start
        const bool act = lane >= start && lane < m;
        int wslot = -1;
        bool claim = false;
        if (act) {
          int slot = r[6];
          for (int q = 0; q < probes; ++q) {
            const int k0 = pk[2 * slot];
            if (k0 == LSK_EMPTY) {
              wslot = slot;
              claim = r[3] > 0;  // only a claim with w_key > 0 writes
              break;
            }
            if (k0 == r[0] && pk[2 * slot + 1] == r[1]) {
              wslot = slot;
              break;
            }
            if (++slot == Q) slot = 0;
          }
        }
        // an earlier lane claiming the same slot voids this lane's decision
        // (slots only go from EMPTY to a key)
        const unsigned same = __match_any_sync(0xffffffffu,
                                               claim ? wslot : -2 - lane);
        const unsigned bad = __ballot_sync(0xffffffffu, claim && (same & lt));
        const int end = bad ? __ffs(bad) - 1 : m;
        if (act && lane < end) {  // commit
          const int wk = r[3];
          if (wslot < 0) {
            lost += wk;
          } else if (wk > 0) {
            if (claim) {
              pk[2 * wslot] = r[0];
              pk[2 * wslot + 1] = r[1];
            }
            const long long ci = ((long long)sh * Q + wslot) * k + r[4];
            atomicAdd(pool_C + ci, r[2]);
            atomicAdd(pool_P + ci * c + r[5], r[2]);
          }
        }
        start = end;
        __syncwarp();  // the next round's lanes see this round's claims
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      lost += __shfl_down_sync(0xffffffffu, lost, o);
    if (lane == 0 && lost != 0) atomicAdd(pool_lost + sh, lost);
  }

  // 4. write the staged plane back
  if (stage_plane) {
    __syncthreads();
    for (int i = tid; i < 2 * Q; i += LSK_POOL_THREADS)
      plane_g[i] = plane_s[i];
  }
}

extern "C" int lsk_pool_pass(
    const int* pid_src, const int* pid_dst,
    const int* w_count, const int* w_key, const int* sl, const int* le,
    const int* eligible, int* pool_key, int* pool_C, int* pool_P,
    int* pool_lost, int* rec, int S, int B, int probes, int Q, int k, int c,
    int seed, void* stream) {
  if (S == 0 || B == 0) return 0;
  if (Q <= 0 || probes <= 0 || (long long)Q + probes > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const size_t stage = (size_t)2 * LSK_POOL_CHUNK * LSK_POOL_REC * sizeof(int);
  const size_t plane = (size_t)2 * Q * sizeof(int);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  // the static arrays above take < 1 KB of the block's shared memory
  const int stage_plane = stage + plane + 1024 <= (size_t)limit;
  const size_t smem = stage + (stage_plane ? plane : 0);
  if (smem + 1024 > (size_t)limit) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(lsk_pool_pass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  lsk_pool_pass_kernel<<<S, LSK_POOL_THREADS, smem, (cudaStream_t)stream>>>(
      pid_src, pid_dst, w_count, w_key, sl, le, eligible, pool_key, pool_C,
      pool_P, pool_lost, rec, B, probes, Q, k, c, (unsigned)seed, stage_plane);
  return (int)cudaGetLastError();
}
