// LSketch addressing on the card, in native uint32: what
// repro_torch/core/hashing.py and core/lsketch.py (precompute,
// edge_probes, edge_label_bucket, pool_slot_seq) compute with uint32
// emulated in int64 tensors, bit for bit. Each function is per value, so
// a lane derives only the candidate it walks.
//
// The seed is passed as its 32 bits (a negative Python seed included):
// the reference masks it with 0xFFFFFFFF, and XOR with the derived-seed
// constants commutes with that mask. Traps the reference fixes and this
// header keeps:
//   * s(v) + offset wraps in int32 and the modulo after it is a floor
//     modulo (jnp semantics), not C's truncating %;
//   * pack_key and pack_vertex_id wrap in int32;
//   * padded query rows carry EMPTY (-1) as vertex and label and hash as
//     0xFFFFFFFF does (the cast below); their answers are sliced away.
#pragma once

#include "common.cuh"

#define LSK_LCG_T 1103515245u
#define LSK_LCG_I 12345u
#define LSK_M_MASK 0x7FFFFFFFu
#define LSK_IDX_RADIX 16
#define LSK_VID_RADIX 2048

// Murmur3 finalizer with seed (hashing.py::mix32).
__device__ __forceinline__ uint32_t lsk_mix32(int x, uint32_t seed) {
  uint32_t h = (uint32_t)x ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// H(.) in [0, 2^31).
__device__ __forceinline__ int lsk_hash31(int x, uint32_t seed) {
  return (int)(lsk_mix32(x, seed) & LSK_M_MASK);
}

// One linear-congruence step in [0, 2^31).
__device__ __forceinline__ uint32_t lsk_lcg_next(uint32_t x) {
  return (LSK_LCG_T * x + LSK_LCG_I) & LSK_M_MASK;
}

// x advanced n steps: lcg^n(x).
__device__ __forceinline__ uint32_t lsk_lcg_steps(uint32_t x, int n) {
  for (int i = 0; i < n; ++i) x = lsk_lcg_next(x);
  return x;
}

// candidate_offsets(f, r)[i]: the (i + 1)-th LCG step from f.
__device__ __forceinline__ int lsk_candidate_offset(int f, int i) {
  return (int)lsk_lcg_steps((uint32_t)f, i + 1);
}

// sample_pairs(fa, fb, r, s)[i] -> (A_i, B_i) in [0, r).
__device__ __forceinline__ void lsk_sample_pair(int fa, int fb, int r, int i,
                                                int* ai, int* bi) {
  const int x = (int)lsk_lcg_steps((uint32_t)fa + (uint32_t)fb, i + 1);
  *ai = (x / r) % r;  // x >= 0: C's / and % are floor here
  *bi = x % r;
}

// ((ia * IDX_RADIX + ib) * F + fa) * F + fb with int32 wrap.
__device__ __forceinline__ int lsk_pack_key(int ia, int ib, int fa, int fb,
                                            int F) {
  uint32_t x = (uint32_t)ia * LSK_IDX_RADIX + (uint32_t)ib;
  x = x * (uint32_t)F + (uint32_t)fa;
  return (int)(x * (uint32_t)F + (uint32_t)fb);
}

// (m * 2048 + s) * F + f with int32 wrap.
__device__ __forceinline__ int lsk_pack_vertex_id(int m, int s, int f,
                                                  int F) {
  const uint32_t x = (uint32_t)m * LSK_VID_RADIX + (uint32_t)s;
  return (int)(x * (uint32_t)F + (uint32_t)f);
}

// Edge-label bucket in [0, c).
__device__ __forceinline__ int lsk_edge_label_bucket(int label, int c,
                                                     uint32_t seed) {
  return lsk_hash31(label, seed ^ 0x77E1u) % c;
}

// The pool probe sequence's first slot: slot j is (base + j) mod q.
__device__ __forceinline__ int lsk_pool_base(int pid_src, int pid_dst,
                                             int q, uint32_t seed) {
  const uint32_t h0 = lsk_mix32(
      (int)(((uint32_t)pid_src * 0x9E3779B9u) ^ (uint32_t)pid_dst),
      seed ^ 0x0031u);
  return (int)((h0 & LSK_M_MASK) % (uint32_t)q);
}

// Everything Algorithm 1 (Precompute) derives for one endpoint that the
// probe walk reads. ``blocks`` holds n_blocks starts then n_blocks widths.
struct LskVertex {
  int start, width, s, f, vid;
};

__device__ __forceinline__ LskVertex lsk_precompute(int v, int label,
                                                    const int* blocks,
                                                    int n_blocks, int F,
                                                    uint32_t seed) {
  LskVertex a;
  const int m = lsk_hash31(label, seed ^ 0x5B1Du) % n_blocks;
  a.start = blocks[m];
  a.width = blocks[n_blocks + m];
  const int h = lsk_hash31(v, seed);
  a.f = h % F;  // h >= 0
  a.s = (h / F) % a.width;
  a.vid = lsk_pack_vertex_id(m, a.s, a.f, F);
  return a;
}

// Probe cell pi of edge (a, b) (edge_probes): absolute row and column of
// the cell and the packed key the walk compares.
__device__ __forceinline__ void lsk_edge_probe(const LskVertex& a,
                                               const LskVertex& b, int r,
                                               int F, int pi, int* row,
                                               int* col, int* key) {
  int ai, bi;
  lsk_sample_pair(a.f, b.f, r, pi, &ai, &bi);
  const int oa = lsk_candidate_offset(a.f, ai);
  const int ob = lsk_candidate_offset(b.f, bi);
  // s + offset wraps in int32; the modulo is a floor modulo
  *row = a.start + lsk_floormod((int)((uint32_t)a.s + (uint32_t)oa), a.width);
  *col = b.start + lsk_floormod((int)((uint32_t)b.s + (uint32_t)ob), b.width);
  *key = lsk_pack_key(ai, bi, a.f, b.f, F);
}
