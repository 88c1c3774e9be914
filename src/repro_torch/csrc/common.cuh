// Shared helpers of the LSketch CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LSK_EMPTY (-1)

// Floor division and modulo, as jnp's // and % on int32 (CUDA's / and %
// truncate toward zero). Divisors here are always positive.
__device__ __forceinline__ int lsk_floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int lsk_floormod(int a, int b) {
  int m = a % b;
  return (m != 0 && m < 0) ? m + b : m;
}
