// Shared helpers for the trackdlo_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TD_FULL_MASK 0xffffffffu

// Fixed-order warp tree reductions: the result in lane 0 is the same on
// every run (no atomics in any of this library's arithmetic).
__device__ __forceinline__ float td_warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(TD_FULL_MASK, v, off);
  return v;
}

// Butterfly sum: every lane gets the same bits (addition is commutative).
__device__ __forceinline__ float td_warp_allsum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(TD_FULL_MASK, v, off);
  return v;
}

__device__ __forceinline__ float td_warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_down_sync(TD_FULL_MASK, v, off));
  return v;
}

// sum += v with the compensation c (Kahan): no operation is contracted or
// reordered (-fmad=false, no fast math), so it is the same run to run.
__device__ __forceinline__ void td_kahan_add(float& sum, float& c, float v) {
  const float y = v - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

// Every lane gets the lowest index among lanes holding `hit`, or 1e9f.
__device__ __forceinline__ float td_warp_first(bool hit, float idx) {
  float v = hit ? idx : 1e9f;
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(TD_FULL_MASK, v, off));
  return v;
}
