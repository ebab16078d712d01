// The equilibrated Gauss-Jordan M-step solve of one (m, m) system with
// three right-hand sides, as block-wide device code in shared memory. Kernel
// E (em_loop.cu) runs it inside its EM loop; kernel G (gj_solve.cu) runs it
// once per system.
//
// The steps are those of trackdlo_tpu/ops/pallas_kernels.py
// gauss_jordan_solve_batched and _batched_gj_kernel:
// - each row of A and B divided by a power of two near max|A_row| (exact:
//   only exponents change), by the rule of the TPU kernel being replaced
//   (GjScale below);
// - Gauss-Jordan on [A/e | I | B/e] with partial pivoting over the rows not
//   yet used, ties to the lowest row, no row swaps (pivot rows recorded in
//   perm); a zero pivot divides by 1;
// - w[k] = B_f[perm[k]] / pivot_k and inv[k] = I_f[perm[k]] / pivot_k, with
//   |pivot| < 1e-30 read as 1;
// - three refinement steps against the unscaled system:
//   w += inv ((B - A w) / e).
// Padded equations of the TPU function are identity rows that never mix
// with the real ones, so solving at m (not m_pad) gives the same steps.
#pragma once

#include "common.cuh"

namespace td {

constexpr int GJ_MMAX = 48;

struct GjSmem {
  float aug[GJ_MMAX * (2 * GJ_MMAX + 3)];  // [A/e | I | B/e]
  float inv[GJ_MMAX * GJ_MMAX];
  float r[GJ_MMAX * 3];
  float e[GJ_MMAX], factor[GJ_MMAX], diag[GJ_MMAX], used[GJ_MMAX];
  int perm[GJ_MMAX];
  int ridx;
  float pivot;
};

// The two row-scale rules of the TPU kernels. They differ by a factor of 2
// where max|A_row| is an exact power of two (and on zero or subnormal rows),
// which can change a pivot choice, so each kernel keeps its own.
enum class GjScale {
  // gauss_jordan_solve_batched (pallas_kernels.py:1098-1101):
  // 2^ceil(log2 d) for d > 0, else 1.
  kCeilLog2,
  // fused_em_loop's M-step (pallas_kernels.py:1352-1357): the exponent bits
  // of d (1 for d = 0) plus one, 2^(floor(log2 d) + 1) for normal d.
  kExponentBits,
};

template <GjScale RULE>
__device__ __forceinline__ float gj_row_scale(float d) {
  if constexpr (RULE == GjScale::kCeilLog2) {
    if (!(d > 0.0f)) return 1.0f;
    int ex;
    const float fr = frexpf(d, &ex);  // d = fr * 2^ex, fr in [0.5, 1)
    return fr == 0.5f ? d : ldexpf(1.0f, ex);
  } else {
    if (!(d > 0.0f)) d = 1.0f;
    const int ebits = (__float_as_int(d) >> 23) & 255;
    return __int_as_float((ebits + 1) << 23);
  }
}

// Solves A w = B for one system: ``a`` (m*m, row-major) and ``b`` (m*3)
// unscaled in shared memory; ``w`` (m*3) in shared memory is written. Every
// thread of the block calls it; it ends after a barrier.
template <int THREADS, GjScale RULE>
__device__ void gj_solve(int m, const float* a, const float* b, float* w, GjSmem& G) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int width = 2 * m + 3;
  if (tid < m) {
    float d = 0.0f;
    for (int c = 0; c < m; ++c) d = fmaxf(d, fabsf(a[tid * m + c]));
    G.e[tid] = gj_row_scale<RULE>(d);
    G.used[tid] = 0.0f;
  }
  __syncthreads();
  for (int k = tid; k < m * width; k += THREADS) {
    const int r = k / width, c = k % width;
    float v;
    if (c < m) v = a[r * m + c] / G.e[r];
    else if (c < 2 * m) v = (c - m == r) ? 1.0f : 0.0f;
    else v = b[r * 3 + c - 2 * m] / G.e[r];
    G.aug[k] = v;
  }
  __syncthreads();
  for (int k = 0; k < m; ++k) {
    if (warp == 0) {
      float bv = -2.0f;
      int br = m;
      for (int r = lane; r < m; r += 32) {
        const float cand = G.used[r] > 0.0f ? -1.0f : fabsf(G.aug[r * width + k]);
        if (cand > bv) {
          bv = cand;
          br = r;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(TD_FULL_MASK, bv, off);
        const int orow = __shfl_down_sync(TD_FULL_MASK, br, off);
        if (ov > bv || (ov == bv && orow < br)) {
          bv = ov;
          br = orow;
        }
      }
      if (lane == 0) {
        G.ridx = br;
        G.pivot = G.aug[br * width + k];
      }
    }
    __syncthreads();
    const int ridx = G.ridx;
    const float pv = G.pivot;
    const float pv_safe = pv == 0.0f ? 1.0f : pv;
    if (tid < m) G.factor[tid] = tid == ridx ? 0.0f : G.aug[tid * width + k] / pv_safe;
    __syncthreads();
    for (int q = tid; q < m * width; q += THREADS) {
      const int r = q / width, c = q % width;
      if (r != ridx) G.aug[q] = G.aug[q] - G.factor[r] * G.aug[ridx * width + c];
    }
    if (tid == 0) {
      G.used[ridx] = 1.0f;
      G.perm[k] = ridx;
      G.diag[k] = pv;
    }
    __syncthreads();
  }
  for (int q = tid; q < m * (m + 3); q += THREADS) {
    const int k = q / (m + 3), c = q % (m + 3);
    const float dg = fabsf(G.diag[k]) < 1e-30f ? 1.0f : G.diag[k];
    const int pr = G.perm[k];
    if (c < m) G.inv[k * m + c] = G.aug[pr * width + m + c] / dg;
    else w[k * 3 + c - m] = G.aug[pr * width + 2 * m + c - m] / dg;
  }
  __syncthreads();
  // Refinement: residual in FMA form against the unscaled system.
  for (int step = 0; step < 3; ++step) {
    for (int q = tid; q < m * 3; q += THREADS) {
      const int r = q / 3, d = q % 3;
      float acc = 0.0f;
      for (int j = 0; j < m; ++j) acc = fmaf(a[r * m + j], w[j * 3 + d], acc);
      G.r[q] = (b[q] - acc) / G.e[r];
    }
    __syncthreads();
    for (int q = tid; q < m * 3; q += THREADS) {
      const int r = q / 3, d = q % 3;
      float acc = 0.0f;
      for (int j = 0; j < m; ++j) acc = fmaf(G.inv[r * m + j], G.r[j * 3 + d], acc);
      w[q] = w[q] + acc;
    }
    __syncthreads();
  }
}

}  // namespace td
