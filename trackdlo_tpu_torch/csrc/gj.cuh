// The equilibrated Gauss-Jordan M-step solve of one (m, m) system with
// three right-hand sides, as block-wide device code in shared memory. Kernel
// E (em_loop.cu) runs it inside its EM loop, in every CTA of its cluster;
// kernel G (gj_solve.cu) runs it once per system.
//
// Replaces the solve of trackdlo_tpu/ops/pallas_kernels.py
// gauss_jordan_solve_batched (_batched_gj_kernel) and fused_em_loop's M-step
// (_gj2d_with_inv). The steps are theirs:
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
//
// What bounds it on an H100: the chain of m dependent pivot steps (~0.5
// MFLOP per system, far below any rate): per step a pivot search, the
// factors, one update and one barrier.
//
// Design, one barrier per step:
// - Every warp finds the pivot itself: a 32-bit key per candidate whose
//   integer order is the search's order (|a| by its bits, a used row below
//   every unused one, NaN below all), one __reduce_max_sync for the best key
//   and one __reduce_min_sync for its lowest row; the used rows stay in a
//   register mask.
// - The identity part is kept in pivot order: column m + k holds the
//   identity column of the row pivoted at step k, written at that step (it
//   was exact zeros and a one until then). The entries step k must update
//   are then always the contiguous columns k + 1 .. m + k (the A columns
//   after k and the identity columns pivoted so far) and the three B
//   columns; the pivot row's other identity entries are zeros, so skipping
//   them changes no value. Each thread owns fixed cells of that m x (m + 3)
//   block, their row and slot computed before the pivot loop.
// - An entry's update stays aug[r][c] - factor[r] * aug[p][c], a multiply
//   then a subtract under -fmad=false, with factor[r] = aug[r][k] / pivot, so
//   the solve gives the values of the full sweep in the original layout.
#pragma once

#include "common.cuh"

namespace td {

constexpr int GJ_MMAX = 48;
static_assert(GJ_MMAX <= 64, "the used rows live in a 64-bit mask");

struct GjSmem {
  float aug[GJ_MMAX * (2 * GJ_MMAX + 3)];  // [A/e | I in pivot order | B/e]
  float inv[GJ_MMAX * GJ_MMAX];
  float r[GJ_MMAX * 3];
  float e[GJ_MMAX], diag[GJ_MMAX];
  int perm[GJ_MMAX];  // the row pivoted at each step
  int pos[GJ_MMAX];   // the step at which each row was pivoted
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

// The pivot search's order as an unsigned key: a larger |a| wins (the bits
// of a non-negative float order as integers), a used row (which bids -1)
// loses to every unused one, and NaN never wins (it compares false).
__device__ __forceinline__ unsigned gj_pivot_key(float v, bool used) {
  if (used) return 1u;
  const float a = fabsf(v);
  return a == a ? __float_as_uint(a) + 2u : 0u;
}

// Solves A w = B for one system: ``a`` (m*m, row-major) and ``b`` (m*3)
// unscaled in shared memory; ``w`` (m*3) in shared memory is written. Every
// thread of the block calls it; it ends after a barrier.
template <int THREADS, GjScale RULE>
__device__ void gj_solve(int m, const float* a, const float* b, float* w, GjSmem& G) {
  constexpr int NWARPS = THREADS / 32;
  constexpr int NC = (GJ_MMAX * (GJ_MMAX + 3) + THREADS - 1) / THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int width = 2 * m + 3;
  const int act = m + 3;  // columns updated per step
  // Row scales, one warp per row (a maximum is exact in any order).
  for (int r = warp; r < m; r += NWARPS) {
    float d = 0.0f;
    for (int c = lane; c < m; c += 32) d = fmaxf(d, fabsf(a[r * m + c]));
    for (int off = 16; off > 0; off >>= 1) d = fmaxf(d, __shfl_xor_sync(TD_FULL_MASK, d, off));
    if (lane == 0) {
      G.e[r] = gj_row_scale<RULE>(d);
      G.pos[r] = 0;  // stays in bounds for a row never pivoted (an all-NaN column)
    }
  }
  __syncthreads();
  for (int r = warp; r < m; r += NWARPS) {
    const float er = G.e[r];
    for (int c = lane; c < width; c += 32) {
      float v;
      if (c < m) v = a[r * m + c] / er;
      else if (c < 2 * m) v = 0.0f;  // written when its row is pivoted
      else v = b[r * 3 + c - 2 * m] / er;
      G.aug[r * width + c] = v;
    }
  }
  // This thread's cells of the m x (m + 3) block of updated entries: row
  // and slot, fixed for the whole elimination (row -1: no cell).
  int cell_r[NC], cell_j[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int q = tid + i * THREADS;
    cell_r[i] = q < m * act ? q / act : -1;
    cell_j[i] = q < m * act ? q - (q / act) * act : 0;
  }
  unsigned long long used = 0ull;
  __syncthreads();
  for (int k = 0; k < m; ++k) {
    unsigned key = 0u;
    int row = m;
    for (int r = lane; r < m; r += 32) {
      const unsigned kr = gj_pivot_key(G.aug[r * width + k], (used >> r) & 1ull);
      if (kr > key) {
        key = kr;
        row = r;
      }
    }
    const unsigned best = __reduce_max_sync(TD_FULL_MASK, key);
    const int ridx =
        best == 0u ? m : (int)__reduce_min_sync(TD_FULL_MASK, key == best ? (unsigned)row : ~0u);
    const float pv = G.aug[ridx * width + k];
    const float pv_safe = pv == 0.0f ? 1.0f : pv;
    used |= 1ull << ridx;
    if (tid == 0) {
      G.perm[k] = ridx;
      if (ridx < m) G.pos[ridx] = k;
      G.diag[k] = pv;
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int r = cell_r[i];
      if (r < 0) continue;
      const int j = cell_j[i];
      const int c = j < m ? k + 1 + j : m + j;
      const bool fresh = j == m - 1;  // column m + k: the pivot row's identity column
      if (r == ridx) {
        if (fresh) G.aug[r * width + c] = 1.0f;
        continue;
      }
      const float f = G.aug[r * width + k] / pv_safe;
      const float x = fresh ? 0.0f : G.aug[r * width + c];
      const float y = fresh ? 1.0f : G.aug[ridx * width + c];
      G.aug[r * width + c] = x - f * y;
    }
    __syncthreads();
  }
  // inv[k] and w[k] from the row pivoted at step k, one warp per step.
  for (int k = warp; k < m; k += NWARPS) {
    const float dg = fabsf(G.diag[k]) < 1e-30f ? 1.0f : G.diag[k];
    const float* row = G.aug + G.perm[k] * width;
    for (int c = lane; c < m + 3; c += 32) {
      if (c < m) G.inv[k * m + c] = row[m + G.pos[c]] / dg;
      else w[k * 3 + c - m] = row[2 * m + c - m] / dg;
    }
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
