// The equilibrated Gauss-Jordan M-step solve of one (m, m) system with
// three right-hand sides, as block-wide device code in shared memory. Kernel
// E (em_loop.cu) runs it inside its EM loop, in every CTA of its cluster;
// kernel G (gj_solve.cu) runs it once per system.
//
// Replaces the solve of trackdlo_tpu/ops/pallas_kernels.py
// gauss_jordan_solve_batched (_batched_gj_kernel and its refinement) and
// fused_em_loop's M-step (_gj2d_with_inv and its refinement). The steps are
// theirs:
// - each row of A and B divided by a power of two near max|A_row| (exact:
//   only exponents change), by the rule of the TPU kernel being replaced
//   (GjScale below);
// - Gauss-Jordan on [A/e | I | B/e] with partial pivoting over the rows not
//   yet used, ties to the lowest row, no row swaps (pivot rows recorded in
//   perm); a zero pivot divides by 1;
// - w[k] = B_f[perm[k]] / pivot_k and inv[k] = I_f[perm[k]] / pivot_k, with
//   |pivot| < 1e-30 read as 1;
// - three refinement steps against the unscaled system:
//   w += inv ((B - A w) / e), the product A w as fused_em_loop takes it,
//   with _exact_dot (exact_split_dot below).
// Padded equations of the TPU function are identity rows that never mix
// with the real ones, so solving at m (not m_pad) gives the same steps.
//
// What bounds it on an H100: the chain of m dependent pivot steps (~0.5
// MFLOP per system, far below any rate). Each step is a pivot search, one
// factor per row, an update of the m + 3 live columns of every row and one
// barrier; its chain holds warp reductions, a shuffle, IEEE divisions and
// dependent shared-memory accesses, each far slower than its arithmetic
// (perf/em_phase_stamps.py: ~2,200 cycles a stamped step, of which the
// search warp's division and update of column k + 1 take ~560 and its pick
// ~550; the update warps are done after ~940 and wait).
//
// Design, one barrier per step:
// - The identity part is kept in pivot order: column m + k holds the
//   identity column of the row pivoted at step k, written at that step (it
//   was exact zeros and a one until then). The entries step k must update
//   are then always the m + 3 contiguous slots k + 1 .. m + k (the A
//   columns after k and the identity columns pivoted so far) and the three
//   B columns; the pivot row's other identity entries are zeros, so
//   skipping them changes no value.
// - The last warp is the search warp. At step k it updates slot 0 (column
//   k + 1) of every row, two rows a lane, keeping the values in registers,
//   then picks step k + 1's pivot among them: a 32-bit key per candidate
//   whose integer order is the search's order (|a| by its bits, a used row
//   below every unused one, NaN below all), one __reduce_max_sync for the
//   best key and one __reduce_min_sync for its lowest row. It publishes the
//   row and its value in shared memory, double-buffered by step parity,
//   before the step's barrier: the search runs once, not once per warp,
//   beside the other warps' update.
// - The other warps own the slots 1 .. m + 2 of the rows: a fixed group of
//   threads per row, so each thread divides its row's factor aug[r][k] /
//   pivot once per step (45 divisions a step where there were ~2,160) and
//   updates its slots, neighbouring threads on neighbouring columns. The
//   row stride is padded so that the rows a warp covers fall on distinct
//   banks.
// - An entry's update stays aug[r][c] - factor * aug[p][c], a multiply then
//   a subtract under -fmad=false, with the factor a true IEEE quotient, so
//   the solve gives the values of the full sweep in the original layout,
//   bit for bit the previous design's.
// Other layouts measured slower are listed in PERF.md (Findings).
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace td {

// The node bound MM is a compile-time parameter: GJ_MMAX (48) and
// GJ_MMAX_WIDE (128). The narrow layout keeps [A/e | I | B/e] and the
// inverse in GjSmem; the wide one (a 128-node [A | I | B] is ~145 KB) takes
// [A | I | B] from the caller, who may lend it memory that is free during
// the solve, and reads the inverse from it where the refinement needs it
// (the same quotient, so the same bits).
constexpr int GJ_MMAX = 48;
constexpr int GJ_MMAX_WIDE = 128;
// The widest row: 2 m + 3 entries, padded by at most 31.
__host__ __device__ constexpr int gj_wmax(int mm) { return 2 * mm + 3 + 31; }

// The small per-system state of the solve.
template <int MM>
struct GjState {
  float r[MM * 3];
  float e[MM], diag[MM];
  int perm[MM];  // the row pivoted at each step
  int pos[MM];   // the step at which each row was pivoted
  int piv_row[2];  // a step's pivot row and value, by step parity
  float piv_val[2];
};

template <int MM, bool OWN = (MM <= GJ_MMAX)>
struct GjSmem : GjState<MM> {
  static constexpr int kMM = MM;
  float aug[MM * gj_wmax(MM)];  // [A/e | I in pivot order | B/e], row stride gj_stride
  float inv[MM * MM];
};
template <int MM>
struct GjSmem<MM, false> : GjState<MM> {
  static constexpr int kMM = MM;
};

// The rows used as pivots so far, one bit a row.
template <int MM>
struct GjRows {
  static constexpr int kWords = (MM + 63) / 64;
  unsigned long long w[kWords];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0ull;
  }
  __device__ __forceinline__ bool has(int r) const { return (w[r >> 6] >> (r & 63)) & 1ull; }
  __device__ __forceinline__ void add(int r) {
    if (r < 64 * kWords) w[r >> 6] |= 1ull << (r & 63);
  }
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

// The product A w in the refinement's residual B - A w. On the live
// pre-registration systems (cond ~2e6) A w cancels B to ~1e-5 of |A||w|: a
// float32 product there leaves an error in the residual larger than the
// residual itself, and the three steps move w away from the solution (ten
// times further from float64 than the elimination's own w; the EM then
// takes extra trips, ROADMAP fault 1, perf/port_em_probes.py phases).
// fused_em_loop (pallas_kernels.py:1364) takes it with _exact_dot (:1152):
// both operands split into three bfloat16 pieces, the nine piece products
// (each exact in float32) summed over the columns in float32 and the nine
// sums added in order. Both kernels take it so (gauss_jordan_solve_batched
// takes a float32 product at :1128; it serves the same EM).

// v as _exact_dot's split3 (pallas_kernels.py:1158-1163) cuts it: hi the
// nearest bfloat16 of v, mid that of v - hi, lo that of v - hi - mid.
__device__ __forceinline__ void split3(float v, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(v));
  const float r1 = v - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r1));
  lo = __bfloat162float(__float2bfloat16_rn(r1 - mid));
}

// The pieces of v[0..n) into sp: hi at sp[i], mid at sp[n + i], lo at
// sp[2 n + i]; block-strided, no barrier.
template <int THREADS>
__device__ __forceinline__ void split3_all(int n, const float* v, float* sp) {
  for (int i = threadIdx.x; i < n; i += THREADS) split3(v[i], sp[i], sp[n + i], sp[2 * n + i]);
}

// A (rows, k) row-major with its pieces stored by split3_all of n floats.
struct SplitPieces {
  const float* sp;
  int n, k;
  __device__ __forceinline__ void get(int r, int j, float (&p)[3]) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = sp[i * n + r * k + j];
  }
};

// A (rows, k) row-major in memory, its pieces cut where they are read.
struct SplitOnRead {
  const float* a;
  int k;
  __device__ __forceinline__ void get(int r, int j, float (&p)[3]) const {
    split3(a[r * k + j], p[0], p[1], p[2]);
  }
};

// Entry (r, d) of _exact_dot(A, W) for A (rows, k) and W (k, 3), from
// their pieces (A's from ``pa_src``, W's by split3_all of n_w floats): for
// each piece pair in the order (hi, hi), (hi, mid), .., (lo, lo) the sum
// over j in order of the exact products, then the nine sums added in that
// order. With COMPENSATED the nine sums over j are compensated (Kahan)
// sums: a float32 running sum of k exact products of size ~|A||W| leaves
// an error growing with k, which past 128 nodes sets the floor of the
// refinement and of T (the unbounded build, unbounded.cuh).
template <bool COMPENSATED = false, class PA>
__device__ __forceinline__ float exact_split_dot(int k, const PA& pa_src, int r, const float* wsp,
                                                 int n_w, int d) {
  float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float cmp[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < k; ++j) {
    float pa[3], pw[3];
    pa_src.get(r, j, pa);
#pragma unroll
    for (int p = 0; p < 3; ++p) pw[p] = wsp[p * n_w + j * 3 + d];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        if (COMPENSATED) td_kahan_add(acc[i * 3 + l], cmp[i * 3 + l], pa[i] * pw[l]);
        else acc[i * 3 + l] = fmaf(pa[i], pw[l], acc[i * 3 + l]);
      }
  }
  float out = acc[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) out = out + acc[i];
  return out;
}

// The pivot search's order as an unsigned key: a larger |a| wins (the bits
// of a non-negative float order as integers), a used row (which bids -1)
// loses to every unused one, and NaN never wins (it compares false).
__device__ __forceinline__ unsigned gj_pivot_key(float v, bool used) {
  if (used) return 1u;
  const float a = fabsf(v);
  return a == a ? __float_as_uint(a) + 2u : 0u;
}

// Threads per row of the update warps (all warps but the last).
__host__ __device__ constexpr int gj_per_row(int threads, int m) { return (threads - 32) / m; }

// The most slots (1 .. m + 2) one update thread owns, over every m <= mm.
__host__ __device__ constexpr int gj_slots(int threads, int mm) {
  int most = 0;
  for (int m = 1; m <= mm; ++m) {
    const int per = gj_per_row(threads, m);
    const int s = (m + 2 + per - 1) / per;
    most = s > most ? s : most;
  }
  return most;
}

// The row stride: at least 2 m + 3 and equal to the threads per row modulo
// 32, so the consecutive rows of one warp start on consecutive banks.
__host__ __device__ constexpr int gj_stride(int m, int per_row) {
  const int w = 2 * m + 3;
  return w + (((per_row - w) % 32) + 32) % 32;
}

// The search warp's pick among its rows' values (row lane + 32 h in v[h]):
// the row step k + 1 pivots on (m when every unused candidate is NaN and no
// row is used) and, in every lane, its value.
template <int RPL, int MM>
__device__ __forceinline__ int gj_pick(int m, const GjRows<MM>& used, const float (&v)[RPL],
                                       float& pv) {
  const int lane = threadIdx.x & 31;
  unsigned key = 0u;
  int row = m;
#pragma unroll
  for (int h = 0; h < RPL; ++h) {
    const int r = lane + 32 * h;
    if (r < m) {
      const unsigned kr = gj_pivot_key(v[h], used.has(r));
      if (kr > key) {
        key = kr;
        row = r;
      }
    }
  }
  const unsigned best = __reduce_max_sync(TD_FULL_MASK, key);
  const int ridx =
      best == 0u ? m : (int)__reduce_min_sync(TD_FULL_MASK, key == best ? (unsigned)row : ~0u);
  float mine = v[0];
#pragma unroll
  for (int h = 1; h < RPL; ++h)
    if ((ridx >> 5) == h) mine = v[h];
  const float got = __shfl_sync(TD_FULL_MASK, mine, ridx & 31);
  pv = ridx < m ? got : __int_as_float(0x7fffffff);
  return ridx;
}

// A in shared memory (m*m, row-major) with its pieces by split3_all.
struct DenseA {
  const float* a;
  SplitPieces pcs;
  int m;
  __device__ __forceinline__ float value(int r, int c) const { return a[r * m + c]; }
  __device__ __forceinline__ void get(int r, int j, float (&p)[3]) const { pcs.get(r, j, p); }
};

// Three refinement steps of w against the unscaled system A w = B:
// w += inv ((B - A w) / e), A w by exact_split_dot; ``inv(k, c)`` gives an
// entry of the inverse. Every thread of the block calls it; it ends after a
// barrier.
template <int THREADS, class AM, class GS, class INV>
__device__ void gj_refine(int m, const AM& A, const float* b, float* w, GS& G, float* w_split,
                          INV inv) {
  const int tid = threadIdx.x;
  for (int step = 0; step < 3; ++step) {
    split3_all<THREADS>(m * 3, w, w_split);
    __syncthreads();
    for (int q = tid; q < m * 3; q += THREADS) {
      const int r = q / 3, d = q % 3;
      const float acc = exact_split_dot(m, A, r, w_split, m * 3, d);
      G.r[q] = (b[q] - acc) / G.e[r];
    }
    __syncthreads();
    for (int q = tid; q < m * 3; q += THREADS) {
      const int r = q / 3, d = q % 3;
      float acc = 0.0f;
      for (int j = 0; j < m; ++j) acc = fmaf(inv(r, j), G.r[j * 3 + d], acc);
      w[q] = w[q] + acc;
    }
    __syncthreads();
  }
}

// Solves A w = B for one system: ``A`` an accessor of the unscaled matrix
// (``value(r, c)`` and its split3 pieces ``get(r, c, p)``, DenseA for one in
// shared memory), ``b`` (m*3) unscaled in shared memory; ``w`` (m*3) in
// shared memory is written, and ``w_split`` (3*m*3 floats of shared memory)
// holds w's pieces during the refinement. ``aug`` is shared memory for
// [A/e | I | B/e], m rows of gj_stride(m, gj_per_row(THREADS, m)) floats
// (the narrow layout passes G.aug). Every thread of the block calls it; it
// ends after a barrier.
template <int THREADS, GjScale RULE, class AM, int MM, bool OWN>
__device__ void gj_solve(int m, const AM& A, const float* b, float* w, GjSmem<MM, OWN>& G,
                         float* aug, float* w_split) {
  constexpr int NWARPS = THREADS / 32;
  constexpr int NC = gj_slots(THREADS, MM);
  constexpr int RPL = (MM + 31) / 32;  // the search warp's rows a lane
  static_assert(THREADS >= 256 && THREADS % 32 == 0, "the update warps need 224 threads");
  static_assert(MM <= THREADS - 32, "an update thread per row");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool searcher = warp == NWARPS - 1;
  const int per_row = gj_per_row(THREADS, m);
  const int width = gj_stride(m, per_row);
  const int act = m + 3;  // slots updated per step
  // Row scales, one warp per row (a maximum is exact in any order).
  for (int r = warp; r < m; r += NWARPS) {
    float d = 0.0f;
    for (int c = lane; c < m; c += 32) d = fmaxf(d, fabsf(A.value(r, c)));
    for (int off = 16; off > 0; off >>= 1) d = fmaxf(d, __shfl_xor_sync(TD_FULL_MASK, d, off));
    if (lane == 0) {
      G.e[r] = gj_row_scale<RULE>(d);
      G.pos[r] = 0;  // stays in bounds for a row never pivoted (an all-NaN column)
    }
  }
  __syncthreads();
  for (int r = warp; r < m; r += NWARPS) {
    const float er = G.e[r];
    for (int c = lane; c < 2 * m + 3; c += 32) {
      float v;
      if (c < m) v = A.value(r, c) / er;
      else if (c < 2 * m) v = 0.0f;  // written when its row is pivoted
      else v = b[r * 3 + c - 2 * m] / er;
      aug[r * width + c] = v;
    }
  }
  __syncthreads();
  // The search warp's rows (lane + 32 h) and the values of their current
  // column; an update thread's row (-1: none) and first slot.
  float col[RPL];
#pragma unroll
  for (int h = 0; h < RPL; ++h) col[h] = 0.0f;
  GjRows<MM> used;
  used.clear();
  const int my_r = !searcher && tid < per_row * m ? tid / per_row : -1;
  const int my_g = tid - my_r * per_row;
  if (searcher) {
#pragma unroll
    for (int h = 0; h < RPL; ++h) {
      const int r = lane + 32 * h;
      if (r < m) col[h] = aug[r * width];
    }
    float pv;
    const int ridx = gj_pick(m, used, col, pv);
    used.add(ridx);
    if (lane == 0) {
      G.piv_row[0] = ridx;
      G.piv_val[0] = pv;
      G.perm[0] = ridx;
      if (ridx < m) G.pos[ridx] = 0;
      G.diag[0] = pv;
    }
  }
  __syncthreads();
  for (int k = 0; k < m; ++k) {
    const int p = G.piv_row[k & 1];
    const float pv = G.piv_val[k & 1];
    const float pv_safe = pv == 0.0f ? 1.0f : pv;
    if (searcher) {
      // Slot 0, column k + 1 (the fresh identity column when m == 1).
      const int c = k + 1;
      const bool fresh = m == 1;
      float nxt[RPL];
#pragma unroll
      for (int h = 0; h < RPL; ++h) {
        nxt[h] = 0.0f;
        const int r = lane + 32 * h;
        if (r >= m) continue;
        if (r == p) {
          if (fresh) aug[r * width + c] = 1.0f;
          nxt[h] = aug[r * width + c];
          continue;
        }
        const float f = col[h] / pv_safe;
        const float x = fresh ? 0.0f : aug[r * width + c];
        const float y = fresh ? 1.0f : aug[p * width + c];
        nxt[h] = x - f * y;
        aug[r * width + c] = nxt[h];
      }
#pragma unroll
      for (int h = 0; h < RPL; ++h) col[h] = nxt[h];
      if (k + 1 < m) {
        float pvn;
        const int ridx = gj_pick(m, used, col, pvn);
        used.add(ridx);
        if (lane == 0) {
          G.piv_row[(k + 1) & 1] = ridx;
          G.piv_val[(k + 1) & 1] = pvn;
          G.perm[k + 1] = ridx;
          if (ridx < m) G.pos[ridx] = k + 1;
          G.diag[k + 1] = pvn;
        }
      }
    } else if (my_r >= 0) {
      const int r = my_r;
      float* row = aug + r * width;
      const float* prow = aug + p * width;
      if (r == p) {
        // The pivot row keeps its values; its fresh identity entry is 1.
        const int j = m - 1;
        if (j >= 1 && (j - 1) % per_row == my_g) row[m + k] = 1.0f;
      } else {
        const float f = row[k] / pv_safe;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int j = 1 + my_g + i * per_row;
          if (j < act) {
            const int c = j < m ? k + 1 + j : m + j;
            const bool fresh = j == m - 1;  // column m + k: the pivot row's identity column
            const float x = fresh ? 0.0f : row[c];
            const float y = fresh ? 1.0f : prow[c];
            row[c] = x - f * y;
          }
        }
      }
    }
    __syncthreads();
  }
  // w[k] (and, in the narrow layout, inv[k]) from the row pivoted at step k,
  // one warp per step (NaN where no row was: every candidate of column 0 was
  // NaN).
  const float nan = __int_as_float(0x7fffffff);
  for (int k = warp; k < m; k += NWARPS) {
    const float dg = fabsf(G.diag[k]) < 1e-30f ? 1.0f : G.diag[k];
    const int pr = G.perm[k];
    const float* row = aug + (pr < m ? pr : 0) * width;
    for (int c = lane; c < m + 3; c += 32) {
      if (c < m) {
        if constexpr (OWN) G.inv[k * m + c] = pr < m ? row[m + G.pos[c]] / dg : nan;
      } else {
        w[k * 3 + c - m] = pr < m ? row[2 * m + c - m] / dg : nan;
      }
    }
  }
  __syncthreads();
  if constexpr (OWN) {
    // Refinement against the unscaled system, the inverse from G.inv.
    gj_refine<THREADS>(m, A, b, w, G, w_split, [&](int k, int c) { return G.inv[k * m + c]; });
  } else {
    // The same refinement, each entry of the inverse read from [A | I | B]
    // (the quotient the narrow layout stores).
    gj_refine<THREADS>(m, A, b, w, G, w_split, [&](int k, int c) {
      const float dg = fabsf(G.diag[k]) < 1e-30f ? 1.0f : G.diag[k];
      const int pr = G.perm[k];
      return pr < m ? aug[pr * width + m + G.pos[c]] / dg : nan;
    });
  }
}

}  // namespace td
