// The node-unbounded builds of kernels E, S, F and G: device code for any
// number of nodes m, with every node-indexed array in a global workspace
// that the wrapper allocates (one torch.empty a launch, in a CUDA graph's
// pool when captured). The narrow and wide builds keep a node bound fixed
// at compile time (48 and 128 nodes, estep_cluster.cuh and gj.cuh) and stay
// the launch wherever m fits them.
//
// What bounds it on an H100: the M-step. The solve's [A | I | B] is
// m (2m + 3) floats (0.5 MB at 256 nodes, 2.1 MB at 512, 8.4 MB at 1,024),
// past a CTA's 227 KB and, from 512 nodes, past a whole 8-CTA cluster's
// shared memory, so it lives in global memory (L2: 50 MB) and every pivot
// step is a cluster barrier and m (m + 3) / C reads and writes of L2 per
// CTA. The E-step is (m, n) exponentials, a few per pair.
//
// Design, one thread-block cluster of C CTAs per stream or system:
// - E-step (ecu_*): each CTA takes its rows a tile of EC_PMAX at a time,
//   compacted into shared memory in row order. A warp per point walks the
//   nodes lane, lane + 32, .. for the two normalisations (per-lane sums in
//   node order, then a butterfly: every lane the same bits), the first
//   argmax (ties to the lowest node) and the anchors, and keeps each
//   point's anchors and second normaliser; then a thread per node sums its
//   memberships over the tile's points in point order (recomputing them:
//   the same operations, so the same values), running sums in float64
//   carried from tile to tile, and so the CTAs' partials, the cluster's
//   totals and the sigma^2 traces: sigma^2 is the traces' difference, ~1e-5
//   of their size on a 256-node cable 1.2 m from the camera, where float32
//   sums (even compensated) left sigma^2 2.7% off and the pass drifting
//   (H100, perf/unbounded_probes.py cable). The M-step takes P1 and PX
//   rounded to float32.
//   The node minima likewise, a thread per node.
// - The cluster exchange goes through global memory: each CTA writes its
//   partial sums and minima into its own slot, a fence and a cluster
//   barrier publish them, and every reader adds the CTAs' slots in rank
//   order (L2 reads, __ldcg, never a stale L1 line).
// - The solve (gjc_solve): CTA r owns rows r, r + C, ... of [A | I | B]
//   (or kernel F's [A | B]). A pivot step is: each CTA's best candidate of
//   the column among its rows (gj_pivot_key's order, ties to the lowest
//   row) pushed into its shared memory, one cluster barrier, every CTA
//   reading all C candidates over distributed shared memory (the same pick
//   in every CTA), then each CTA eliminating its own rows against the pivot
//   row, staged from L2 into shared memory. The identity columns are kept in
//   pivot order as in gj.cuh, so a step updates the m + 3 live slots of a
//   row. An entry's update is x - f y (a multiply then a subtract under
//   -fmad=false), f a true IEEE quotient, divided once a row.
// - The inverse is read from [A | I | B] where the refinement needs it, the
//   refinement's residual and T's G W taken as B1's _exact_dot (gj.cuh).
//   Past 128 nodes the elimination of kernels E and G runs in float64 and
//   both products sum their exact piece products with compensation: on a
//   256-node pre-registration system (cond 4.5e6) the float32 elimination's
//   inverse is too coarse for three refinement steps (T = Y0 + G W, which
//   cancels W's entries of ~400, stayed 2.7e-4 m from float64 where an LU
//   solve leaves 1.3e-5 m, and 3.1e-4 m after ten steps with float32 sums;
//   H100, perf/unbounded_probes.py solve), float32 sums of 256 exact
//   products setting a floor of that order; with a float64 elimination
//   three steps leave 8.2e-6 m (perf/unbounded_probes.py emulate). Kernel
//   F's one-hot elimination stays float32, as B10's.
// No float atomics: a result is the same run to run, and depends on n and
// m alone, never on the batch or the card.
#pragma once

#include <climits>

#include "estep_cluster.cuh"
#include "gj.cuh"

namespace td {

// The node count from which a launch takes the unbounded build.
constexpr int UB_MMIN = EC_MMAX_WIDE + 1;
// Live slots of the pivot row staged in shared memory at a time.
constexpr int UB_PCHUNK = 2048;

// An unbounded launch's cluster: always EC_MAX_CLUSTER CTAs (the solve's
// pivot steps spread over as many SMs as a portable cluster has), the rows
// split evenly; a function of n alone, as the bounded builds'.
__host__ __device__ inline int ub_rows_per_cta(int n) {
  return (n + EC_MAX_CLUSTER - 1) / EC_MAX_CLUSTER;
}

__device__ __forceinline__ float ub_nan() { return __int_as_float(0x7fffffff); }

// Publishes this thread's global writes to the cluster: a fence, then a
// barrier of every thread of every CTA (arrive.release, wait.acquire).
__device__ __forceinline__ void ub_cluster_publish(cg::cluster_group& cluster) {
  __threadfence();
  cluster.sync();
}

// ---------------------------------------------------------------------------
// The E-step.
// ---------------------------------------------------------------------------

// Shared memory of the unbounded E-step: one tile of compacted points and
// each point's anchors and second normaliser.
template <int THREADS>
struct EcuSmem {
  static constexpr int kWarps = THREADS / 32;
  float xs[EC_PMAX * 3];
  float den2[EC_PMAX], d_lo[EC_PMAX], d_hi[EC_PMAX], c_lo[EC_PMAX], c_hi[EC_PMAX];
  float pt1[EC_PMAX];
  int lo[EC_PMAX], hi[EC_PMAX];
  int wcount[kWarps];
};

// One stream's nodes in global memory. Rows past m (up to the anchor
// select's sel_rows) are the TPU's zero pad rows.
struct EcuNodes {
  const float* y;      // (m, 3)
  const float* coord;  // (m,)
  const float* nm;     // (m,) 0/1
  const float* pv;     // (m,) visibility weights
  int m;
  __device__ __forceinline__ float sq(int j, float x0, float x1, float x2) const {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    if (j < m) {
      a0 = y[j * 3];
      a1 = y[j * 3 + 1];
      a2 = y[j * 3 + 2];
    }
    const float d0 = a0 - x0, d1 = a1 - x1, d2 = a2 - x2;
    return d0 * d0 + d1 * d1 + d2 * d2;
  }
  __device__ __forceinline__ float crd(int j) const { return j < m ? coord[j] : 0.0f; }
  __device__ __forceinline__ bool on(int j) const { return nm[j] > 0.0f; }
};

template <bool MUL_EXPONENT>
__device__ __forceinline__ float ecu_expo(const EcScalars& sc, float d) {
  return MUL_EXPONENT ? d * sc.neg_half_inv_s2 : -0.5f * d / sc.s2;
}

// The second pass's membership of node j (valid) for a point with anchors
// lo, hi: the geodesic re-distance, the exponential, the visibility prior
// (estep_cluster.cuh's operations).
template <bool MUL_EXPONENT, bool GATE_BLEND>
__device__ __forceinline__ float ecu_e2(const EcScalars& sc, const EcuNodes& N, int j, int lo,
                                        int hi, float d_lo, float d_hi, float c_lo, float c_hi) {
  float geo;
  if (j < lo) {
    const float u = fabsf(N.coord[j] - c_lo) + d_lo;
    geo = u * u;
  } else if (j >= hi) {
    const float u = fabsf(N.coord[j] - c_hi) + d_hi;
    geo = u * u;
  } else if (j == lo) {
    geo = d_lo * d_lo;
  } else {
    geo = 0.0f;
  }
  float v = expf(ecu_expo<MUL_EXPONENT>(sc, geo));
  if (GATE_BLEND) {
    v = v * (1.0f + sc.gate * (N.pv[j] - 1.0f));
  } else if (sc.gate > 0.0f) {
    v = v * N.pv[j];
  }
  return v;
}

// A warp per point of the tile: the first normalisation, the first argmax
// and the anchors, the second normaliser and the point's total membership,
// into U. Ends in a barrier.
template <int THREADS, bool MUL_EXPONENT, bool GATE_BLEND>
__device__ void ecu_points(const EcScalars& sc, const EcuNodes& N, int npts, EcuSmem<THREADS>& U) {
  constexpr int NW = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = sc.m;
  for (int i = warp; i < npts; i += NW) {
    const float x0 = U.xs[i * 3], x1 = U.xs[i * 3 + 1], x2 = U.xs[i * 3 + 2];
    float sum1 = 0.0f;
    for (int j = lane; j < m; j += 32)
      if (N.on(j)) sum1 += expf(ecu_expo<MUL_EXPONENT>(sc, N.sq(j, x0, x1, x2)));
    const float den1 = td_warp_allsum(sum1) + sc.c_plain;
    // First argmax of the normalised memberships, ties to the lowest node.
    float best = -1.0f;
    int mp = INT_MAX;
    for (int j = lane; j < m; j += 32) {
      const float q =
          N.on(j) ? expf(ecu_expo<MUL_EXPONENT>(sc, N.sq(j, x0, x1, x2))) / den1 : -1.0f;
      if (q > best) {
        best = q;
        mp = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(TD_FULL_MASK, best, off);
      const int oj = __shfl_xor_sync(TD_FULL_MASK, mp, off);
      if (ob > best || (ob == best && oj < mp)) {
        best = ob;
        mp = oj;
      }
    }
    if (mp >= m) mp = 0;  // no node beat -1: row 0, as the plain version
    const int cand1 = (mp - 1 == -1) ? 2 : mp - 1;
    const int cand2 = (mp + 1 == sc.v_count) ? sc.v_count - 3 : mp + 1;
    auto sel_sq = [&](int r) {
      return (r >= 0 && r < sc.sel_rows) ? N.sq(r, x0, x1, x2) : 0.0f;
    };
    auto sel_coord = [&](int r) { return (r >= 0 && r < sc.sel_rows) ? N.crd(r) : 0.0f; };
    const int nxt = sel_sq(cand1) < sel_sq(cand2) ? cand1 : cand2;
    const int lo = min(mp, nxt), hi = max(mp, nxt);
    const float d_lo = sqrtf(sel_sq(lo)), d_hi = sqrtf(sel_sq(hi));
    const float c_lo = sel_coord(lo), c_hi = sel_coord(hi);
    float sum2 = 0.0f;
    for (int j = lane; j < m; j += 32)
      if (N.on(j))
        sum2 += ecu_e2<MUL_EXPONENT, GATE_BLEND>(sc, N, j, lo, hi, d_lo, d_hi, c_lo, c_hi);
    const float den2 = td_warp_allsum(sum2) + sc.c_eff;
    float pt1 = 0.0f;
    for (int j = lane; j < m; j += 32) {
      const bool on = N.on(j);
      const float v =
          on ? ecu_e2<MUL_EXPONENT, GATE_BLEND>(sc, N, j, lo, hi, d_lo, d_hi, c_lo, c_hi) : 0.0f;
      pt1 += GATE_BLEND ? (on ? v / den2 : 0.0f) : v / den2;
    }
    pt1 = td_warp_allsum(pt1);
    if (lane == 0) {
      U.den2[i] = den2;
      U.lo[i] = lo;
      U.hi[i] = hi;
      U.d_lo[i] = d_lo;
      U.d_hi[i] = d_hi;
      U.c_lo[i] = c_lo;
      U.c_hi[i] = c_hi;
      U.pt1[i] = pt1;
    }
  }
  __syncthreads();
}

// A thread per node: the tile's memberships added in point order to this
// CTA's float64 running sums ``part`` = [P1 (m) | PX0 (m) | PX1 (m) | PX2
// (m) | Np | trace] in global memory. Ends in a barrier.
template <int THREADS, bool MUL_EXPONENT, bool GATE_BLEND>
__device__ void ecu_node_sums(const EcScalars& sc, const EcuNodes& N, int npts,
                              const EcuSmem<THREADS>& U, double* part) {
  const int m = sc.m;
  for (int j = threadIdx.x; j < m; j += THREADS) {
    double a0 = part[j], a1 = part[m + j], a2 = part[2 * m + j], a3 = part[3 * m + j];
    const bool on = N.on(j);
    for (int i = 0; i < npts; ++i) {
      const float v = on ? ecu_e2<MUL_EXPONENT, GATE_BLEND>(sc, N, j, U.lo[i], U.hi[i], U.d_lo[i],
                                                             U.d_hi[i], U.c_lo[i], U.c_hi[i])
                         : 0.0f;
      const float q = GATE_BLEND ? (on ? v / U.den2[i] : 0.0f) : v / U.den2[i];
      a0 += (double)q;
      a1 += (double)q * (double)U.xs[i * 3];
      a2 += (double)q * (double)U.xs[i * 3 + 1];
      a3 += (double)q * (double)U.xs[i * 3 + 2];
    }
    part[j] = a0;
    part[m + j] = a1;
    part[2 * m + j] = a2;
    part[3 * m + j] = a3;
  }
  if (threadIdx.x == THREADS - 1) {
    double np_sum = part[4 * m], tr = part[4 * m + 1];
    for (int i = 0; i < npts; ++i) {
      const double x0 = U.xs[i * 3], x1 = U.xs[i * 3 + 1], x2 = U.xs[i * 3 + 2];
      np_sum += (double)U.pt1[i];
      tr += (double)U.pt1[i] * (x0 * x0 + x1 * x1 + x2 * x2);
    }
    part[4 * m] = np_sum;
    part[4 * m + 1] = tr;
  }
  __syncthreads();
}

// The E-step's sums over this CTA's rows [r0, r1) of x, a tile at a time,
// into ``part`` (this CTA's float64 slot, zeroed first). Ends in a barrier.
template <int THREADS, bool MUL_EXPONENT, bool GATE_BLEND>
__device__ void ecu_partials(const EcScalars& sc, const EcuNodes& N, const float* x,
                             const float* xm, int r0, int r1, EcuSmem<THREADS>& U, double* part) {
  for (int t = threadIdx.x; t < 4 * sc.m + 2; t += THREADS) part[t] = 0.0;
  __syncthreads();
  for (int t0 = r0; t0 < r1; t0 += EC_PMAX) {
    const int npts = ec_compact(x, xm, t0, min(r1, t0 + EC_PMAX), U);
    ecu_points<THREADS, MUL_EXPONENT, GATE_BLEND>(sc, N, npts, U);
    ecu_node_sums<THREADS, MUL_EXPONENT, GATE_BLEND>(sc, N, npts, U, part);
  }
}

// Each valid node's minimum squared distance over the valid points of rows
// [r0, r1) into ``mn`` (this CTA's slot; 1e5 where none). Ends in a barrier.
template <int THREADS>
__device__ void ecu_minima(const EcuNodes& N, const float* x, const float* xm, int r0, int r1,
                           EcuSmem<THREADS>& U, float* mn) {
  for (int j = threadIdx.x; j < N.m; j += THREADS) mn[j] = EC_BIG;
  __syncthreads();
  for (int t0 = r0; t0 < r1; t0 += EC_PMAX) {
    const int npts = ec_compact(x, xm, t0, min(r1, t0 + EC_PMAX), U);
    for (int j = threadIdx.x; j < N.m; j += THREADS) {
      if (!N.on(j)) continue;
      float v = mn[j];
      for (int i = 0; i < npts; ++i) v = fminf(v, N.sq(j, U.xs[i * 3], U.xs[i * 3 + 1], U.xs[i * 3 + 2]));
      mn[j] = v;
    }
  }
  __syncthreads();
}

// The cluster's minima: the minimum over the C CTAs' slots (stride m) of
// each node, into ``gmin``. Call after ub_cluster_publish. Ends in a barrier.
template <int THREADS>
__device__ void ecu_cluster_minima(int m, int c, const float* slots, float* gmin) {
  for (int j = threadIdx.x; j < m; j += THREADS) {
    float v = EC_BIG;
    for (int r = 0; r < c; ++r) v = fminf(v, __ldcg(slots + (size_t)r * m + j));
    gmin[j] = v;
  }
  __syncthreads();
}

// The cluster's totals: the C CTAs' float64 partial sums (stride 4 m + 2)
// added in rank order, into ``tot`` and, rounded, ``tot32``. Call after
// ub_cluster_publish. Ends in a barrier.
template <int THREADS>
__device__ void ecu_cluster_totals(int m, int c, const double* slots, double* tot, float* tot32) {
  const size_t stride = 4 * (size_t)m + 2;
  for (int t = threadIdx.x; t < 4 * m + 2; t += THREADS) {
    double s = __ldcg(slots + t);
    for (int r = 1; r < c; ++r) s += __ldcg(slots + r * stride + t);
    tot[t] = s;
    tot32[t] = (float)s;
  }
  __syncthreads();
}

// The sigma^2 update and the mean node move from the totals ``tot`` (P1,
// PX in float64), T and the iterate y (m, 3), in warp 0 (rows lane, lane +
// 32, .. a lane, then butterflies): sigma^2 from its traces' difference in
// float64, floored at 1e-10; the move in float32 as the bounded builds.
// Returns (sigma^2, the summed move) in lane 0.
__device__ __forceinline__ void ecu_sigma2(int m, const double* tot, const float* t, const float* y,
                                           const float* nm, float& s2_out, float& move_out) {
  const int lane = threadIdx.x & 31;
  double tr_pxt = 0.0, tr_tt = 0.0;
  float move = 0.0f;
  for (int r = lane; r < m; r += 32) {
    float mv = 0.0f;
    for (int d = 0; d < 3; ++d) {
      const double tv = t[r * 3 + d];
      tr_pxt += tot[(1 + d) * m + r] * tv;
      tr_tt += tot[r] * tv * tv;
      const float dm = t[r * 3 + d] - y[r * 3 + d];
      mv += dm * dm;
    }
    move += sqrtf(mv) * nm[r];
  }
  for (int off = 16; off > 0; off >>= 1) {
    tr_pxt += __shfl_xor_sync(TD_FULL_MASK, tr_pxt, off);
    tr_tt += __shfl_xor_sync(TD_FULL_MASK, tr_tt, off);
  }
  move = td_warp_allsum(move);
  const double num = tot[4 * m + 1] - 2.0 * tr_pxt + tr_tt;
  const double den = (double)fmaxf((float)tot[4 * m] * 3.0f, 1e-30f);
  s2_out = fmaxf((float)(num / den), 1e-10f);
  move_out = move;
}

// Visibility weights from the minima, in warp 0: exp(-k_vis d) with d = 0
// within tau, 0 for masked nodes, over their sum (per-lane sums over nodes
// lane, lane + 32, .., then a butterfly; floored at 1e-30). Ends in a
// barrier.
__device__ inline void ecu_visibility_weights(int m, float k_vis, float tau_vis, const float* gmin,
                                              const float* nm, float* pv) {
  if (threadIdx.x < 32) {
    auto w = [&](int j) {
      float sh = sqrtf(gmin[j]);
      if (sh <= tau_vis) sh = 0.0f;
      return nm[j] > 0.0f ? expf(-k_vis * sh) : 0.0f;
    };
    float lane_sum = 0.0f;
    for (int j = threadIdx.x; j < m; j += 32) lane_sum = lane_sum + w(j);
    const float total = fmaxf(td_warp_allsum(lane_sum), 1e-30f);
    for (int j = threadIdx.x; j < m; j += 32) pv[j] = w(j) / total;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The cluster solve.
// ---------------------------------------------------------------------------

// Shared memory of the cluster solve on elements of type T: each step's
// candidate (by step parity, read by the other CTAs), the warps'
// candidates, a chunk of the pivot row. The factors and used flags of the
// CTA's rows follow in the dynamic tail (ub_solve_tail_bytes).
template <int THREADS, class T>
struct GjcSmem {
  unsigned long long cand_key[2];
  int cand_row[2];
  T cand_val[2];
  unsigned long long red_key[THREADS / 32];
  int red_row[THREADS / 32];
  T prow[UB_PCHUNK];
};

// The rows rank, rank + c, .. of m.
__host__ __device__ inline int ub_own_rows(int m, int c, int rank) {
  return rank < m ? (m - rank + c - 1) / c : 0;
}

template <class T>
__host__ __device__ inline size_t ub_solve_tail_bytes(int m, int c) {
  return (size_t)ub_own_rows(m, c, 0) * (sizeof(T) + sizeof(int));
}

// The solve's per-CTA record of the steps (in global memory, the same in
// every CTA): the row pivoted at each step, the step at which each row was,
// and each step's pivot value.
template <class T>
struct GjcRecord {
  int* perm;
  int* pos;
  T* diag;
};

// gj_pivot_key's order on a 64-bit key, for float and double values alike
// (a float widens to the double of the same value, so a float system keeps
// its order): a larger |a| wins, a used row (1) loses to every unused one,
// NaN (0) never wins.
template <class T>
__device__ __forceinline__ unsigned long long gjc_pivot_key(T v, bool used) {
  if (used) return 1ull;
  const double a = fabs((double)v);
  return a == a ? (unsigned long long)__double_as_longlong(a) + 2ull : 0ull;
}

// The larger key, and the lower row among equal keys, over the warp (every
// lane gets the same pair).
__device__ __forceinline__ void gjc_warp_best(unsigned long long& key, int& row) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long ok = __shfl_xor_sync(TD_FULL_MASK, key, off);
    const int orow = __shfl_xor_sync(TD_FULL_MASK, row, off);
    if (ok > key || (ok == key && orow < row)) {
      key = ok;
      row = orow;
    }
  }
}

// This CTA's best candidate for column k among its rows (gjc_pivot_key's
// order, ties to the lowest row), into S.cand_*[k & 1]. Ends in a barrier.
template <int THREADS, class T>
__device__ void gjc_candidate(int m, int c, int rank, int k, const T* aug, size_t width,
                              const int* used, GjcSmem<THREADS, T>& S) {
  constexpr int NW = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nown = ub_own_rows(m, c, rank);
  unsigned long long key = 0ull;
  int row = INT_MAX;
  for (int i = tid; i < nown; i += THREADS) {
    const int r = rank + i * c;
    const unsigned long long kr = gjc_pivot_key(__ldcg(aug + r * width + k), used[i] != 0);
    if (kr > key) {
      key = kr;
      row = r;
    }
  }
  gjc_warp_best(key, row);
  if (lane == 0) {
    S.red_key[warp] = key;
    S.red_row[warp] = row;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned long long bk = 0ull;
    int br = INT_MAX;
    for (int w = 0; w < NW; ++w) {
      if (S.red_key[w] > bk || (S.red_key[w] == bk && S.red_row[w] < br)) {
        bk = S.red_key[w];
        br = S.red_row[w];
      }
    }
    S.cand_key[k & 1] = bk;
    S.cand_row[k & 1] = br;
    S.cand_val[k & 1] = br < m ? __ldcg(aug + br * width + k) : (T)ub_nan();
  }
  __syncthreads();
}

// Gauss-Jordan over the cluster on ``aug`` (m rows of ``width`` elements of
// type T in global memory, each CTA having written its own rows): with
// INVERSE, [A/e | I | B/e] with the identity columns kept in pivot order
// (gj.cuh's steps, the m + 3 live slots of a row a step); else kernel F's
// one-hot elimination of [A | B] (columns k + 1 .. m + 2 a step, a step with
// no usable pivot taking row 0). Every thread of every CTA calls it; it ends
// after a cluster barrier that follows every row's last update.
template <int THREADS, bool INVERSE, class T>
__device__ void gjc_solve(int m, cg::cluster_group& cluster, T* aug, size_t width,
                          const GjcRecord<T>& rec, GjcSmem<THREADS, T>& S, unsigned char* tail) {
  const int tid = threadIdx.x;
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int nown = ub_own_rows(m, c, rank);
  T* fac = reinterpret_cast<T*>(tail);
  int* used = reinterpret_cast<int*>(tail + sizeof(T) * (size_t)ub_own_rows(m, c, 0));
  for (int i = tid; i < nown; i += THREADS) used[i] = 0;
  __syncthreads();
  gjc_candidate(m, c, rank, 0, aug, width, used, S);
  ub_cluster_publish(cluster);
  for (int k = 0; k < m; ++k) {
    const int b = k & 1;
    unsigned long long bk = 0ull;
    int p = INT_MAX;
    T pv = (T)ub_nan();
    for (int r = 0; r < c; ++r) {
      const unsigned long long kk = *cluster.map_shared_rank(&S.cand_key[b], r);
      const int rr = *cluster.map_shared_rank(&S.cand_row[b], r);
      if (kk > bk || (kk == bk && rr < p)) {
        bk = kk;
        p = rr;
        pv = *cluster.map_shared_rank(&S.cand_val[b], r);
      }
    }
    if (bk == 0ull) {
      p = m;  // every candidate NaN and no row used
      pv = (T)ub_nan();
    }
    if (!INVERSE && p >= m) p = 0;
    if (tid == 0) {
      rec.perm[k] = p;
      rec.diag[k] = pv;
      if (p < m) rec.pos[p] = k;
    }
    if (p < m && p % c == rank && tid == 0) used[p / c] = 1;
    if (p < m) {
      const T pv_safe = pv == (T)0 ? (T)1 : pv;
      for (int i = tid; i < nown; i += THREADS) {
        const int r = rank + i * c;
        fac[i] = r == p ? (T)0 : __ldcg(aug + r * width + k) / pv_safe;
      }
      // The live slots: INVERSE, columns k + 1 .. k + m (slot m - 1 the
      // pivot row's fresh identity column m + k) and the three B columns;
      // one-hot, columns k + 1 .. m + 2.
      const int nslots = INVERSE ? m + 3 : m + 2 - k;
      auto col = [&](int j) { return (INVERSE && j >= m) ? m + j : k + 1 + j; };
      for (int j0 = 0; j0 < nslots; j0 += UB_PCHUNK) {
        const int jn = min(UB_PCHUNK, nslots - j0);
        __syncthreads();  // the factors are written; the last chunk is read
        for (int j = tid; j < jn; j += THREADS) {
          const int jj = j0 + j;
          S.prow[j] = (INVERSE && jj == m - 1) ? (T)1 : __ldcg(aug + p * width + col(jj));
        }
        __syncthreads();
        for (int e = tid; e < nown * jn; e += THREADS) {
          const int i = e / jn, j = e - i * jn;
          const int r = rank + i * c;
          if (r == p) continue;
          const int jj = j0 + j;
          T* dst = aug + r * width + col(jj);
          const T x = (INVERSE && jj == m - 1) ? (T)0 : __ldcg(dst);
          __stcg(dst, x - fac[i] * S.prow[j]);
        }
      }
      // The pivot row keeps its values; its fresh identity entry is 1.
      if (INVERSE && p % c == rank && tid == 0) __stcg(aug + p * width + m + k, (T)1);
    }
    __syncthreads();
    if (k + 1 < m) gjc_candidate(m, c, rank, k + 1, aug, width, used, S);
    ub_cluster_publish(cluster);
  }
}

// w[k] = aug[perm k][bcol + d] / pivot_k (|pivot| < 1e-30 read as 1; NaN
// where no row was pivoted), the quotient in T, rounded to float. Call after
// gjc_solve. Ends in a barrier.
template <int THREADS, class T>
__device__ void gjc_extract(int m, const T* aug, size_t width, int bcol, const GjcRecord<T>& rec,
                            float* w) {
  for (int q = threadIdx.x; q < m * 3; q += THREADS) {
    const int k = q / 3, d = q - k * 3;
    const T dg = fabs(rec.diag[k]) < (T)1e-30f ? (T)1 : rec.diag[k];
    const int pr = rec.perm[k];
    w[q] = pr < m ? (float)(__ldcg(aug + pr * width + bcol + d) / dg) : ub_nan();
  }
  __syncthreads();
}

// Three refinement steps of w against the unscaled system A w = B (gj.cuh's
// gj_refine): w += inv ((B - A w) / e), A w by exact_split_dot with
// compensated sums, the inverse read from [A | I | B] in float64 (its
// quotient and the correction's sum in float64, over the identity columns
// in pivot order). ``e`` is the row scales the rows' owners wrote; ``wsp``
// (9 m) and ``res`` (3 m) are scratch. Ends in a barrier.
template <int THREADS, class AM>
__device__ void gjc_refine(int m, const AM& A, const float* b, float* w, const float* e,
                           const double* aug, size_t width, const GjcRecord<double>& rec,
                           float* wsp, float* res) {
  for (int step = 0; step < 3; ++step) {
    split3_all<THREADS>(m * 3, w, wsp);
    __syncthreads();
    for (int q = threadIdx.x; q < m * 3; q += THREADS) {
      const int r = q / 3, d = q - r * 3;
      const float acc = exact_split_dot<true>(m, A, r, wsp, m * 3, d);
      res[q] = (b[q] - acc) / __ldcg(e + r);
    }
    __syncthreads();
    for (int q = threadIdx.x; q < m * 3; q += THREADS) {
      const int r = q / 3, d = q - r * 3;
      const double dg = fabs(rec.diag[r]) < 1e-30 ? 1.0 : rec.diag[r];
      const int pr = rec.perm[r];
      double acc = 0.0;
      if (pr < m) {
        const double* row = aug + pr * width + m;
        for (int s = 0; s < m; ++s) {
          const int j = rec.perm[s];
          if (j < m) acc += __ldcg(row + s) / dg * (double)res[j * 3 + d];
        }
      } else {
        acc = ub_nan();
      }
      w[q] = (float)((double)w[q] + acc);
    }
    __syncthreads();
  }
}

// A CTA's rows of [A/e | 0 | B/e] for the equilibrated solve, in float64
// (each entry a float32 divided by a power of two, so exactly the bounded
// builds' value): a warp per row, the row scale by RULE from max |A(r, :)|
// (written to ``e``, read by every CTA's refinement), ``b`` (m, 3)
// unscaled. Ends in a barrier.
template <int THREADS, GjScale RULE, class AM>
__device__ void gjc_build_scaled(int m, int c, int rank, const AM& A, const float* b, double* aug,
                                 size_t width, float* e) {
  constexpr int NW = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nown = ub_own_rows(m, c, rank);
  for (int i = warp; i < nown; i += NW) {
    const int r = rank + i * c;
    float d = 0.0f;
    for (int cc = lane; cc < m; cc += 32) d = fmaxf(d, fabsf(A.value(r, cc)));
    for (int off = 16; off > 0; off >>= 1) d = fmaxf(d, __shfl_xor_sync(TD_FULL_MASK, d, off));
    const float er = gj_row_scale<RULE>(d);
    if (lane == 0) e[r] = er;
    for (int cc = lane; cc < 2 * m + 3; cc += 32) {
      float v;
      if (cc < m) v = A.value(r, cc) / er;
      else if (cc < 2 * m) v = 0.0f;  // written when its row is pivoted
      else v = b[r * 3 + cc - 2 * m] / er;
      __stcg(aug + r * width + cc, (double)v);
    }
  }
  __syncthreads();
}

}  // namespace td
