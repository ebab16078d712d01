// The E-step of one EM stream spread over a thread-block cluster, as device
// code that kernel E (em_loop.cu, every iteration of a pass), kernel S
// (estep.cu, one iteration of B streams) and kernel F (em_iter.cu, one whole
// iteration of B streams) run.
//
// What bounds it on an H100: a chain of dependent steps, not bytes or FLOPs.
// The live cloud is 2048 rows (8 parity channels x 256 slots) of which ~360
// are valid, at the front of each channel's block. One CTA walking all rows
// in chunks of 512 pays a point's whole chain (2 x 45 exponentials, ~135
// divisions) once per chunk with 3 of 16 warps at work.
//
// Design:
// - The cluster has C CTAs and CTA r owns rows [r R, (r + 1) R); C and R are
//   functions of n alone (ec_cluster_size, ec_rows_per_cta), never of the
//   batch or the card, so a stream's bits depend on neither. At n = 2048,
//   C = 8 and each CTA owns one channel block.
// - Once per launch each CTA compacts the valid rows of its range into shared
//   memory (warp ballot and block prefix, in row order); a range longer than
//   EC_PMAX rows (more than 16,384 in all) is compacted a tile at a time on
//   every pass (the ec_*_tiled functions).
// - Each point gets kLanes lanes of kNpl nodes each (EcShape): the chain
//   per thread is 12 nodes, not 48 (16 of 128 in the wide layout). Sums
//   over a point's nodes are per-lane sums in node order and then a shuffle
//   butterfly (every lane gets the same bits); the first argmax ties to the
//   lowest node, as the plain version.
// - Visibility minima: per-thread minima in registers, then the warp, the
//   block and the cluster (every CTA reads every CTA's minima over
//   distributed shared memory; a minimum is exact in any order).
// - P1, PX, Np and tr(X^T dPt1 X): each CTA sums its points in point order,
//   one thread per (quantity, node); the cluster totals are the CTAs'
//   partials added in rank order, so every CTA that reads them holds the
//   same bits.
// - No float atomics anywhere: a result is the same run to run.
//
// Every CTA of the cluster runs every barrier: a CTA whose range holds no
// valid point computes zero partials and the sentinel minima. The partials
// and minima are double-buffered by iteration parity, so a fast CTA never
// overwrites what a slow one is still reading.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace td {

namespace cg = cooperative_groups;

// The node bound MM is a compile-time parameter of every layout here, with
// two instantiations: EC_MMAX (48, the live profile's 45 nodes) and
// EC_MMAX_WIDE (128). A launch takes the narrow one where m <= 48.
constexpr int EC_MMAX = 48;
constexpr int EC_MMAX_WIDE = 128;
constexpr int EC_ROWS = 256;                     // rows per CTA aimed at
constexpr int EC_MAX_CLUSTER = 8;                // portable cluster size
constexpr int EC_PMAX = 2048;                    // rows a CTA holds compacted at a time
constexpr float EC_BIG = 1e5f;

// Lanes per point and nodes per lane for the node bound MM: 4 x 12 at 48,
// 8 x 16 at 128 (a point's chain stays 12-16 nodes a thread).
template <int MM>
struct EcShape {
  static constexpr int kLanes = MM <= EC_MMAX ? 4 : 8;
  static constexpr int kNpl = MM / kLanes;
  static constexpr int kNsum = MM * 4 + 2;  // P1, PX0..2 by node; Np; trace
  static_assert(MM % kLanes == 0 && 32 % kLanes == 0, "lanes must tile the nodes and a warp");
};

// The cluster size for n rows: one CTA per 256 rows, 1 to 8.
__host__ __device__ inline int ec_cluster_size(int n) {
  const int c = (n + EC_ROWS - 1) / EC_ROWS;
  return c < 1 ? 1 : (c > EC_MAX_CLUSTER ? EC_MAX_CLUSTER : c);
}

// Rows per CTA for n rows (the last CTA's range may be shorter or empty).
__host__ __device__ inline int ec_rows_per_cta(int n) {
  const int c = ec_cluster_size(n);
  return (n + c - 1) / c;
}

// The E-step's shared memory for CTAs of THREADS threads and at most MM
// nodes. The scratch (q, pt1, ptx, wmin) is only live inside one E-step and
// is at least EXTRA floats: a kernel may use it between E-steps (kernel E's
// wide solve keeps its [A | I | B] there).
template <int THREADS, int MM = EC_MMAX, int EXTRA = 0>
struct EstepSmem {
  static constexpr int kMM = MM;
  static constexpr int kLanes = EcShape<MM>::kLanes;
  static constexpr int kNpl = EcShape<MM>::kNpl;
  static constexpr int kNsum = EcShape<MM>::kNsum;
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kPass = THREADS / kLanes;  // points per pass
  static constexpr int kSums = (kNsum + THREADS - 1) / THREADS;  // partial sums a thread
  static constexpr int kScratch = kPass * MM + 2 * kPass + kWarps * MM;
  float y[MM * 3];  // rows past m are zero (the TPU's pad rows)
  float coord[MM], nm[MM], pv[MM];
  float gmin[MM];           // the cluster's node minima
  float xs[EC_PMAX * 3];    // this CTA's valid points, in row order
  // q: memberships of one pass of points [kPass * MM]; pt1, ptx [kPass];
  // wmin [kWarps * MM].
  float scratch[kScratch > EXTRA ? kScratch : EXTRA];
  float cmin[2][MM];        // this CTA's node minima, read by the cluster
  float part[2][kNsum];     // this CTA's partial sums, read by the cluster
  float tot[kNsum];         // the cluster's totals
  int wcount[kWarps];
  __device__ __forceinline__ float* q() { return scratch; }
  __device__ __forceinline__ float* pt1() { return scratch + kPass * MM; }
  __device__ __forceinline__ float* ptx() { return scratch + kPass * MM + kPass; }
  __device__ __forceinline__ float* wmin() { return scratch + kPass * MM + 2 * kPass; }
};

// Per-iteration constants of the E-step.
struct EcScalars {
  float s2;
  float neg_half_inv_s2;  // kernel S's exponent scale
  float c_plain, c_eff, gate;
  int v_count;
  int sel_rows;  // the anchor row select gives 0 outside [0, sel_rows)
  int m;
};

__device__ __forceinline__ float ec_sq_dist(const float* y, int j, float x0, float x1, float x2) {
  const float d0 = y[j * 3 + 0] - x0, d1 = y[j * 3 + 1] - x1, d2 = y[j * 3 + 2] - x2;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

// Sum over the LANES lanes of one point; every lane gets the same bits
// (float addition is commutative).
template <int LANES>
__device__ __forceinline__ float ec_point_sum(float v) {
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) v += __shfl_xor_sync(TD_FULL_MASK, v, off);
  return v;
}

// Compacts the valid rows [r0, r1) of x (xm > 0) into E.xs in row order;
// returns the count (the same in every thread). Ends in a barrier.
template <class ES>
__device__ int ec_compact(const float* x, const float* xm, int r0, int r1, ES& E) {
  constexpr int THREADS = ES::kWarps * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int count = 0;
  __syncthreads();
  for (int seg = r0; seg < r1; seg += THREADS) {
    const int i = seg + tid;
    const bool v = i < r1 && xm[i] > 0.0f;
    const unsigned bal = __ballot_sync(TD_FULL_MASK, v);
    if (lane == 0) E.wcount[warp] = __popc(bal);
    __syncthreads();
    int off = count, seg_total = 0;
    for (int w = 0; w < ES::kWarps; ++w) {
      if (w < warp) off += E.wcount[w];
      seg_total += E.wcount[w];
    }
    off += __popc(bal & ((1u << lane) - 1u));
    if (v) {
      E.xs[off * 3 + 0] = x[(size_t)i * 3 + 0];
      E.xs[off * 3 + 1] = x[(size_t)i * 3 + 1];
      E.xs[off * 3 + 2] = x[(size_t)i * 3 + 2];
    }
    count += seg_total;
    __syncthreads();
  }
  return count;
}

// The cluster's minimum over the valid points of each valid node's squared
// distance, into E.gmin (1e5 where the node is masked or no point is valid),
// in two parts: each thread's minima over compacted points (ec_minima_acc,
// over one or more tiles), then the warp, block and cluster reduction
// (ec_minima_reduce).
template <class ES>
__device__ __forceinline__ void ec_minima_init(float (&mn)[ES::kNpl]) {
#pragma unroll
  for (int k = 0; k < ES::kNpl; ++k) mn[k] = EC_BIG;
}

template <class ES>
__device__ __forceinline__ void ec_minima_acc(int m, int npts, ES& E, float (&mn)[ES::kNpl]) {
  constexpr int LANES = ES::kLanes, NPL = ES::kNpl;
  const int tid = threadIdx.x;
  const int l = tid % LANES, pi = tid / LANES;
  for (int i = pi; i < npts; i += ES::kPass) {
    const float x0 = E.xs[i * 3], x1 = E.xs[i * 3 + 1], x2 = E.xs[i * 3 + 2];
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int j = l * NPL + k;
      if (j < m && E.nm[j] > 0.0f) mn[k] = fminf(mn[k], ec_sq_dist(E.y, j, x0, x1, x2));
    }
  }
}

template <class ES>
__device__ void ec_minima_reduce(int m, int buf, ES& E, cg::cluster_group& cluster,
                                 float (&mn)[ES::kNpl]) {
  constexpr int LANES = ES::kLanes, NPL = ES::kNpl, MM = ES::kMM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* wmin = E.wmin();
  // Across the warp's points: the lanes that hold the same nodes.
#pragma unroll
  for (int k = 0; k < NPL; ++k)
    for (int off = LANES; off < 32; off <<= 1)
      mn[k] = fminf(mn[k], __shfl_xor_sync(TD_FULL_MASK, mn[k], off));
  if (lane < LANES) {
#pragma unroll
    for (int k = 0; k < NPL; ++k) wmin[warp * MM + lane * NPL + k] = mn[k];
  }
  __syncthreads();
  if (tid < m) {
    float v = EC_BIG;
    for (int w = 0; w < ES::kWarps; ++w) v = fminf(v, wmin[w * MM + tid]);
    E.cmin[buf][tid] = v;
  }
  cluster.sync();
  if (tid < m) {
    const int c = (int)cluster.num_blocks();
    float v = EC_BIG;
    for (int r = 0; r < c; ++r) v = fminf(v, cluster.map_shared_rank(&E.cmin[buf][0], r)[tid]);
    E.gmin[tid] = v;
  }
  __syncthreads();
}

template <class ES>
__device__ void ec_cluster_minima(int m, int npts, int buf, ES& E, cg::cluster_group& cluster) {
  float mn[ES::kNpl];
  ec_minima_init<ES>(mn);
  ec_minima_acc(m, npts, E, mn);
  ec_minima_reduce(m, buf, E, cluster, mn);
}

// The same over rows [r0, r1) of x taken a tile of at most EC_PMAX rows at a
// time, each compacted into E.xs in row order (a CTA holding more rows than
// E.xs). A minimum is exact in any order: the values of one long tile.
template <class ES>
__device__ void ec_cluster_minima_tiled(const float* x, const float* xm, int r0, int r1, int m,
                                        int buf, ES& E, cg::cluster_group& cluster) {
  float mn[ES::kNpl];
  ec_minima_init<ES>(mn);
  for (int t0 = r0; t0 < r1; t0 += EC_PMAX)
    ec_minima_acc(m, ec_compact(x, xm, t0, min(r1, t0 + EC_PMAX), E), E, mn);
  ec_minima_reduce(m, buf, E, cluster, mn);
}

// Visibility weights from the cluster minima, in warp 0: exp(-k_vis d) with
// d = 0 within tau, 0 for masked nodes, normalised by their sum (a fixed
// shuffle tree, floored at 1e-30).
template <class ES>
__device__ void ec_visibility_weights(int m, float k_vis, float tau_vis, ES& E) {
  constexpr int H = (ES::kMM + 31) / 32;  // nodes a lane
  const int tid = threadIdx.x;
  if (tid < 32) {
    float w[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int j = tid + 32 * h;
      w[h] = 0.0f;
      if (j < m) {
        float sh = sqrtf(E.gmin[j]);
        if (sh <= tau_vis) sh = 0.0f;
        w[h] = E.nm[j] > 0.0f ? expf(-k_vis * sh) : 0.0f;
      }
    }
    float lane_sum = w[0];
#pragma unroll
    for (int h = 1; h < H; ++h) lane_sum = lane_sum + w[h];
    const float total = fmaxf(td_warp_allsum(lane_sum), 1e-30f);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int j = tid + 32 * h;
      if (j < m) E.pv[j] = w[h] / total;
    }
  }
  __syncthreads();
}

// This CTA's partial P1, PX, Np and trace into E.part[buf]: [q m + j] for
// quantity q (P1, PX0, PX1, PX2) and node j, then Np, then the trace.
// Two independent choices of the TPU kernel being replaced:
// - MUL_EXPONENT: the exponent as sq * (-0.5 / s2) (kernel S's), else as
//   (-0.5 sq) / s2 (kernels E's and F's);
// - GATE_BLEND: the prior as p (1 + g (pv - 1)), c_eff given as
//   c_plain + g (c_vis - c_plain), masked nodes 0 in the second
//   normalisation (kernels S's and F's), else the prior multiplied in where
//   the gate is on (kernel E's).
// Each thread's sums (EcPartials) are running sums in point order; with
// COMPENSATED (a CTA holding more than EC_PMAX rows, its points fed a tile
// at a time) they are compensated (Kahan) sums, whose error does not grow
// with the point count: the sigma^2 update cancels the traces to ~1e-4 of
// their size, and a plain float32 running sum over thousands of points
// leaves an error of that order.
template <class ES>
struct EcPartials {
  float acc[ES::kSums];  // partial sum t = tid + s THREADS: quantity qty[s], node jt[s]
  float cmp[ES::kSums];  // its compensation (COMPENSATED only)
  int qty[ES::kSums], jt[ES::kSums];
  __device__ __forceinline__ void init(int m) {
    constexpr int THREADS = ES::kWarps * 32;
#pragma unroll
    for (int s = 0; s < ES::kSums; ++s) {
      acc[s] = 0.0f;
      cmp[s] = 0.0f;
      qty[s] = (threadIdx.x + s * THREADS) / m;
      jt[s] = threadIdx.x + s * THREADS - qty[s] * m;
    }
  }
  __device__ __forceinline__ void store(int m, int buf, ES& E) const {
    constexpr int THREADS = ES::kWarps * 32;
#pragma unroll
    for (int s = 0; s < ES::kSums; ++s) {
      const int t = threadIdx.x + s * THREADS;
      if (t < 4 * m + 2) E.part[buf][t] = acc[s];
    }
  }
};

template <bool MUL_EXPONENT, bool GATE_BLEND, bool COMPENSATED = false, class ES>
__device__ void ec_estep_accumulate(const EcScalars& sc, int npts, ES& E, EcPartials<ES>& P) {
  constexpr int PASS = ES::kPass, LANES = ES::kLanes, NPL = ES::kNpl, MM = ES::kMM;
  constexpr int THREADS = ES::kWarps * 32, SUMS = ES::kSums;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int l = tid % LANES, pi = tid / LANES;
  const int m = sc.m;
  float* const qv = E.q();
  float* const pt1v = E.pt1();
  float* const ptxv = E.ptx();
  auto expo = [&](float d) { return MUL_EXPONENT ? d * sc.neg_half_inv_s2 : -0.5f * d / sc.s2; };
  for (int base = 0; base < npts; base += PASS) {
    // Warps with no point in this pass skip it whole (shuffles stay in warp).
    if (base + warp * (32 / LANES) < npts) {
      const int i = base + pi;
      const bool live = i < npts;
      const int ii = live ? i : base;
      const float x0 = E.xs[ii * 3], x1 = E.xs[ii * 3 + 1], x2 = E.xs[ii * 3 + 2];
      float e[NPL];
      float sum1 = 0.0f;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const int j = l * NPL + k;
        float v = 0.0f;
        if (j < m && E.nm[j] > 0.0f) v = expf(expo(ec_sq_dist(E.y, j, x0, x1, x2)));
        e[k] = v;
        sum1 += v;
      }
      const float den1 = ec_point_sum<LANES>(sum1) + sc.c_plain;
      // First argmax of the normalised memberships, ties to the lowest node.
      int mp = 1 << 20;
      float best = -1.0f;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const int j = l * NPL + k;
        if (j < m) {
          const float q = E.nm[j] > 0.0f ? e[k] / den1 : -1.0f;
          if (q > best) {
            best = q;
            mp = j;
          }
        }
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1) {
        const float ob = __shfl_xor_sync(TD_FULL_MASK, best, off);
        const int oj = __shfl_xor_sync(TD_FULL_MASK, mp, off);
        if (ob > best || (ob == best && oj < mp)) {
          best = ob;
          mp = oj;
        }
      }
      if (mp >= MM) mp = 0;  // no node beat -1: row 0, as the plain version
      // Anchor pair with the reference's boundary fallbacks; a row outside
      // [0, sel_rows) selects 0 (v_count < 3 makes cand2 negative).
      const int cand1 = (mp - 1 == -1) ? 2 : mp - 1;
      const int cand2 = (mp + 1 == sc.v_count) ? sc.v_count - 3 : mp + 1;
      auto sel_sq = [&](int r) {
        return (r >= 0 && r < sc.sel_rows) ? ec_sq_dist(E.y, r, x0, x1, x2) : 0.0f;
      };
      auto sel_coord = [&](int r) { return (r >= 0 && r < sc.sel_rows) ? E.coord[r] : 0.0f; };
      const int nxt = sel_sq(cand1) < sel_sq(cand2) ? cand1 : cand2;
      const int lo = min(mp, nxt), hi = max(mp, nxt);
      const float d_lo = sqrtf(sel_sq(lo)), d_hi = sqrtf(sel_sq(hi));
      const float c_lo = sel_coord(lo), c_hi = sel_coord(hi);
      // Geodesic re-distance (zero band strictly between the anchors), the
      // visibility prior, the second normalisation.
      float sum2 = 0.0f;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const int j = l * NPL + k;
        float v = 0.0f;
        if (j < m && E.nm[j] > 0.0f) {
          float geo;
          if (j < lo) {
            const float u = fabsf(E.coord[j] - c_lo) + d_lo;
            geo = u * u;
          } else if (j >= hi) {
            const float u = fabsf(E.coord[j] - c_hi) + d_hi;
            geo = u * u;
          } else if (j == lo) {
            geo = d_lo * d_lo;
          } else {
            geo = 0.0f;
          }
          v = expf(expo(geo));
          if (GATE_BLEND) {
            v = v * (1.0f + sc.gate * (E.pv[j] - 1.0f));
          } else if (sc.gate > 0.0f) {
            v = v * E.pv[j];
          }
        }
        e[k] = v;
        sum2 += v;
      }
      const float den2 = ec_point_sum<LANES>(sum2) + sc.c_eff;
      float pt1 = 0.0f;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const int j = l * NPL + k;
        if (j < m) {
          const float q = GATE_BLEND ? (E.nm[j] > 0.0f ? e[k] / den2 : 0.0f) : e[k] / den2;
          if (live) qv[pi * MM + j] = q;
          pt1 += q;
        }
      }
      pt1 = ec_point_sum<LANES>(pt1);
      if (live && l == 0) {
        pt1v[pi] = pt1;
        ptxv[pi] = pt1 * (x0 * x0 + x1 * x1 + x2 * x2);
      }
    }
    __syncthreads();
    const int cnt = min(PASS, npts - base);
#pragma unroll
    for (int s = 0; s < SUMS; ++s) {
      const int t = tid + s * THREADS;
      auto add = [&](float v) {
        if (COMPENSATED) td_kahan_add(P.acc[s], P.cmp[s], v);
        else P.acc[s] += v;
      };
      if (P.qty[s] == 0) {
        for (int p = 0; p < cnt; ++p) add(qv[p * MM + P.jt[s]]);
      } else if (P.qty[s] < 4) {
        for (int p = 0; p < cnt; ++p) add(qv[p * MM + P.jt[s]] * E.xs[(base + p) * 3 + P.qty[s] - 1]);
      } else if (t == 4 * m) {
        for (int p = 0; p < cnt; ++p) add(pt1v[p]);
      } else if (t == 4 * m + 1) {
        for (int p = 0; p < cnt; ++p) add(ptxv[p]);
      }
    }
    __syncthreads();
  }
}

template <bool MUL_EXPONENT, bool GATE_BLEND, class ES>
__device__ void ec_estep_partials(const EcScalars& sc, int npts, int buf, ES& E) {
  EcPartials<ES> P;
  P.init(sc.m);
  ec_estep_accumulate<MUL_EXPONENT, GATE_BLEND>(sc, npts, E, P);
  P.store(sc.m, buf, E);
}

// The same over rows [r0, r1) of x a tile of at most EC_PMAX rows at a time,
// each compacted into E.xs in row order, the sums compensated.
template <bool MUL_EXPONENT, bool GATE_BLEND, class ES>
__device__ void ec_estep_partials_tiled(const EcScalars& sc, const float* x, const float* xm,
                                        int r0, int r1, int buf, ES& E) {
  EcPartials<ES> P;
  P.init(sc.m);
  for (int t0 = r0; t0 < r1; t0 += EC_PMAX)
    ec_estep_accumulate<MUL_EXPONENT, GATE_BLEND, true>(
        sc, ec_compact(x, xm, t0, min(r1, t0 + EC_PMAX), E), E, P);
  P.store(sc.m, buf, E);
}

// The cluster's totals into E.tot: the CTAs' partials added in rank order.
// Call after a cluster.sync() that follows every CTA's ec_estep_partials.
template <class ES>
__device__ void ec_cluster_totals(int m, int buf, ES& E, cg::cluster_group& cluster) {
  constexpr int THREADS = ES::kWarps * 32;
  const int c = (int)cluster.num_blocks();
  for (int t = threadIdx.x; t < 4 * m + 2; t += THREADS) {
    float v[EC_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < EC_MAX_CLUSTER; ++r)
      v[r] = r < c ? cluster.map_shared_rank(&E.part[buf][0], r)[t] : 0.0f;
    float s = v[0];
#pragma unroll
    for (int r = 1; r < EC_MAX_CLUSTER; ++r)
      if (r < c) s += v[r];
    E.tot[t] = s;
  }
  __syncthreads();
}

}  // namespace td
