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
//   memory (warp ballot and block prefix, in row order).
// - Each point gets EC_LANES lanes of EC_NPL nodes each: the chain per
//   thread is 12 nodes, not 48. Sums over a point's nodes are per-lane sums
//   in node order and then a shuffle butterfly (every lane gets the same
//   bits); the first argmax ties to the lowest node, as the plain version.
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

constexpr int EC_MMAX = 48;
constexpr int EC_LANES = 4;                      // lanes per point
constexpr int EC_NPL = EC_MMAX / EC_LANES;       // nodes per lane
constexpr int EC_ROWS = 256;                     // rows per CTA aimed at
constexpr int EC_MAX_CLUSTER = 8;                // portable cluster size
constexpr int EC_PMAX = 2048;                    // rows a CTA can hold
constexpr int EC_NSUM = EC_MMAX * 4 + 2;         // P1, PX0..2 by node; Np; trace
constexpr float EC_BIG = 1e5f;
static_assert(EC_MMAX % EC_LANES == 0 && 32 % EC_LANES == 0, "lanes must tile the nodes and a warp");

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

// The E-step's shared memory for CTAs of THREADS threads.
template <int THREADS>
struct EstepSmem {
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kPass = THREADS / EC_LANES;  // points per pass
  static_assert(4 * EC_MMAX + 2 <= THREADS, "one thread per partial sum");
  float y[EC_MMAX * 3];  // rows past m are zero (the TPU's pad rows)
  float coord[EC_MMAX], nm[EC_MMAX], pv[EC_MMAX];
  float gmin[EC_MMAX];           // the cluster's node minima
  float xs[EC_PMAX * 3];         // this CTA's valid points, in row order
  float q[kPass * EC_MMAX];      // memberships of one pass of points
  float pt1[kPass], ptx[kPass];
  float wmin[kWarps * EC_MMAX];
  float cmin[2][EC_MMAX];        // this CTA's node minima, read by the cluster
  float part[2][EC_NSUM];        // this CTA's partial sums, read by the cluster
  float tot[EC_NSUM];            // the cluster's totals
  int wcount[kWarps];
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

// Sum over the EC_LANES lanes of one point; every lane gets the same bits
// (float addition is commutative).
__device__ __forceinline__ float ec_point_sum(float v) {
#pragma unroll
  for (int off = 1; off < EC_LANES; off <<= 1) v += __shfl_xor_sync(TD_FULL_MASK, v, off);
  return v;
}

// Compacts the valid rows [r0, r1) of x (xm > 0) into E.xs in row order;
// returns the count (the same in every thread). Ends in a barrier.
template <int THREADS>
__device__ int ec_compact(const float* x, const float* xm, int r0, int r1, EstepSmem<THREADS>& E) {
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
    for (int w = 0; w < EstepSmem<THREADS>::kWarps; ++w) {
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
// distance, into E.gmin (1e5 where the node is masked or no point is valid).
template <int THREADS>
__device__ void ec_cluster_minima(int m, int npts, int buf, EstepSmem<THREADS>& E,
                                  cg::cluster_group& cluster) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l = tid % EC_LANES, pi = tid / EC_LANES;
  float mn[EC_NPL];
#pragma unroll
  for (int k = 0; k < EC_NPL; ++k) mn[k] = EC_BIG;
  for (int i = pi; i < npts; i += EstepSmem<THREADS>::kPass) {
    const float x0 = E.xs[i * 3], x1 = E.xs[i * 3 + 1], x2 = E.xs[i * 3 + 2];
#pragma unroll
    for (int k = 0; k < EC_NPL; ++k) {
      const int j = l * EC_NPL + k;
      if (j < m && E.nm[j] > 0.0f) mn[k] = fminf(mn[k], ec_sq_dist(E.y, j, x0, x1, x2));
    }
  }
  // Across the warp's points: the lanes that hold the same nodes.
#pragma unroll
  for (int k = 0; k < EC_NPL; ++k)
    for (int off = EC_LANES; off < 32; off <<= 1)
      mn[k] = fminf(mn[k], __shfl_xor_sync(TD_FULL_MASK, mn[k], off));
  if (lane < EC_LANES) {
#pragma unroll
    for (int k = 0; k < EC_NPL; ++k) E.wmin[warp * EC_MMAX + lane * EC_NPL + k] = mn[k];
  }
  __syncthreads();
  if (tid < m) {
    float v = EC_BIG;
    for (int w = 0; w < EstepSmem<THREADS>::kWarps; ++w) v = fminf(v, E.wmin[w * EC_MMAX + tid]);
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

// Visibility weights from the cluster minima, in warp 0: exp(-k_vis d) with
// d = 0 within tau, 0 for masked nodes, normalised by their sum (a fixed
// shuffle tree, floored at 1e-30).
template <int THREADS>
__device__ void ec_visibility_weights(int m, float k_vis, float tau_vis, EstepSmem<THREADS>& E) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    float w[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = tid + 32 * h;
      if (j < m) {
        float sh = sqrtf(E.gmin[j]);
        if (sh <= tau_vis) sh = 0.0f;
        w[h] = E.nm[j] > 0.0f ? expf(-k_vis * sh) : 0.0f;
      }
    }
    const float total = fmaxf(td_warp_allsum(w[0] + w[1]), 1e-30f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
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
template <bool MUL_EXPONENT, bool GATE_BLEND, int THREADS>
__device__ void ec_estep_partials(const EcScalars& sc, int npts, int buf, EstepSmem<THREADS>& E) {
  constexpr int PASS = EstepSmem<THREADS>::kPass;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int l = tid % EC_LANES, pi = tid / EC_LANES;
  const int m = sc.m;
  const int qty = tid / m, jt = tid - qty * m;  // this thread's partial sum
  auto expo = [&](float d) { return MUL_EXPONENT ? d * sc.neg_half_inv_s2 : -0.5f * d / sc.s2; };
  float acc = 0.0f;
  for (int base = 0; base < npts; base += PASS) {
    // Warps with no point in this pass skip it whole (shuffles stay in warp).
    if (base + warp * (32 / EC_LANES) < npts) {
      const int i = base + pi;
      const bool live = i < npts;
      const int ii = live ? i : base;
      const float x0 = E.xs[ii * 3], x1 = E.xs[ii * 3 + 1], x2 = E.xs[ii * 3 + 2];
      float e[EC_NPL];
      float sum1 = 0.0f;
#pragma unroll
      for (int k = 0; k < EC_NPL; ++k) {
        const int j = l * EC_NPL + k;
        float v = 0.0f;
        if (j < m && E.nm[j] > 0.0f) v = expf(expo(ec_sq_dist(E.y, j, x0, x1, x2)));
        e[k] = v;
        sum1 += v;
      }
      const float den1 = ec_point_sum(sum1) + sc.c_plain;
      // First argmax of the normalised memberships, ties to the lowest node.
      int mp = 1 << 20;
      float best = -1.0f;
#pragma unroll
      for (int k = 0; k < EC_NPL; ++k) {
        const int j = l * EC_NPL + k;
        if (j < m) {
          const float q = E.nm[j] > 0.0f ? e[k] / den1 : -1.0f;
          if (q > best) {
            best = q;
            mp = j;
          }
        }
      }
#pragma unroll
      for (int off = 1; off < EC_LANES; off <<= 1) {
        const float ob = __shfl_xor_sync(TD_FULL_MASK, best, off);
        const int oj = __shfl_xor_sync(TD_FULL_MASK, mp, off);
        if (ob > best || (ob == best && oj < mp)) {
          best = ob;
          mp = oj;
        }
      }
      if (mp >= EC_MMAX) mp = 0;  // no node beat -1: row 0, as the plain version
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
      for (int k = 0; k < EC_NPL; ++k) {
        const int j = l * EC_NPL + k;
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
      const float den2 = ec_point_sum(sum2) + sc.c_eff;
      float pt1 = 0.0f;
#pragma unroll
      for (int k = 0; k < EC_NPL; ++k) {
        const int j = l * EC_NPL + k;
        if (j < m) {
          const float q = GATE_BLEND ? (E.nm[j] > 0.0f ? e[k] / den2 : 0.0f) : e[k] / den2;
          if (live) E.q[pi * EC_MMAX + j] = q;
          pt1 += q;
        }
      }
      pt1 = ec_point_sum(pt1);
      if (live && l == 0) {
        E.pt1[pi] = pt1;
        E.ptx[pi] = pt1 * (x0 * x0 + x1 * x1 + x2 * x2);
      }
    }
    __syncthreads();
    const int cnt = min(PASS, npts - base);
    if (qty == 0) {
      for (int p = 0; p < cnt; ++p) acc += E.q[p * EC_MMAX + jt];
    } else if (qty < 4) {
      for (int p = 0; p < cnt; ++p) acc += E.q[p * EC_MMAX + jt] * E.xs[(base + p) * 3 + qty - 1];
    } else if (tid == 4 * m) {
      for (int p = 0; p < cnt; ++p) acc += E.pt1[p];
    } else if (tid == 4 * m + 1) {
      for (int p = 0; p < cnt; ++p) acc += E.ptx[p];
    }
    __syncthreads();
  }
  if (tid < 4 * m + 2) E.part[buf][tid] = acc;
}

// The cluster's totals into E.tot: the CTAs' partials added in rank order.
// Call after a cluster.sync() that follows every CTA's ec_estep_partials.
template <int THREADS>
__device__ void ec_cluster_totals(int m, int buf, EstepSmem<THREADS>& E, cg::cluster_group& cluster) {
  const int tid = threadIdx.x;
  if (tid < 4 * m + 2) {
    const int c = (int)cluster.num_blocks();
    float v[EC_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < EC_MAX_CLUSTER; ++r)
      v[r] = r < c ? cluster.map_shared_rank(&E.part[buf][0], r)[tid] : 0.0f;
    float s = v[0];
#pragma unroll
    for (int r = 1; r < EC_MAX_CLUSTER; ++r)
      if (r < c) s += v[r];
    E.tot[tid] = s;
  }
  __syncthreads();
}

}  // namespace td
