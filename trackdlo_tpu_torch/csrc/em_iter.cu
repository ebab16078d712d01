// Kernel F: one whole EM iteration of B streams, the M-step solved in the
// same launch by a one-hot Gauss-Jordan elimination.
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py fused_em_iteration
// (_em_iteration_kernel, _estep_tile, _estep_probabilities,
// _onehot_gauss_jordan), which cpd_lle runs each iteration with
// CpdParams.use_fused_mstep; under jax.vmap its grid gains the stream axis.
//
// What bounds it on an H100: latency. One iteration at M = 45 and 4096
// points is ~0.4 M exponentials and ~8 MFLOP of E-step over ~70 KB of
// inputs, then a 45-step pivot chain (each step a search over the unused
// rows, then a rank-1 update of [A | B]) that no amount of bandwidth or
// FLOPs shortens.
//
// Design: one block of 512 threads per stream, kernel S's E-step (one
// thread per point, the point's 48 memberships in registers, fixed-order
// warp sums per (node, quantity), a fixed-order block tree for Np and
// tr(XᵀdPt1X), no float atomics) with the TPU function's own formulas:
// exp((-0.5·d²)/σ²), the gate blends p·(1 + g·(pv − 1)) and
// c_plain + g·(c_vis − c_plain), the anchor row select over the zero pad
// rows up to m_pad. The per-node minimum sweep runs only when the stream's
// gate is on (with the gate off the prior multiplies every membership by
// exactly 1). The M-step system [A | B] is built in shared memory with the
// TPU kernel's operation order and identity rows for inactive nodes, then
// solved by the one-hot elimination of _onehot_gauss_jordan: no row
// equilibration, no inverse, no refinement; at step k the pivot is the first
// maximum of |A[:, k]| over the rows not yet used (used rows bid -1, so a
// zero column still takes the first unused row), every other row is
// eliminated in place (no swaps), and W[k] = B[perm k] / pivot_k with
// |pivot| < 1e-30 read as 1. The TPU pads the system to m_pad with identity
// rows that never mix with the real ones and are never picked for a real
// column, so the solve runs at m. Then T = Y0 + G·W (inactive rows keep Y0),
// the σ² update floored at 1e-10 and the mean node move, all in the block.
#include "common.cuh"

namespace {

constexpr int MMAX = 48;
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int CHUNK = THREADS;
constexpr float BIG = 1e5f;

struct FArgs {
  const float* scal;  // (B, 5): sigma2, c_plain, c_vis, gate, v_count
  const float* y;     // (B, m, 3) current iterate
  const float* y0;    // (B, m, 3) EM origin
  const float* coord;  // (B, m)
  const float* nm;     // (B, m) 0/1
  const float* g;      // (B, m, m)
  const float* hg;     // (B, m, m)
  const float* hy0;    // (B, m, 3)
  const float* jg;     // (B, m, m)
  const float* pd;     // (B, m, 3)
  const float* x;      // (B, n, 3)
  const float* xm;     // (B, n) 0/1
  int m, n;
  float k_vis, tau_vis, lam, coef_lle, alpha;
  float* t;      // (B, m, 3)
  float* stats;  // (B, 2): sigma2_new, delta
};

struct Smem {
  float y[MMAX * 3], y0[MMAX * 3], coord[MMAX], nm[MMAX], pv[MMAX], short_sq[MMAX];
  float p[MMAX * CHUNK];  // memberships of the current chunk
  float xs[CHUNK * 3];    // the chunk's points
  float acc[MMAX * 4];    // per node: P1, PX0, PX1, PX2
  float aug[MMAX * (MMAX + 3)];  // [A | B]
  float w[MMAX * 3], tn[MMAX * 3];
  float factor[MMAX], used[MMAX], diag[MMAX];
  int perm[MMAX];
  float wmin[NWARPS * MMAX];
  float red[THREADS], red2[THREADS];
  int ridx;
  float pivot;
};

__device__ __forceinline__ float sq_dist(const float* y, int j, float x0, float x1, float x2) {
  float d0 = y[j * 3 + 0] - x0, d1 = y[j * 3 + 1] - x1, d2 = y[j * 3 + 2] - x2;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

__global__ void __launch_bounds__(THREADS, 1) em_iter_kernel(FArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x;
  const int m = A.m, n = A.n;
  const int m_pad = (m + 7) / 8 * 8;
  const float* sc = A.scal + (size_t)s * 5;
  const float s2 = sc[0], c_plain = sc[1], c_vis = sc[2], gate = sc[3];
  const float v_count_f = sc[4];
  const int v_count = (int)v_count_f;
  const float c_eff = c_plain + gate * (c_vis - c_plain);
  const float* x = A.x + (size_t)s * n * 3;
  const float* xm = A.xm + (size_t)s * n;
  const size_t mm = (size_t)s * m * m, m3 = (size_t)s * m * 3, m1 = (size_t)s * m;

  // Rows [m, m_pad) are zero, as the TPU's pad rows are.
  for (int k = tid; k < m_pad * 3; k += THREADS) {
    S.y[k] = k < m * 3 ? A.y[m3 + k] : 0.0f;
    S.y0[k] = k < m * 3 ? A.y0[m3 + k] : 0.0f;
  }
  for (int k = tid; k < m_pad; k += THREADS) {
    const bool in = k < m;
    S.coord[k] = in ? A.coord[m1 + k] : 0.0f;
    S.nm[k] = in ? A.nm[m1 + k] : 0.0f;
    S.short_sq[k] = BIG;
  }
  for (int k = tid; k < m * 4; k += THREADS) S.acc[k] = 0.0f;
  __syncthreads();

  // Phase 0: per-node nearest valid point (only read through the gate).
  if (gate > 0.0f) {
    float mn[MMAX];
#pragma unroll
    for (int j = 0; j < MMAX; ++j) mn[j] = BIG;
    for (int i = tid; i < n; i += THREADS) {
      if (!(xm[i] > 0.0f)) continue;
      const float x0 = x[i * 3], x1 = x[i * 3 + 1], x2 = x[i * 3 + 2];
#pragma unroll
      for (int j = 0; j < MMAX; ++j)
        if (j < m && S.nm[j] > 0.0f) mn[j] = fminf(mn[j], sq_dist(S.y, j, x0, x1, x2));
    }
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      if (j < m) {
        const float v = td_warp_min(mn[j]);
        if (lane == 0) S.wmin[warp * MMAX + j] = v;
      }
    }
    __syncthreads();
    if (tid < m) {
      float v = BIG;
      for (int w = 0; w < NWARPS; ++w) v = fminf(v, S.wmin[w * MMAX + tid]);
      S.short_sq[tid] = v;
    }
    __syncthreads();
  }
  if (tid == 0) {
    // The visibility prior from the minima (inert where the gate is off).
    float total = 0.0f;
    for (int j = 0; j < m; ++j) {
      float sh = sqrtf(S.short_sq[j]);
      if (sh <= A.tau_vis) sh = 0.0f;
      const float w = S.nm[j] > 0.0f ? expf(-A.k_vis * sh) : 0.0f;
      S.pv[j] = w;
      total += w;
    }
    total = fmaxf(total, 1e-30f);
    for (int j = 0; j < m; ++j) S.pv[j] = S.pv[j] / total;
  }
  __syncthreads();

  // Phase 1: the E-step, one chunk of points at a time.
  float np_loc = 0.0f, trx_loc = 0.0f;
  for (int base = 0; base < n; base += CHUNK) {
    const int i = base + tid;
    const bool valid = i < n && xm[i] > 0.0f;
    float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
    if (valid) {
      x0 = x[i * 3];
      x1 = x[i * 3 + 1];
      x2 = x[i * 3 + 2];
    }
    S.xs[tid * 3] = x0;
    S.xs[tid * 3 + 1] = x1;
    S.xs[tid * 3 + 2] = x2;
    if (valid) {
      float p[MMAX];
      float sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < MMAX; ++j) {
        float e = 0.0f;
        if (j < m && S.nm[j] > 0.0f) e = expf((-0.5f * sq_dist(S.y, j, x0, x1, x2)) / s2);
        p[j] = e;
        sum1 += e;
      }
      const float den1 = sum1 + c_plain;
      int mp = 0;
      float best = -1.0f;
#pragma unroll
      for (int j = 0; j < MMAX; ++j) {
        if (j < m) {
          const float q = S.nm[j] > 0.0f ? p[j] / den1 : -1.0f;
          if (q > best) {
            best = q;
            mp = j;
          }
        }
      }
      const int cand1 = (mp - 1 == -1) ? 2 : mp - 1;
      const int cand2 = (mp + 1 == v_count) ? v_count - 3 : mp + 1;
      auto sel_sq = [&](int r) {
        return (r >= 0 && r < m_pad) ? sq_dist(S.y, r, x0, x1, x2) : 0.0f;
      };
      auto sel_coord = [&](int r) { return (r >= 0 && r < m_pad) ? S.coord[r] : 0.0f; };
      const int nxt = sel_sq(cand1) < sel_sq(cand2) ? cand1 : cand2;
      const int lo = min(mp, nxt), hi = max(mp, nxt);
      const float d_lo = sqrtf(sel_sq(lo)), d_hi = sqrtf(sel_sq(hi));
      const float c_lo = sel_coord(lo), c_hi = sel_coord(hi);
      float sum2 = 0.0f;
#pragma unroll
      for (int j = 0; j < MMAX; ++j) {
        float e = 0.0f;
        if (j < m && S.nm[j] > 0.0f) {
          float geo;
          if (j < lo) {
            const float u = fabsf(S.coord[j] - c_lo) + d_lo;
            geo = u * u;
          } else if (j >= hi) {
            const float u = fabsf(S.coord[j] - c_hi) + d_hi;
            geo = u * u;
          } else if (j == lo) {
            geo = d_lo * d_lo;
          } else {
            geo = 0.0f;
          }
          e = expf((-0.5f * geo) / s2);
          e = e * (1.0f + gate * (S.pv[j] - 1.0f));
        }
        p[j] = e;
        sum2 += e;
      }
      const float den2 = sum2 + c_eff;
      float pt1 = 0.0f;
#pragma unroll
      for (int j = 0; j < MMAX; ++j) {
        if (j < m) {
          const float q = S.nm[j] > 0.0f ? p[j] / den2 : 0.0f;
          S.p[j * CHUNK + tid] = q;
          pt1 += q;
        }
      }
      np_loc += pt1;
      trx_loc += pt1 * (x0 * x0 + x1 * x1 + x2 * x2);
    } else {
      for (int j = 0; j < m; ++j) S.p[j * CHUNK + tid] = 0.0f;
    }
    __syncthreads();
    for (int o = warp; o < m * 4; o += NWARPS) {
      const int j = o >> 2, q = o & 3;
      float acc = 0.0f;
      for (int k = lane; k < CHUNK; k += 32) {
        const float pk = S.p[j * CHUNK + k];
        acc += q == 0 ? pk : pk * S.xs[k * 3 + q - 1];
      }
      acc = td_warp_sum(acc);
      if (lane == 0) S.acc[o] += acc;
    }
    __syncthreads();
  }
  S.red[tid] = np_loc;
  S.red2[tid] = trx_loc;
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (tid < h) {
      S.red[tid] += S.red[tid + h];
      S.red2[tid] += S.red2[tid + h];
    }
  }
  __syncthreads();
  const float np_total = S.red[0], tr_x = S.red2[0];

  // Phase 2: the M-step system [A | B] (inactive nodes: identity rows, zero
  // right-hand sides).
  const int width = m + 3;
  const float lam_s2 = A.lam * s2;
  const float lle_s2 = s2 * A.coef_lle;
  for (int k = tid; k < m * width; k += THREADS) {
    const int r = k / width, c = k % width;
    float v;
    if (c < m) {
      if (S.nm[r] > 0.0f && S.nm[c] > 0.0f) {
        const size_t e = mm + (size_t)r * m + c;
        v = S.acc[r * 4] * A.g[e] + (r == c ? lam_s2 : 0.0f);
        v = v + lle_s2 * A.hg[e];
        v = v + A.alpha * A.jg[e];
      } else {
        v = r == c ? 1.0f : 0.0f;
      }
    } else {
      const int d = c - m;
      const size_t e = m3 + (size_t)r * 3 + d;
      v = S.acc[r * 4 + 1 + d] - S.acc[r * 4] * S.y0[r * 3 + d];
      v = v - lle_s2 * A.hy0[e];
      v = v + A.alpha * A.pd[e];
      v = v * S.nm[r];
    }
    S.aug[k] = v;
  }
  for (int k = tid; k < m; k += THREADS) S.used[k] = 0.0f;
  __syncthreads();

  // The one-hot Gauss-Jordan elimination.
  for (int k = 0; k < m; ++k) {
    if (warp == 0) {
      float bv = -2.0f;
      int br = m;
      for (int r = lane; r < m; r += 32) {
        const float cand = S.used[r] > 0.0f ? -1.0f : fabsf(S.aug[r * width + k]);
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
        S.ridx = br;
        S.pivot = S.aug[br * width + k];
      }
    }
    __syncthreads();
    const int ridx = S.ridx;
    const float pv = S.pivot;
    const float pv_safe = pv == 0.0f ? 1.0f : pv;
    if (tid < m) S.factor[tid] = tid == ridx ? 0.0f : S.aug[tid * width + k] / pv_safe;
    __syncthreads();
    for (int q = tid; q < m * width; q += THREADS) {
      const int r = q / width, c = q % width;
      if (r != ridx) S.aug[q] = S.aug[q] - S.factor[r] * S.aug[ridx * width + c];
    }
    if (tid == 0) {
      S.used[ridx] = 1.0f;
      S.perm[k] = ridx;
      S.diag[k] = pv;
    }
    __syncthreads();
  }
  for (int q = tid; q < m * 3; q += THREADS) {
    const int k = q / 3, d = q % 3;
    const float dg = fabsf(S.diag[k]) < 1e-30f ? 1.0f : S.diag[k];
    S.w[q] = S.aug[S.perm[k] * width + m + d] / dg;
  }
  __syncthreads();

  // T = Y0 + G W (inactive rows keep Y0).
  for (int q = tid; q < m * 3; q += THREADS) {
    const int r = q / 3, d = q % 3;
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) acc = acc + A.g[mm + (size_t)r * m + j] * S.w[j * 3 + d];
    const float tv = S.nm[r] > 0.0f ? S.y0[q] + acc : S.y0[q];
    S.tn[q] = tv;
    A.t[m3 + q] = tv;
  }
  __syncthreads();

  // The σ² update and the mean node move.
  if (tid == 0) {
    float tr_pxt = 0.0f, tr_tt = 0.0f, move = 0.0f;
    for (int r = 0; r < m; ++r) {
      float mv = 0.0f;
      for (int d = 0; d < 3; ++d) {
        const float tv = S.tn[r * 3 + d];
        tr_pxt += S.acc[r * 4 + 1 + d] * tv;
        tr_tt += S.acc[r * 4] * tv * tv;
        const float dm = tv - S.y[r * 3 + d];
        mv += dm * dm;
      }
      move += sqrtf(mv) * S.nm[r];
    }
    const float s2n = (tr_x - 2.0f * tr_pxt + tr_tt) / fmaxf(np_total * 3.0f, 1e-30f);
    A.stats[(size_t)s * 2] = fmaxf(s2n, 1e-10f);
    A.stats[(size_t)s * 2 + 1] = move / fmaxf(v_count_f, 1.0f);
  }
}

}  // namespace

extern "C" int trackdlo_em_iter(const float* scal, const float* y, const float* y0,
                                const float* coord, const float* nm, const float* g,
                                const float* hg, const float* hy0, const float* jg,
                                const float* pd, const float* x, const float* xm, int n_streams,
                                int m, int n, float k_vis, float tau_vis, float lam,
                                float coef_lle, float alpha, float* t, float* stats,
                                void* stream) {
  if (m < 1 || m > MMAX || n < 0 || n_streams < 0 || n_streams > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_streams == 0) return 0;
  FArgs a{scal, y, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, m, n,
          k_vis, tau_vis, lam, coef_lle, alpha, t, stats};
  const int smem = (int)sizeof(Smem);
  cudaError_t err =
      cudaFuncSetAttribute(em_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  em_iter_kernel<<<n_streams, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
