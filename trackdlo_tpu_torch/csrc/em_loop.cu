// Kernel E: the whole tolerance EM loop of one registration pass.
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py fused_em_loop
// (_em_loop_kernel, _gj2d_with_inv, _estep_probabilities).
//
// What bounds it on an H100: latency, not bytes or FLOPs. One pass moves
// ~50 KB of points per iteration and does ~1 MFLOP of E-step work, but the
// iterations are strictly sequential and the 45x45 M-step solve is a chain
// of 45 dependent pivot steps. The TPU kernel kept the whole (48, n) affinity
// block resident (~786 KB); a Hopper block has 227 KB of shared memory.
//
// Design: one CTA of 512 threads runs every iteration on the device (one
// launch per pass, no host round trip). Points stream through in chunks of
// 512, one point per thread: a point's two normalisations and its geodesic
// re-distance only need that point's column over the nodes, so each thread
// keeps its 48 memberships in registers. The chunk's final memberships go to
// shared memory, where one warp per (node, quantity) sums them in a fixed
// lane order and a shuffle tree; per-point sums use a fixed-order block tree.
// No float atomics, so results are identical run to run. The M-step builds
// A and B in shared memory and runs the equilibrated Gauss-Jordan solve with
// partial pivoting, the inverse and three refinement steps (gj.cuh, the
// device code kernel G runs too).
#include "gj.cuh"

namespace {

constexpr int MMAX = 48;
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int CHUNK = THREADS;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float BIG = 1e5f;

struct EmArgs {
  const float* dyn;  // [4]: sigma2, v_count, n_safe, vis_gate
  const float* y0;   // (m, 3)
  const float* coord;
  const float* nm;   // (m,) 0/1
  const float* g;    // (m, m)
  const float* hg;
  const float* hy0;  // (m, 3)
  const float* jg;
  const float* pd;
  const float* x;    // (n, 3)
  const float* xm;   // (n,) 0/1
  int m, n;
  float muf, k_vis, tau_vis, lam, coef_lle, alpha, tol;
  int max_iter;
  float* y_out;  // (m, 3)
  float* stats;  // [4]: sigma2, iterations, converged, delta
};

struct Smem {
  float y[MMAX * 3], y0[MMAX * 3], coord[MMAX], nm[MMAX], pv[MMAX];
  float g[MMAX * MMAX], hg[MMAX * MMAX], jg[MMAX * MMAX];
  float hy0[MMAX * 3], pd[MMAX * 3];
  float p[MMAX * CHUNK];    // memberships of the current chunk
  float xs[CHUNK * 3];      // the chunk's points
  float acc[MMAX * 4];      // per node: P1, PX0, PX1, PX2
  float a[MMAX * MMAX];     // the M-step system A w = B
  float b[MMAX * 3], w[MMAX * 3], t[MMAX * 3];
  td::GjSmem gj;
  float red[THREADS], red2[THREADS];
  float wmin[NWARPS * MMAX];
  float s2, delta;
  int it, done, converged;
};
static_assert(MMAX == td::GJ_MMAX, "kernel E and the shared solve differ in MMAX");

__device__ __forceinline__ float sq_dist(const float* y, int j, float x0, float x1, float x2) {
  float d0 = y[j * 3 + 0] - x0, d1 = y[j * 3 + 1] - x1, d2 = y[j * 3 + 2] - x2;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

// Fixed-order block tree sum of red[0..THREADS); result in red[0].
__device__ void block_sum2(float* red, float* red2) {
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (threadIdx.x < s) {
      red[threadIdx.x] += red[threadIdx.x + s];
      red2[threadIdx.x] += red2[threadIdx.x + s];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1) em_loop_kernel(EmArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = A.m, n = A.n;

  for (int k = tid; k < m * 3; k += THREADS) {
    S.y0[k] = A.y0[k];
    S.y[k] = A.y0[k];
    S.hy0[k] = A.hy0[k];
    S.pd[k] = A.pd[k];
  }
  for (int k = tid; k < m * m; k += THREADS) {
    S.g[k] = A.g[k];
    S.hg[k] = A.hg[k];
    S.jg[k] = A.jg[k];
  }
  for (int k = tid; k < m; k += THREADS) {
    S.coord[k] = A.coord[k];
    S.nm[k] = A.nm[k];
  }
  const float v_count_f = A.dyn[1];
  const float n_safe = A.dyn[2];
  const float gate = A.dyn[3];
  const int v_count = (int)v_count_f;
  const float kc_v = A.muf * v_count_f / n_safe;
  const float kc_n = A.muf / n_safe;
  const float vcf = fmaxf(v_count_f, 1.0f);
  if (tid == 0) {
    S.s2 = A.dyn[0];
    S.it = 0;
    S.done = 0;
    S.converged = 1;
    S.delta = 0.0f;
  }
  __syncthreads();

  while (!S.done && S.it < A.max_iter) {
    const float s2 = S.s2;
    const float tps = TWO_PI * s2;
    const float c_core = tps * sqrtf(tps);
    const float c_plain = kc_v * c_core;
    const float c_vis = kc_n * c_core;
    const float c_eff = gate > 0.0f ? c_vis : c_plain;

    // Visibility prior: per-node nearest valid point (only read when the
    // gate is on; with the gate off the prior multiplies nothing).
    if (gate > 0.0f) {
      for (int j = 0; j < m; ++j) {
        float mn = BIG;
        for (int i = tid; i < n; i += THREADS) {
          if (A.xm[i] > 0.0f && S.nm[j] > 0.0f)
            mn = fminf(mn, sq_dist(S.y, j, A.x[i * 3], A.x[i * 3 + 1], A.x[i * 3 + 2]));
        }
        mn = td_warp_min(mn);
        if (lane == 0) S.wmin[warp * MMAX + j] = mn;
      }
      __syncthreads();
      if (tid == 0) {
        float total = 0.0f;
        for (int j = 0; j < m; ++j) {
          float mn = BIG;
          for (int w = 0; w < NWARPS; ++w) mn = fminf(mn, S.wmin[w * MMAX + j]);
          float shortest = sqrtf(mn);
          if (shortest <= A.tau_vis) shortest = 0.0f;
          float pv = S.nm[j] > 0.0f ? expf(-A.k_vis * shortest) : 0.0f;
          S.pv[j] = pv;
          total += pv;
        }
        total = fmaxf(total, 1e-30f);
        for (int j = 0; j < m; ++j) S.pv[j] = S.pv[j] / total;
      }
    }
    for (int k = tid; k < m * 4; k += THREADS) S.acc[k] = 0.0f;
    float np_loc = 0.0f, trx_loc = 0.0f;
    __syncthreads();

    // E-step, one chunk of points at a time.
    for (int base = 0; base < n; base += CHUNK) {
      const int i = base + tid;
      const bool valid = i < n && A.xm[i] > 0.0f;
      float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
      if (valid) {
        x0 = A.x[i * 3];
        x1 = A.x[i * 3 + 1];
        x2 = A.x[i * 3 + 2];
      }
      S.xs[tid * 3] = x0;
      S.xs[tid * 3 + 1] = x1;
      S.xs[tid * 3 + 2] = x2;
      float p[MMAX];
      if (valid) {
        // First normalisation.
        float sum1 = 0.0f;
#pragma unroll
        for (int j = 0; j < MMAX; ++j) {
          float e = 0.0f;
          if (j < m && S.nm[j] > 0.0f) e = expf(-0.5f * sq_dist(S.y, j, x0, x1, x2) / s2);
          p[j] = e;
          sum1 += e;
        }
        const float den1 = sum1 + c_plain;
        // First argmax of the normalised memberships (lowest row on ties).
        int mp = 0;
        float best = -1.0f;
#pragma unroll
        for (int j = 0; j < MMAX; ++j) {
          if (j < m) {
            float q = S.nm[j] > 0.0f ? p[j] / den1 : -1.0f;
            if (q > best) {
              best = q;
              mp = j;
            }
          }
        }
        // Anchor pair with the reference's boundary fallbacks. A row
        // outside [0, m) selects 0 (v_count < 3 makes cand2 negative).
        const int cand1 = (mp - 1 == -1) ? 2 : mp - 1;
        const int cand2 = (mp + 1 == v_count) ? v_count - 3 : mp + 1;
        auto sel_sq = [&](int r) {
          return (r >= 0 && r < m) ? sq_dist(S.y, r, x0, x1, x2) : 0.0f;
        };
        auto sel_coord = [&](int r) { return (r >= 0 && r < m) ? S.coord[r] : 0.0f; };
        const int nxt = sel_sq(cand1) < sel_sq(cand2) ? cand1 : cand2;
        const int lo = min(mp, nxt), hi = max(mp, nxt);
        const float d_lo = sqrtf(sel_sq(lo)), d_hi = sqrtf(sel_sq(hi));
        const float c_lo = sel_coord(lo), c_hi = sel_coord(hi);
        // Geodesic re-distance (zero band strictly between the anchors),
        // second pass with the visibility prior, second normalisation.
        float sum2 = 0.0f;
#pragma unroll
        for (int j = 0; j < MMAX; ++j) {
          float e = 0.0f;
          if (j < m && S.nm[j] > 0.0f) {
            float geo;
            if (j < lo) {
              float u = fabsf(S.coord[j] - c_lo) + d_lo;
              geo = u * u;
            } else if (j >= hi) {
              float u = fabsf(S.coord[j] - c_hi) + d_hi;
              geo = u * u;
            } else if (j == lo) {
              geo = d_lo * d_lo;
            } else {
              geo = 0.0f;
            }
            e = expf(-0.5f * geo / s2);
            if (gate > 0.0f) e = e * S.pv[j];
          }
          p[j] = e;
          sum2 += e;
        }
        const float den2 = sum2 + c_eff;
        float pt1 = 0.0f;
#pragma unroll
        for (int j = 0; j < MMAX; ++j) {
          if (j < m) {
            float q = p[j] / den2;
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
      // P1 and PX over the chunk: one warp per (node, quantity).
      for (int o = warp; o < m * 4; o += NWARPS) {
        const int j = o >> 2, q = o & 3;
        float s = 0.0f;
        for (int k = lane; k < CHUNK; k += 32) {
          float pv = S.p[j * CHUNK + k];
          s += q == 0 ? pv : pv * S.xs[k * 3 + q - 1];
        }
        s = td_warp_sum(s);
        if (lane == 0) S.acc[o] += s;
      }
      __syncthreads();
    }
    S.red[tid] = np_loc;
    S.red2[tid] = trx_loc;
    block_sum2(S.red, S.red2);
    const float np_total = S.red[0];
    const float tr_x = S.red2[0];

    // M-step system A w = B.
    const float lam_s2 = A.lam * s2;
    const float lle_s2 = s2 * A.coef_lle;
    for (int k = tid; k < m * m; k += THREADS) {
      const int r = k / m, c = k % m;
      float v;
      if (S.nm[r] > 0.0f && S.nm[c] > 0.0f) {
        v = S.acc[r * 4] * S.g[k] + (r == c ? lam_s2 : 0.0f);
        v = v + lle_s2 * S.hg[k];
        v = v + A.alpha * S.jg[k];
      } else {
        v = r == c ? 1.0f : 0.0f;
      }
      S.a[k] = v;
    }
    for (int k = tid; k < m * 3; k += THREADS) {
      const int r = k / 3, d = k % 3;
      float v = S.acc[r * 4 + 1 + d] - S.acc[r * 4] * S.y0[k];
      v = v - lle_s2 * S.hy0[k];
      v = v + A.alpha * S.pd[k];
      S.b[k] = v * S.nm[r];
    }
    __syncthreads();
    td::gj_solve<THREADS, td::GjScale::kExponentBits>(m, S.a, S.b, S.w, S.gj);
    // T = Y0 + G W (inactive rows stay at Y0).
    for (int q = tid; q < m * 3; q += THREADS) {
      const int r = q / 3, d = q % 3;
      float acc = 0.0f;
      for (int j = 0; j < m; ++j) acc = fmaf(S.g[r * m + j], S.w[j * 3 + d], acc);
      S.t[q] = S.nm[r] > 0.0f ? S.y0[q] + acc : S.y0[q];
    }
    __syncthreads();
    if (tid == 0) {
      float tr_pxt = 0.0f, tr_tt = 0.0f, move = 0.0f;
      for (int r = 0; r < m; ++r) {
        float mv = 0.0f;
        for (int d = 0; d < 3; ++d) {
          const float tv = S.t[r * 3 + d];
          tr_pxt += S.acc[r * 4 + 1 + d] * tv;
          tr_tt += S.acc[r * 4] * tv * tv;
          const float dm = tv - S.y[r * 3 + d];
          mv += dm * dm;
        }
        move += sqrtf(mv) * S.nm[r];
      }
      float s2n = (tr_x - 2.0f * tr_pxt + tr_tt) / fmaxf(np_total * 3.0f, 1e-30f);
      S.s2 = fmaxf(s2n, 1e-10f);
      const float delta = move / vcf;
      S.delta = delta;
      S.done = delta < A.tol;
      S.converged = S.done || (S.it + 1 < A.max_iter);
      S.it = S.it + 1;
    }
    __syncthreads();
    for (int q = tid; q < m * 3; q += THREADS) S.y[q] = S.t[q];
    __syncthreads();
  }
  for (int q = tid; q < m * 3; q += THREADS) A.y_out[q] = S.y[q];
  if (tid == 0) {
    A.stats[0] = S.s2;
    A.stats[1] = (float)S.it;
    A.stats[2] = S.converged ? 1.0f : 0.0f;
    A.stats[3] = S.delta;
  }
}

}  // namespace

extern "C" int trackdlo_em_loop(
    const float* dyn, const float* y0, const float* coord, const float* nm,
    const float* g, const float* hg, const float* hy0, const float* jg,
    const float* pd, const float* x, const float* xm, int m, int n, float muf,
    float k_vis, float tau_vis, float lam, float coef_lle, float alpha,
    float tol, int max_iter, float* y_out, float* stats, void* stream) {
  if (m < 1 || m > MMAX || n < 0) return (int)cudaErrorInvalidValue;
  EmArgs a{dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, m, n,
           muf, k_vis, tau_vis, lam, coef_lle, alpha, tol, max_iter, y_out, stats};
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      em_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  em_loop_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
