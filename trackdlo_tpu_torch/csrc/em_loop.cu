// Kernel E: the whole tolerance EM loop of one registration pass.
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py fused_em_loop
// (_em_loop_kernel, _gj2d_with_inv, _estep_probabilities).
//
// What bounds it on an H100: chains of dependent steps, not bytes or FLOPs.
// One pass moves ~50 KB of points per iteration and does ~1 MFLOP of E-step
// work, but the iterations are strictly sequential, each E-step is a chain
// per point (two normalisations over the nodes), and the 45x45 M-step solve
// is a chain of 45 dependent pivot steps. The TPU kernel kept the whole (48,
// n) affinity block resident (~786 KB); a Hopper block has 227 KB of shared
// memory.
//
// Design: one launch per pass, run as one thread-block cluster of C CTAs (C
// and each CTA's rows a function of n alone, estep_cluster.cuh); every
// iteration stays on the device.
// - E-step: each CTA works only on its own compacted valid points, four
//   lanes per point, so a pass is one short chain per CTA instead of one
//   long chain per 512-row chunk; visibility minima and the P1/PX/Np/trace
//   sums are reduced over the cluster through distributed shared memory in
//   rank order (estep_cluster.cuh).
// - M-step: every CTA builds and solves the same system from the same
//   totals (gj.cuh: one barrier per pivot step, only the live columns
//   updated) and computes T, sigma^2 and the move itself, so there is no
//   broadcast and no round trip through global memory; the convergence test
//   reads only those identical values, so every CTA leaves the loop
//   together. The sigma^2 and move sums run in one warp in a fixed order.
// - The two products B1 takes with _exact_dot, the refinement's A w and
//   T's G W, are taken as it takes them (gj.cuh, exact_split_dot), from
//   bfloat16 pieces of A (split once per iteration), of G (once per launch)
//   and of W. Both cancel heavily on the pre-registration systems: float32
//   products there put noise of the order of the tolerance into every
//   iteration (ROADMAP, fault 1).
// The arithmetic is the plain version's: the divisions stay divisions, and
// no float atomics are used, so results are identical run to run.
#include "estep_cluster.cuh"
#include "gj.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MMAX = td::EC_MMAX;
constexpr int THREADS = 512;
constexpr float TWO_PI = 6.283185307179586f;

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
  float y0[MMAX * 3], hy0[MMAX * 3], pd[MMAX * 3];
  float g[MMAX * MMAX], hg[MMAX * MMAX], jg[MMAX * MMAX];
  float a[MMAX * MMAX];  // the M-step system A w = B
  float b[MMAX * 3], w[MMAX * 3], t[MMAX * 3];
  float asp[3 * MMAX * MMAX], gsp[3 * MMAX * MMAX], wsp[3 * MMAX * 3];  // split3 pieces
  td::GjSmem gj;
  td::EstepSmem<THREADS> es;  // the iterate y, coord, node mask, the points
  float s2, delta;
  int it, done, converged;
};
static_assert(MMAX == td::GJ_MMAX, "kernel E and the shared solve differ in MMAX");

__global__ void __launch_bounds__(THREADS, 1) em_loop_kernel(EmArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  td::EstepSmem<THREADS>& E = S.es;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = A.m, n = A.n;

  for (int k = tid; k < MMAX * 3; k += THREADS) {
    const bool in = k < m * 3;
    S.y0[k] = in ? A.y0[k] : 0.0f;
    E.y[k] = in ? A.y0[k] : 0.0f;
    S.hy0[k] = in ? A.hy0[k] : 0.0f;
    S.pd[k] = in ? A.pd[k] : 0.0f;
  }
  for (int k = tid; k < m * m; k += THREADS) {
    S.g[k] = A.g[k];
    S.hg[k] = A.hg[k];
    S.jg[k] = A.jg[k];
    td::split3(A.g[k], S.gsp[k], S.gsp[m * m + k], S.gsp[2 * m * m + k]);
  }
  for (int k = tid; k < MMAX; k += THREADS) {
    E.coord[k] = k < m ? A.coord[k] : 0.0f;
    E.nm[k] = k < m ? A.nm[k] : 0.0f;
    E.pv[k] = 0.0f;
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
  const int rows = td::ec_rows_per_cta(n);
  const int r0 = min(n, (int)cluster.block_rank() * rows);
  const int npts = td::ec_compact(A.x, A.xm, r0, min(n, r0 + rows), E);  // ends in a barrier

  while (!S.done && S.it < A.max_iter) {
    const int buf = S.it & 1;
    const float s2 = S.s2;
    const float tps = TWO_PI * s2;
    const float c_core = tps * sqrtf(tps);
    const float c_plain = kc_v * c_core;
    const float c_vis = kc_n * c_core;
    const td::EcScalars sc{s2, 0.0f, c_plain, gate > 0.0f ? c_vis : c_plain, gate,
                           v_count, m, m};

    // Visibility prior: each node's nearest valid point (only read when the
    // gate is on; with the gate off the prior multiplies nothing).
    if (gate > 0.0f) {
      td::ec_cluster_minima(m, npts, buf, E, cluster);
      td::ec_visibility_weights(m, A.k_vis, A.tau_vis, E);
    }
    td::ec_estep_partials<false, false>(sc, npts, buf, E);
    cluster.sync();
    td::ec_cluster_totals(m, buf, E, cluster);
    const float* p1 = E.tot;               // P1[r]
    const float* px = E.tot + m;           // PX[d][r] at px[d * m + r]
    const float np_total = E.tot[4 * m];
    const float tr_x = E.tot[4 * m + 1];

    // M-step system A w = B.
    const float lam_s2 = A.lam * s2;
    const float lle_s2 = s2 * A.coef_lle;
    for (int k = tid; k < m * m; k += THREADS) {
      const int r = k / m, c = k - r * m;
      float v;
      if (E.nm[r] > 0.0f && E.nm[c] > 0.0f) {
        v = p1[r] * S.g[k] + (r == c ? lam_s2 : 0.0f);
        v = v + lle_s2 * S.hg[k];
        v = v + A.alpha * S.jg[k];
      } else {
        v = r == c ? 1.0f : 0.0f;
      }
      S.a[k] = v;
      td::split3(v, S.asp[k], S.asp[m * m + k], S.asp[2 * m * m + k]);
    }
    for (int k = tid; k < m * 3; k += THREADS) {
      const int r = k / 3, d = k - r * 3;
      float v = px[d * m + r] - p1[r] * S.y0[k];
      v = v - lle_s2 * S.hy0[k];
      v = v + A.alpha * S.pd[k];
      S.b[k] = v * E.nm[r];
    }
    __syncthreads();
    td::gj_solve<THREADS, td::GjScale::kExponentBits>(m, S.a, S.b, S.w, S.gj, S.asp, S.wsp);
    // T = Y0 + G W (inactive rows stay at Y0).
    td::split3_all<THREADS>(m * 3, S.w, S.wsp);
    __syncthreads();
    for (int q = tid; q < m * 3; q += THREADS) {
      const int r = q / 3, d = q - r * 3;
      const float acc = td::exact_split_dot(m, S.gsp, m * m, r, S.wsp, m * 3, d);
      S.t[q] = E.nm[r] > 0.0f ? S.y0[q] + acc : S.y0[q];
    }
    __syncthreads();
    // sigma^2 and the mean node move: rows lane and lane + 32 per lane, then
    // a shuffle tree (every lane the same bits).
    if (warp == 0) {
      float tr_pxt = 0.0f, tr_tt = 0.0f, move = 0.0f;
      for (int r = lane; r < m; r += 32) {
        float mv = 0.0f;
        for (int d = 0; d < 3; ++d) {
          const float tv = S.t[r * 3 + d];
          tr_pxt += px[d * m + r] * tv;
          tr_tt += p1[r] * tv * tv;
          const float dm = tv - E.y[r * 3 + d];
          mv += dm * dm;
        }
        move += sqrtf(mv) * E.nm[r];
      }
      tr_pxt = td_warp_allsum(tr_pxt);
      tr_tt = td_warp_allsum(tr_tt);
      move = td_warp_allsum(move);
      if (lane == 0) {
        const float s2n = (tr_x - 2.0f * tr_pxt + tr_tt) / fmaxf(np_total * 3.0f, 1e-30f);
        S.s2 = fmaxf(s2n, 1e-10f);
        const float delta = move / vcf;
        S.delta = delta;
        S.done = delta < A.tol;
        S.converged = S.done || (S.it + 1 < A.max_iter);
        S.it = S.it + 1;
      }
    }
    __syncthreads();
    for (int q = tid; q < m * 3; q += THREADS) E.y[q] = S.t[q];
    __syncthreads();
  }
  // No CTA leaves while another may still read its shared memory.
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int q = tid; q < m * 3; q += THREADS) A.y_out[q] = E.y[q];
    if (tid == 0) {
      A.stats[0] = S.s2;
      A.stats[1] = (float)S.it;
      A.stats[2] = S.converged ? 1.0f : 0.0f;
      A.stats[3] = S.delta;
    }
  }
}

// The launch configuration for n rows: C CTAs, one cluster.
cudaError_t em_loop_config(int n, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err =
      cudaFuncSetAttribute(em_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int c = td::ec_cluster_size(n);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(c);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" int trackdlo_em_loop(
    const float* dyn, const float* y0, const float* coord, const float* nm,
    const float* g, const float* hg, const float* hy0, const float* jg,
    const float* pd, const float* x, const float* xm, int m, int n, float muf,
    float k_vis, float tau_vis, float lam, float coef_lle, float alpha,
    float tol, int max_iter, float* y_out, float* stats, void* stream) {
  if (m < 1 || m > MMAX || n < 0 || td::ec_rows_per_cta(n) > td::EC_PMAX)
    return (int)cudaErrorInvalidValue;
  EmArgs a{dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, m, n,
           muf, k_vis, tau_vis, lam, coef_lle, alpha, tol, max_iter, y_out, stats};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = em_loop_config(n, &cfg, &attr, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, em_loop_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// For n rows: out[0] the cluster size, out[1] the rows per CTA, out[2] how
// many such clusters the card can hold at once.
extern "C" int trackdlo_em_loop_cluster_info(int n, int* out) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = em_loop_config(n, &cfg, &attr, nullptr);
  if (err != cudaSuccess) return (int)err;
  out[0] = td::ec_cluster_size(n);
  out[1] = td::ec_rows_per_cta(n);
  return (int)cudaOccupancyMaxActiveClusters(&out[2], em_loop_kernel, &cfg);
}
