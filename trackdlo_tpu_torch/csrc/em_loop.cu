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
//
// Node bound: the kernel is compiled for at most 48 nodes (the layout
// above) and for at most 128. At 128 the three (m, m) inputs, A, and their
// pieces (~450 KB) do not fit in shared memory: G, HG and JG stay in global
// memory (L2), A's entries are formed from them where the solve reads them
// and cut into pieces there (the same operations, so the same values), and
// [A | I | B] lives in the E-step's scratch, which is free during the
// M-step. Past 128 nodes the unbounded build runs (unbounded.cuh): the
// system and every node-indexed array in a global workspace, the solve
// spread over the cluster, each CTA eliminating its own rows.
//
// Rows: a CTA holds EC_PMAX compacted rows; a CTA whose range is longer
// (more than 16,384 rows in all) compacts and processes it a tile of
// EC_PMAX rows at a time, in row order, every pass (the sums' order, and so
// their bits, are those of one long tile).
#include "unbounded.cuh"

namespace {

namespace cg = cooperative_groups;

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

template <int MM, bool NARROW = (MM <= td::EC_MMAX)>
struct Smem {
  float y0[MM * 3], hy0[MM * 3], pd[MM * 3];
  float g[MM * MM], hg[MM * MM], jg[MM * MM];
  float a[MM * MM];  // the M-step system A w = B
  float b[MM * 3], w[MM * 3], t[MM * 3];
  float asp[3 * MM * MM], gsp[3 * MM * MM], wsp[3 * MM * 3];  // split3 pieces
  td::GjSmem<MM> gj;
  td::EstepSmem<THREADS, MM> es;  // the iterate y, coord, node mask, the points
  float s2, delta;
  int it, done, converged;
};
// The wide layout: G, HG, JG and A are read where they are needed, and
// [A | I | B] lives in the E-step's scratch.
template <int MM>
struct Smem<MM, false> {
  float y0[MM * 3], hy0[MM * 3], pd[MM * 3];
  float b[MM * 3], w[MM * 3], t[MM * 3];
  float wsp[3 * MM * 3];
  td::GjSmem<MM> gj;
  td::EstepSmem<THREADS, MM, MM * td::gj_wmax(MM)> es;
  float s2, delta;
  int it, done, converged;
};
static_assert(td::EC_MMAX == td::GJ_MMAX && td::EC_MMAX_WIDE == td::GJ_MMAX_WIDE,
              "kernel E and the shared solve differ in their node bounds");

// The M-step matrix A of the wide layout, formed from G, HG and JG in global
// memory where it is read: the narrow layout's operations on the same
// operands.
struct EmMatrix {
  const float *g, *hg, *jg, *p1, *nm;
  int m;
  float lam_s2, lle_s2, alpha;
  __device__ __forceinline__ float value(int r, int c) const {
    if (nm[r] > 0.0f && nm[c] > 0.0f) {
      const int k = r * m + c;
      float v = p1[r] * g[k] + (r == c ? lam_s2 : 0.0f);
      v = v + lle_s2 * hg[k];
      v = v + alpha * jg[k];
      return v;
    }
    return r == c ? 1.0f : 0.0f;
  }
  __device__ __forceinline__ void get(int r, int c, float (&p)[3]) const {
    td::split3(value(r, c), p[0], p[1], p[2]);
  }
};

template <int MM>
__global__ void __launch_bounds__(THREADS, 1) em_loop_kernel(EmArgs A) {
  constexpr bool NARROW = MM <= td::EC_MMAX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MM>& S = *reinterpret_cast<Smem<MM>*>(smem_raw);
  auto& E = S.es;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = A.m, n = A.n;

  for (int k = tid; k < MM * 3; k += THREADS) {
    const bool in = k < m * 3;
    S.y0[k] = in ? A.y0[k] : 0.0f;
    E.y[k] = in ? A.y0[k] : 0.0f;
    S.hy0[k] = in ? A.hy0[k] : 0.0f;
    S.pd[k] = in ? A.pd[k] : 0.0f;
  }
  if constexpr (NARROW) {
    for (int k = tid; k < m * m; k += THREADS) {
      S.g[k] = A.g[k];
      S.hg[k] = A.hg[k];
      S.jg[k] = A.jg[k];
      td::split3(A.g[k], S.gsp[k], S.gsp[m * m + k], S.gsp[2 * m * m + k]);
    }
  }
  for (int k = tid; k < MM; k += THREADS) {
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
  const int r1 = min(n, r0 + rows);
  // The CTA's points stay compacted in shared memory for the whole loop
  // where they fit; else every pass takes them a tile at a time.
  const bool resident = rows <= td::EC_PMAX;
  int npts = 0;
  if (resident) npts = td::ec_compact(A.x, A.xm, r0, r1, E);  // ends in a barrier
  else __syncthreads();

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
      if (resident) td::ec_cluster_minima(m, npts, buf, E, cluster);
      else td::ec_cluster_minima_tiled(A.x, A.xm, r0, r1, m, buf, E, cluster);
      td::ec_visibility_weights(m, A.k_vis, A.tau_vis, E);
    }
    if (resident) td::ec_estep_partials<false, false>(sc, npts, buf, E);
    else td::ec_estep_partials_tiled<false, false>(sc, A.x, A.xm, r0, r1, buf, E);
    cluster.sync();
    td::ec_cluster_totals(m, buf, E, cluster);
    const float* p1 = E.tot;               // P1[r]
    const float* px = E.tot + m;           // PX[d][r] at px[d * m + r]
    const float np_total = E.tot[4 * m];
    const float tr_x = E.tot[4 * m + 1];

    // M-step system A w = B.
    const float lam_s2 = A.lam * s2;
    const float lle_s2 = s2 * A.coef_lle;
    if constexpr (NARROW) {
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
    }
    for (int k = tid; k < m * 3; k += THREADS) {
      const int r = k / 3, d = k - r * 3;
      float v = px[d * m + r] - p1[r] * S.y0[k];
      v = v - lle_s2 * S.hy0[k];
      v = v + A.alpha * S.pd[k];
      S.b[k] = v * E.nm[r];
    }
    __syncthreads();
    if constexpr (NARROW) {
      const td::DenseA am{S.a, td::SplitPieces{S.asp, m * m, m}, m};
      td::gj_solve<THREADS, td::GjScale::kExponentBits>(m, am, S.b, S.w, S.gj, S.gj.aug, S.wsp);
    } else {
      const EmMatrix am{A.g, A.hg, A.jg, p1, E.nm, m, lam_s2, lle_s2, A.alpha};
      td::gj_solve<THREADS, td::GjScale::kExponentBits>(m, am, S.b, S.w, S.gj, E.scratch, S.wsp);
    }
    // T = Y0 + G W (inactive rows stay at Y0).
    td::split3_all<THREADS>(m * 3, S.w, S.wsp);
    __syncthreads();
    for (int q = tid; q < m * 3; q += THREADS) {
      const int r = q / 3, d = q - r * 3;
      float acc;
      if constexpr (NARROW) {
        acc = td::exact_split_dot(m, td::SplitPieces{S.gsp, m * m, m}, r, S.wsp, m * 3, d);
      } else {
        acc = td::exact_split_dot(m, td::SplitOnRead{A.g, m}, r, S.wsp, m * 3, d);
      }
      S.t[q] = E.nm[r] > 0.0f ? S.y0[q] + acc : S.y0[q];
    }
    __syncthreads();
    // sigma^2 and the mean node move: rows lane, lane + 32, .. per lane,
    // then a shuffle tree (every lane the same bits).
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
template <int MM>
cudaError_t em_loop_config(int n, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<MM>);
  cudaError_t err = cudaFuncSetAttribute(em_loop_kernel<MM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

template <int MM>
int launch(const EmArgs& a, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = em_loop_config<MM>(a.n, &cfg, &attr, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, em_loop_kernel<MM>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The unbounded build (m > 128): unbounded.cuh's E-step and cluster solve.
// ---------------------------------------------------------------------------

// Its global workspace in floats: the cluster's shared part (the CTAs'
// float64 slots of partial sums, [A | I | B] in float64, the CTAs' minima,
// the row scales), then each CTA's own (the float64 totals and pivots, the
// iterate y, the totals rounded to float32, the visibility weights and
// minima, B, w, T, the residual, w's pieces and the rest of the solve's
// record). Every part starts with its float64 arrays and is an even number
// of floats, so every float64 array is 8-byte aligned.
__host__ __device__ inline size_t ub_shared_floats(int m) {
  const size_t c = td::EC_MAX_CLUSTER, w4 = 4 * (size_t)m + 2;
  const size_t n = 2 * c * w4 + 2 * (size_t)m * (2 * (size_t)m + 3) + c * m + m;
  return n + (n & 1);
}
__host__ __device__ inline size_t ub_private_floats(int m) {
  const size_t n = 3 * (4 * (size_t)m + 2) + 30 * (size_t)m;
  return n + (n & 1);
}

struct UbSmem {
  td::EcuSmem<THREADS> es;
  td::GjcSmem<THREADS, double> gj;
  float s2, delta;
  int it, done, converged;
};

__global__ void __launch_bounds__(THREADS, 1) em_loop_ub_kernel(EmArgs A, float* ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  UbSmem& S = *reinterpret_cast<UbSmem*>(smem_raw);
  unsigned char* tail = smem_raw + sizeof(UbSmem);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = A.m, n = A.n;
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const size_t w4 = 4 * (size_t)m + 2, width = 2 * (size_t)m + 3;
  double* part_all = reinterpret_cast<double*>(ws);
  double* aug = part_all + c * w4;
  float* cmin_all = reinterpret_cast<float*>(aug + (size_t)m * width);
  float* e = cmin_all + (size_t)c * m;
  double* tot = reinterpret_cast<double*>(ws + ub_shared_floats(m) +
                                          (size_t)rank * ub_private_floats(m));
  double* diag = tot + w4;
  float* y = reinterpret_cast<float*>(diag + m);
  float* tot32 = y + 3 * m;
  float* pv = tot32 + w4;
  float* gmin = pv + m;
  float* b = gmin + m;
  float* w = b + 3 * m;
  float* t = w + 3 * m;
  float* res = t + 3 * m;
  float* wsp = res + 3 * m;
  int* perm = reinterpret_cast<int*>(wsp + 9 * m);
  int* pos = perm + m;
  const td::GjcRecord<double> rec{perm, pos, diag};

  for (int k = tid; k < m * 3; k += THREADS) y[k] = A.y0[k];
  for (int k = tid; k < m; k += THREADS) pv[k] = 0.0f;
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
  const int rows = td::ub_rows_per_cta(n);
  const int r0 = min(n, rank * rows), r1 = min(n, r0 + rows);
  const td::EcuNodes nodes{y, A.coord, A.nm, pv, m};
  __syncthreads();

  while (!S.done && S.it < A.max_iter) {
    const float s2 = S.s2;
    const float tps = TWO_PI * s2;
    const float c_core = tps * sqrtf(tps);
    const float c_plain = kc_v * c_core;
    const float c_vis = kc_n * c_core;
    const td::EcScalars sc{s2, 0.0f, c_plain, gate > 0.0f ? c_vis : c_plain, gate,
                           v_count, m, m};
    if (gate > 0.0f) {
      td::ecu_minima<THREADS>(nodes, A.x, A.xm, r0, r1, S.es, cmin_all + (size_t)rank * m);
      td::ub_cluster_publish(cluster);
      td::ecu_cluster_minima<THREADS>(m, c, cmin_all, gmin);
      td::ecu_visibility_weights(m, A.k_vis, A.tau_vis, gmin, A.nm, pv);
    }
    td::ecu_partials<THREADS, false, false>(sc, nodes, A.x, A.xm, r0, r1, S.es,
                                            part_all + rank * w4);
    td::ub_cluster_publish(cluster);
    td::ecu_cluster_totals<THREADS>(m, c, part_all, tot, tot32);
    const float* p1 = tot32;
    const float* px = tot32 + m;
    const float lam_s2 = A.lam * s2;
    const float lle_s2 = s2 * A.coef_lle;
    for (int k = tid; k < m * 3; k += THREADS) {
      const int r = k / 3, d = k - r * 3;
      float v = px[d * m + r] - p1[r] * A.y0[k];
      v = v - lle_s2 * A.hy0[k];
      v = v + A.alpha * A.pd[k];
      b[k] = v * A.nm[r];
    }
    __syncthreads();
    const EmMatrix am{A.g, A.hg, A.jg, p1, A.nm, m, lam_s2, lle_s2, A.alpha};
    td::gjc_build_scaled<THREADS, td::GjScale::kExponentBits>(m, c, rank, am, b, aug, width, e);
    td::gjc_solve<THREADS, true>(m, cluster, aug, width, rec, S.gj, tail);
    td::gjc_extract<THREADS>(m, aug, width, 2 * m, rec, w);
    td::gjc_refine<THREADS>(m, am, b, w, e, aug, width, rec, wsp, res);
    // T = Y0 + G W (inactive rows stay at Y0), as the wide build.
    td::split3_all<THREADS>(m * 3, w, wsp);
    __syncthreads();
    for (int q = tid; q < m * 3; q += THREADS) {
      const int r = q / 3, d = q - r * 3;
      const float acc = td::exact_split_dot<true>(m, td::SplitOnRead{A.g, m}, r, wsp, m * 3, d);
      t[q] = A.nm[r] > 0.0f ? A.y0[q] + acc : A.y0[q];
    }
    __syncthreads();
    // The sigma^2 update (its traces in float64) and the mean move.
    if (warp == 0) {
      float s2n, move;
      td::ecu_sigma2(m, tot, t, y, A.nm, s2n, move);
      if (lane == 0) {
        S.s2 = s2n;
        const float delta = move / vcf;
        S.delta = delta;
        S.done = delta < A.tol;
        S.converged = S.done || (S.it + 1 < A.max_iter);
        S.it = S.it + 1;
      }
    }
    __syncthreads();
    for (int q = tid; q < m * 3; q += THREADS) y[q] = t[q];
    __syncthreads();
  }
  // No CTA leaves while another may still read its shared memory.
  cluster.sync();
  if (rank == 0) {
    for (int q = tid; q < m * 3; q += THREADS) A.y_out[q] = y[q];
    if (tid == 0) {
      A.stats[0] = S.s2;
      A.stats[1] = (float)S.it;
      A.stats[2] = S.converged ? 1.0f : 0.0f;
      A.stats[3] = S.delta;
    }
  }
}

cudaError_t em_loop_ub_config(int m, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                              cudaStream_t stream) {
  const int smem = (int)(sizeof(UbSmem) + td::ub_solve_tail_bytes<double>(m, td::EC_MAX_CLUSTER));
  cudaError_t err = cudaFuncSetAttribute(em_loop_ub_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(td::EC_MAX_CLUSTER);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = td::EC_MAX_CLUSTER;
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
  if (m < 1 || m > td::EC_MMAX_WIDE || n < 0) return (int)cudaErrorInvalidValue;
  const EmArgs a{dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, m, n,
                 muf, k_vis, tau_vis, lam, coef_lle, alpha, tol, max_iter, y_out, stats};
  return m <= td::EC_MMAX ? launch<td::EC_MMAX>(a, stream) : launch<td::EC_MMAX_WIDE>(a, stream);
}

// For n rows and m nodes: out[0] the cluster size, out[1] the rows per CTA,
// out[2] how many such clusters the card can hold at once, out[3] the
// shared memory of one CTA in bytes.
// The unbounded build (m > 128): ``ws`` a workspace of
// trackdlo_em_loop_workspace bytes.
extern "C" int trackdlo_em_loop_ub(
    const float* dyn, const float* y0, const float* coord, const float* nm,
    const float* g, const float* hg, const float* hy0, const float* jg,
    const float* pd, const float* x, const float* xm, int m, int n, float muf,
    float k_vis, float tau_vis, float lam, float coef_lle, float alpha,
    float tol, int max_iter, float* y_out, float* stats, void* ws, void* stream) {
  if (m < td::UB_MMIN || n < 0 || ws == nullptr) return (int)cudaErrorInvalidValue;
  const EmArgs a{dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, m, n,
                 muf, k_vis, tau_vis, lam, coef_lle, alpha, tol, max_iter, y_out, stats};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = em_loop_ub_config(m, &cfg, &attr, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, em_loop_ub_kernel, a, static_cast<float*>(ws));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The unbounded build's workspace in bytes for m nodes (0 where m takes a
// bounded build).
extern "C" int trackdlo_em_loop_workspace(int n_streams, int m, int n, long long* out) {
  if (m < 1 || n < 0 || n_streams < 0) return (int)cudaErrorInvalidValue;
  *out = m < td::UB_MMIN ? 0
                         : (long long)n_streams * 4 *
                               (long long)(ub_shared_floats(m) +
                                           td::EC_MAX_CLUSTER * ub_private_floats(m));
  return 0;
}

extern "C" int trackdlo_em_loop_cluster_info(int n, int m, int* out) {
  if (n < 0 || m < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (m >= td::UB_MMIN) {
    cudaError_t err = em_loop_ub_config(m, &cfg, &attr, nullptr);
    if (err != cudaSuccess) return (int)err;
    out[0] = td::EC_MAX_CLUSTER;
    out[1] = td::ub_rows_per_cta(n);
    out[3] = (int)cfg.dynamicSmemBytes;
    return (int)cudaOccupancyMaxActiveClusters(&out[2], em_loop_ub_kernel, &cfg);
  }
  const bool narrow = m <= td::EC_MMAX;
  cudaError_t err = narrow ? em_loop_config<td::EC_MMAX>(n, &cfg, &attr, nullptr)
                           : em_loop_config<td::EC_MMAX_WIDE>(n, &cfg, &attr, nullptr);
  if (err != cudaSuccess) return (int)err;
  out[0] = td::ec_cluster_size(n);
  out[1] = td::ec_rows_per_cta(n);
  out[3] = (int)cfg.dynamicSmemBytes;
  return narrow ? (int)cudaOccupancyMaxActiveClusters(&out[2], em_loop_kernel<td::EC_MMAX>, &cfg)
                : (int)cudaOccupancyMaxActiveClusters(&out[2], em_loop_kernel<td::EC_MMAX_WIDE>,
                                                      &cfg);
}
