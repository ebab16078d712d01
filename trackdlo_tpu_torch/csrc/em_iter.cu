// Kernel F: one whole EM iteration of B streams, the M-step solved in the
// same launch by a one-hot Gauss-Jordan elimination.
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py fused_em_iteration
// (_em_iteration_kernel, _estep_tile, _estep_probabilities,
// _onehot_gauss_jordan), which cpd_lle runs each iteration with
// CpdParams.use_fused_mstep; under jax.vmap its grid gains the stream axis.
//
// What bounds it on an H100: chains of dependent steps, not bytes or FLOPs.
// One iteration at M = 45 and 2048 rows (~360 valid) is ~0.1 M exponentials
// and a 45-step pivot chain (each step a search over the unused rows, then
// a rank-1 update of [A | B]) over ~70 KB of inputs. One block per stream
// paid a point's E-step chain once per 512-row chunk on one SM with most
// warps idle, then searched each pivot only after the whole update
// (perf/em_phase_stamps.py --only f: 70% of the launch in the E-step and its
// sums, 20% in the solve).
//
// Design: one thread-block cluster per stream, C CTAs of 512 threads (C and
// each CTA's rows a function of n alone, estep_cluster.cuh, so a stream's
// bits depend neither on the batch nor on the card).
// - E-step: the cluster E-step of kernels E and S (estep_cluster.cuh), with
//   the TPU function's own formulas: the exponent (-0.5 d^2) / sigma^2 (E's),
//   the gate blends p (1 + g (pv - 1)) and c_plain + g (c_vis - c_plain) and
//   masked nodes 0 in the second normalisation (S's), the anchor row select
//   over the zero pad rows up to m_pad. The minima sweep runs only where the
//   stream's gate is on (with the gate off the prior multiplies every
//   membership by exactly 1); the gate is the stream's, so every CTA of a
//   cluster runs the same barriers.
// - The c's: from sigma^2, v_count, n_safe and mu / (1 - mu) as kernel E
//   computes them, so a route iteration is this one launch; the JAX-shaped
//   entry passes its own c's instead.
// - Every CTA pushes its partial sums into CTA 0's shared memory before one
//   cluster barrier; past it no CTA reads another's memory, and all but CTA
//   0 leave. CTA 0 adds the partials in rank order (the bits of
//   ec_cluster_totals), builds [A | B] in the TPU kernel's operation order
//   (identity rows and zero right-hand sides for inactive nodes) from G, HG,
//   JG, HY0 and PD that cp.async fetched into its shared memory while the
//   E-step ran, and solves it.
// - The solve is _onehot_gauss_jordan's: at step k the pivot is the first
//   maximum of |A[:, k]| over the rows not yet used (used rows bid -1, so a
//   zero column still takes the first unused row), every other row is
//   eliminated in place (no swaps, no equilibration, no inverse, no
//   refinement), a zero pivot divides by 1, and W[k] = B[perm k] / pivot_k
//   with |pivot| < 1e-30 read as 1. The TPU pads the system to m_pad with
//   identity rows that never mix with the real ones and are never picked
//   for a real column, so the solve runs at m. Its step has gj.cuh's
//   structure: the last warp updates column k + 1 of every row and picks
//   step k + 1's pivot among those values (gj_pick), published
//   double-buffered by step parity, so a step has one barrier; the other
//   warps own the rows, a fixed group of threads per row, each dividing its
//   row's factor once and updating the live columns k + 2 .. m + 2. An
//   entry's update stays a - f * b, a multiply then a subtract under
//   -fmad=false, with f a true IEEE quotient: the values of the full sweep.
// - T = Y0 + G W (inactive rows keep Y0) as a float32 product from G in
//   shared memory, in order over j; sigma^2 (floored at 1e-10) and the mean
//   node move in one warp, rows lane and lane + 32 a lane, then shuffle
//   trees.
// No float atomics: a result is the same run to run.
//
// Node bound: compiled for at most 48 nodes (the layout above) and for at
// most 128, where G, HG and JG stay in global memory (L2) and are read
// where the system and T are formed (the same operations on the same
// operands), and the search warp holds four rows a lane. Past 128 nodes the
// unbounded build runs (unbounded.cuh): the node arrays, the cluster
// exchange and [A | B] in a global workspace, the one-hot elimination
// spread over the cluster (each CTA eliminating its own rows), T and sigma^2
// in CTA 0. A CTA holding more than EC_PMAX rows (more than 16,384 in all)
// takes them a tile at a time, in row order.
#include "unbounded.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr float TWO_PI = 6.283185307179586f;
// The widest row of [A | B]: m + 3 entries, padded by at most 31.
__host__ __device__ constexpr int f_wmax(int mm) { return mm + 3 + 31; }

struct FArgs {
  const float* s2;   // sigma2 of stream s at s2[s * s2_stride]
  const float* dyn;  // (B, 4): -, v_count, n_safe, visibility gate
  const float* cc;   // (B, 2): c_plain, c_vis; null: computed from s2, dyn and muf
  const float* y;    // (B, m, 3) current iterate
  const float* y0;   // (B, m, 3) EM origin
  const float* coord;  // (B, m)
  const float* nm;     // (B, m) 0/1
  const float* g;      // (B, m, m)
  const float* hg;     // (B, m, m)
  const float* hy0;    // (B, m, 3)
  const float* jg;     // (B, m, m)
  const float* pd;     // (B, m, 3)
  const float* x;      // (B, n, 3)
  const float* xm;     // (B, n) 0/1
  int s2_stride, m, n;
  float muf, k_vis, tau_vis, lam, coef_lle, alpha;
  float* t;      // (B, m, 3)
  float* stats;  // (B, 2): sigma2_new, delta
};

// The (m, m) inputs G, HG and JG, in shared memory in the narrow layout.
template <int MM, bool NARROW = (MM <= td::EC_MMAX)>
struct Mats {
  float g[MM * MM], hg[MM * MM], jg[MM * MM];
};
template <int MM>
struct Mats<MM, false> {};

template <int MM>
struct Smem {
  td::EstepSmem<THREADS, MM> es;  // the iterate y, coord, node mask, the points
  float part[td::EC_MAX_CLUSTER][td::EcShape<MM>::kNsum];  // every CTA's partial sums (CTA 0's copy)
  Mats<MM> mats;
  float y0[MM * 3], hy0[MM * 3], pd[MM * 3];
  float aug[MM * f_wmax(MM)];  // [A | B], row stride f_stride
  float w[MM * 3], t[MM * 3];
  float diag[MM];
  int perm[MM];     // the row pivoted at each step
  int piv_row[2];   // a step's pivot row and value, by step parity
  float piv_val[2];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// The row stride of [A | B]: at least m + 3 and equal to the threads per row
// modulo 32, so the threads of one warp, on consecutive rows, fall on
// distinct banks.
__device__ __forceinline__ int f_stride(int m, int per_row) {
  const int w = m + 3;
  return w + (((per_row - w) % 32) + 32) % 32;
}

// The search warp's pick of a step's pivot among its rows' values (row 0 if
// every candidate is NaN, as argmax gives); marks it used.
template <int RPL, int MM>
__device__ __forceinline__ int f_pick(int m, td::GjRows<MM>& used, const float (&col)[RPL],
                                      float& pv) {
  int ridx = td::gj_pick(m, used, col, pv);
  if (ridx >= m) ridx = 0;
  used.add(ridx);
  return ridx;
}

template <int MMAX>
__global__ void __launch_bounds__(THREADS, 1) em_iter_kernel(FArgs A) {
  constexpr bool NARROW = MMAX <= td::EC_MMAX;
  constexpr int RPL = (MMAX + 31) / 32;  // the search warp's rows a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MMAX>& S = *reinterpret_cast<Smem<MMAX>*>(smem_raw);
  auto& E = S.es;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / (int)cluster.num_blocks();
  const int m = A.m, n = A.n;
  const int m_pad = (m + 7) / 8 * 8;
  const size_t mm = (size_t)s * m * m, m3 = (size_t)s * m * 3, m1 = (size_t)s * m;

  // CTA 0's M-step inputs arrive while the E-step runs.
  if (rank == 0) {
    if constexpr (NARROW) {
      for (int k = tid; k < m * m; k += THREADS) {
        cp_async4(&S.mats.g[k], A.g + mm + k);
        cp_async4(&S.mats.hg[k], A.hg + mm + k);
        cp_async4(&S.mats.jg[k], A.jg + mm + k);
      }
    }
    for (int k = tid; k < m * 3; k += THREADS) {
      cp_async4(&S.y0[k], A.y0 + m3 + k);
      cp_async4(&S.hy0[k], A.hy0 + m3 + k);
      cp_async4(&S.pd[k], A.pd + m3 + k);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const float s2 = A.s2[(size_t)s * A.s2_stride];
  const float* dyn = A.dyn + (size_t)s * 4;
  const float v_count_f = dyn[1], n_safe = dyn[2], gate = dyn[3];
  // A CTA writes into another's shared memory only once every CTA of the
  // cluster has started: where the gate is on, the minima exchange's cluster
  // barrier sees to that; where it is off, this arrival, waited on just
  // before the push of the partial sums.
  if (!(gate > 0.0f)) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  float c_plain, c_vis;
  if (A.cc != nullptr) {
    c_plain = A.cc[(size_t)s * 2];
    c_vis = A.cc[(size_t)s * 2 + 1];
  } else {
    const float tps = TWO_PI * s2;
    const float c_core = tps * sqrtf(tps);
    c_plain = (A.muf * v_count_f / n_safe) * c_core;
    c_vis = (A.muf / n_safe) * c_core;
  }

  // Rows [m, MMAX) are zero, as the TPU's pad rows are.
  for (int k = tid; k < MMAX * 3; k += THREADS) E.y[k] = k < m * 3 ? A.y[m3 + k] : 0.0f;
  for (int k = tid; k < MMAX; k += THREADS) {
    const bool in = k < m;
    E.coord[k] = in ? A.coord[m1 + k] : 0.0f;
    E.nm[k] = in ? A.nm[m1 + k] : 0.0f;
    E.pv[k] = 0.0f;
    E.gmin[k] = td::EC_BIG;
  }
  const int rows = td::ec_rows_per_cta(n);
  const int r0 = min(n, rank * rows), r1 = min(n, r0 + rows);
  const float* xs = A.x + (size_t)s * n * 3;
  const float* xms = A.xm + (size_t)s * n;
  const bool resident = rows <= td::EC_PMAX;
  int npts = 0;
  if (resident) npts = td::ec_compact(xs, xms, r0, r1, E);  // ends in a barrier
  else __syncthreads();

  // The visibility prior: each node's nearest valid point, only where the
  // gate is on (with it off the blend multiplies by exactly 1).
  if (gate > 0.0f) {
    if (resident) td::ec_cluster_minima(m, npts, 0, E, cluster);
    else td::ec_cluster_minima_tiled(xs, xms, r0, r1, m, 0, E, cluster);
    td::ec_visibility_weights(m, A.k_vis, A.tau_vis, E);
  }
  const td::EcScalars sc{s2, 0.0f, c_plain, c_plain + gate * (c_vis - c_plain), gate,
                         (int)v_count_f, m_pad, m};
  if (resident) td::ec_estep_partials<false, true>(sc, npts, 1, E);
  else td::ec_estep_partials_tiled<false, true>(sc, xs, xms, r0, r1, 1, E);
  if (!(gate > 0.0f)) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = tid; i < 4 * m + 2; i += THREADS)
    cluster.map_shared_rank(&S.part[rank][0], 0)[i] = E.part[1][i];
  cluster.sync();
  // Past the barrier no CTA reads another's shared memory.
  if (rank != 0) return;

  const int c = (int)cluster.num_blocks();
  for (int i = tid; i < 4 * m + 2; i += THREADS) {
    float v = S.part[0][i];
    for (int r = 1; r < c; ++r) v += S.part[r][i];
    E.tot[i] = v;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float* p1 = E.tot;      // P1[r]
  const float* px = E.tot + m;  // PX[d][r] at px[d * m + r]
  const float np_total = E.tot[4 * m];
  const float tr_x = E.tot[4 * m + 1];

  // The M-step system [A | B] (inactive nodes: identity rows, zero
  // right-hand sides), in the TPU kernel's operation order.
  const int per_row = (THREADS - 32) / m;
  const int width = f_stride(m, per_row);
  const float lam_s2 = A.lam * s2;
  const float lle_s2 = s2 * A.coef_lle;
  const float* gm;
  const float* hgm;
  const float* jgm;
  if constexpr (NARROW) {
    gm = S.mats.g;
    hgm = S.mats.hg;
    jgm = S.mats.jg;
  } else {
    gm = A.g + mm;
    hgm = A.hg + mm;
    jgm = A.jg + mm;
  }
  for (int k = tid; k < m * (m + 3); k += THREADS) {
    const int r = k / (m + 3), col = k - r * (m + 3);
    float v;
    if (col < m) {
      if (E.nm[r] > 0.0f && E.nm[col] > 0.0f) {
        const int e = r * m + col;
        v = p1[r] * gm[e] + (r == col ? lam_s2 : 0.0f);
        v = v + lle_s2 * hgm[e];
        v = v + A.alpha * jgm[e];
      } else {
        v = r == col ? 1.0f : 0.0f;
      }
    } else {
      const int d = col - m, e = r * 3 + d;
      v = px[d * m + r] - p1[r] * S.y0[e];
      v = v - lle_s2 * S.hy0[e];
      v = v + A.alpha * S.pd[e];
      v = v * E.nm[r];
    }
    S.aug[r * width + col] = v;
  }
  __syncthreads();

  // The one-hot elimination, one barrier a step. The search warp's rows
  // (lane + 32 h) and their values of the current column; an update
  // thread's row (-1: none) and first column.
  const bool searcher = warp == NWARPS - 1;
  const int my_r = !searcher && tid < per_row * m ? tid / per_row : -1;
  const int my_g = tid - my_r * per_row;
  float col[RPL];
#pragma unroll
  for (int h = 0; h < RPL; ++h) col[h] = 0.0f;
  td::GjRows<MMAX> used;
  used.clear();
  if (searcher) {
#pragma unroll
    for (int h = 0; h < RPL; ++h) {
      const int r = lane + 32 * h;
      if (r < m) col[h] = S.aug[r * width];
    }
    float pv;
    const int ridx = f_pick(m, used, col, pv);
    if (lane == 0) {
      S.piv_row[0] = ridx;
      S.piv_val[0] = pv;
      S.perm[0] = ridx;
      S.diag[0] = pv;
    }
  }
  __syncthreads();
  for (int k = 0; k < m; ++k) {
    const int p = S.piv_row[k & 1];
    const float pv = S.piv_val[k & 1];
    const float pv_safe = pv == 0.0f ? 1.0f : pv;
    if (searcher) {
      // Column k + 1 of every row (the first B column at the last step),
      // then step k + 1's pivot among those values.
      const int cn = k + 1;
      float nxt[RPL];
#pragma unroll
      for (int h = 0; h < RPL; ++h) {
        nxt[h] = 0.0f;
        const int r = lane + 32 * h;
        if (r >= m) continue;
        const float xv = S.aug[r * width + cn];
        if (r == p) {
          nxt[h] = xv;
          continue;
        }
        const float f = col[h] / pv_safe;
        nxt[h] = xv - f * S.aug[p * width + cn];
        S.aug[r * width + cn] = nxt[h];
      }
#pragma unroll
      for (int h = 0; h < RPL; ++h) col[h] = nxt[h];
      if (k + 1 < m) {
        float pvn;
        const int ridx = f_pick(m, used, col, pvn);
        if (lane == 0) {
          S.piv_row[(k + 1) & 1] = ridx;
          S.piv_val[(k + 1) & 1] = pvn;
          S.perm[k + 1] = ridx;
          S.diag[k + 1] = pvn;
        }
      }
    } else if (my_r >= 0 && my_r != p) {
      float* row = S.aug + my_r * width;
      const float* prow = S.aug + p * width;
      const float f = row[k] / pv_safe;
      for (int cc = k + 2 + my_g; cc < m + 3; cc += per_row) row[cc] = row[cc] - f * prow[cc];
    }
    __syncthreads();
  }
  for (int q = tid; q < m * 3; q += THREADS) {
    const int k = q / 3, d = q - k * 3;
    const float dg = fabsf(S.diag[k]) < 1e-30f ? 1.0f : S.diag[k];
    S.w[q] = S.aug[S.perm[k] * width + m + d] / dg;
  }
  __syncthreads();

  // T = Y0 + G W (inactive rows keep Y0).
  for (int q = tid; q < m * 3; q += THREADS) {
    const int r = q / 3, d = q - r * 3;
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) acc = acc + gm[r * m + j] * S.w[j * 3 + d];
    const float tv = E.nm[r] > 0.0f ? S.y0[q] + acc : S.y0[q];
    S.t[q] = tv;
    A.t[m3 + q] = tv;
  }
  __syncthreads();

  // The sigma^2 update and the mean node move: rows lane, lane + 32, .. per
  // lane, then shuffle trees.
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
      A.stats[(size_t)s * 2] = fmaxf(s2n, 1e-10f);
      A.stats[(size_t)s * 2 + 1] = move / fmaxf(v_count_f, 1.0f);
    }
  }
}

// The launch configuration for B streams of n rows: B clusters of C CTAs.
template <int MMAX>
cudaError_t em_iter_config(int n_streams, int n, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<MMAX>);
  cudaError_t err = cudaFuncSetAttribute(em_iter_kernel<MMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int c = td::ec_cluster_size(n);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n_streams * c);
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

template <int MMAX>
int launch(const FArgs& a, int n_streams, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = em_iter_config<MMAX>(n_streams, a.n, &cfg, &attr, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, em_iter_kernel<MMAX>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The unbounded build (m > 128).
// ---------------------------------------------------------------------------

// Its global workspace in floats, per stream: the CTAs' float64 slots of
// partial sums, their minima and [A | B] (shared), then each CTA's own (the
// float64 totals and their float32 rounding, the visibility weights and
// minima, the solve's record, W and T). Every part is an even number of
// floats, so the float64 arrays stay 8-byte aligned.
__host__ __device__ inline size_t ub_shared_floats(int m) {
  const size_t c = td::EC_MAX_CLUSTER;
  const size_t n = 2 * c * (4 * (size_t)m + 2) + c * m + (size_t)m * ((size_t)m + 3);
  return n + (n & 1);
}
__host__ __device__ inline size_t ub_private_floats(int m) {
  const size_t n = 3 * (4 * (size_t)m + 2) + 5 * (size_t)m + 6 * (size_t)m;
  return n + (n & 1);
}
__host__ __device__ inline size_t ub_stream_floats(int m) {
  return ub_shared_floats(m) + td::EC_MAX_CLUSTER * ub_private_floats(m);
}

struct UbSmem {
  td::EcuSmem<THREADS> es;
  td::GjcSmem<THREADS, float> gj;
};

__global__ void __launch_bounds__(THREADS, 1) em_iter_ub_kernel(FArgs A, float* ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  UbSmem& S = *reinterpret_cast<UbSmem*>(smem_raw);
  unsigned char* tail = smem_raw + sizeof(UbSmem);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int s = blockIdx.x / c;
  const int m = A.m, n = A.n;
  const int m_pad = (m + 7) / 8 * 8;
  const size_t mm = (size_t)s * m * m, m3 = (size_t)s * m * 3, m1 = (size_t)s * m;
  const size_t w4 = 4 * (size_t)m + 2, width = (size_t)m + 3;
  float* base = ws + (size_t)s * ub_stream_floats(m);
  double* part_all = reinterpret_cast<double*>(base);
  float* cmin_all = base + 2 * c * w4;
  float* aug = cmin_all + (size_t)c * m;
  double* tot = reinterpret_cast<double*>(base + ub_shared_floats(m) +
                                          (size_t)rank * ub_private_floats(m));
  float* tot32 = reinterpret_cast<float*>(tot + w4);
  float* pv = tot32 + w4;
  float* gmin = pv + m;
  float* diag = gmin + m;
  int* perm = reinterpret_cast<int*>(diag + m);
  int* pos = perm + m;
  float* w = reinterpret_cast<float*>(pos + m);
  float* t = w + 3 * m;
  const td::GjcRecord<float> rec{perm, pos, diag};

  const float s2 = A.s2[(size_t)s * A.s2_stride];
  const float* dyn = A.dyn + (size_t)s * 4;
  const float v_count_f = dyn[1], n_safe = dyn[2], gate = dyn[3];
  float c_plain, c_vis;
  if (A.cc != nullptr) {
    c_plain = A.cc[(size_t)s * 2];
    c_vis = A.cc[(size_t)s * 2 + 1];
  } else {
    const float tps = TWO_PI * s2;
    const float c_core = tps * sqrtf(tps);
    c_plain = (A.muf * v_count_f / n_safe) * c_core;
    c_vis = (A.muf / n_safe) * c_core;
  }
  const float* ys = A.y + m3;
  const float* nm = A.nm + m1;
  for (int k = tid; k < m; k += THREADS) pv[k] = 0.0f;
  __syncthreads();
  const td::EcuNodes nodes{ys, A.coord + m1, nm, pv, m};
  const int rows = td::ub_rows_per_cta(n);
  const int r0 = min(n, rank * rows), r1 = min(n, r0 + rows);
  const float* xs = A.x + (size_t)s * n * 3;
  const float* xms = A.xm + (size_t)s * n;
  if (gate > 0.0f) {
    td::ecu_minima<THREADS>(nodes, xs, xms, r0, r1, S.es, cmin_all + (size_t)rank * m);
    td::ub_cluster_publish(cluster);
    td::ecu_cluster_minima<THREADS>(m, c, cmin_all, gmin);
    td::ecu_visibility_weights(m, A.k_vis, A.tau_vis, gmin, nm, pv);
  }
  const td::EcScalars sc{s2, 0.0f, c_plain, c_plain + gate * (c_vis - c_plain), gate,
                         (int)v_count_f, m_pad, m};
  td::ecu_partials<THREADS, false, true>(sc, nodes, xs, xms, r0, r1, S.es, part_all + rank * w4);
  td::ub_cluster_publish(cluster);
  td::ecu_cluster_totals<THREADS>(m, c, part_all, tot, tot32);
  const float* p1 = tot32;
  const float* px = tot32 + m;

  // This CTA's rows of [A | B] (inactive nodes: identity rows, zero
  // right-hand sides), in the TPU kernel's operation order.
  const float lam_s2 = A.lam * s2;
  const float lle_s2 = s2 * A.coef_lle;
  const float* gm = A.g + mm;
  const float* hgm = A.hg + mm;
  const float* jgm = A.jg + mm;
  const float* y0 = A.y0 + m3;
  const float* hy0 = A.hy0 + m3;
  const float* pd = A.pd + m3;
  const int nown = td::ub_own_rows(m, c, rank);
  for (int k = tid; k < nown * (m + 3); k += THREADS) {
    const int i = k / (m + 3), col = k - i * (m + 3);
    const int r = rank + i * c;
    float v;
    if (col < m) {
      if (nm[r] > 0.0f && nm[col] > 0.0f) {
        const size_t e = (size_t)r * m + col;
        v = p1[r] * gm[e] + (r == col ? lam_s2 : 0.0f);
        v = v + lle_s2 * hgm[e];
        v = v + A.alpha * jgm[e];
      } else {
        v = r == col ? 1.0f : 0.0f;
      }
    } else {
      const int d = col - m, e = r * 3 + d;
      v = px[d * m + r] - p1[r] * y0[e];
      v = v - lle_s2 * hy0[e];
      v = v + A.alpha * pd[e];
      v = v * nm[r];
    }
    __stcg(aug + r * width + col, v);
  }
  __syncthreads();
  td::gjc_solve<THREADS, false>(m, cluster, aug, width, rec, S.gj, tail);
  // Past the solve's last barrier no CTA reads another's memory.
  if (rank != 0) return;
  td::gjc_extract<THREADS>(m, aug, width, m, rec, w);
  // T = Y0 + G W (inactive rows keep Y0).
  for (int q = tid; q < m * 3; q += THREADS) {
    const int r = q / 3, d = q - r * 3;
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) acc = acc + gm[(size_t)r * m + j] * w[j * 3 + d];
    const float tv = nm[r] > 0.0f ? y0[q] + acc : y0[q];
    t[q] = tv;
    A.t[m3 + q] = tv;
  }
  __syncthreads();
  if (warp == 0) {
    float s2n, move;
    td::ecu_sigma2(m, tot, t, ys, nm, s2n, move);
    if (lane == 0) {
      A.stats[(size_t)s * 2] = s2n;
      A.stats[(size_t)s * 2 + 1] = move / fmaxf(v_count_f, 1.0f);
    }
  }
}

cudaError_t em_iter_ub_config(int n_streams, int m, cudaLaunchConfig_t* cfg,
                              cudaLaunchAttribute* attr, cudaStream_t stream) {
  const int smem = (int)(sizeof(UbSmem) + td::ub_solve_tail_bytes<float>(m, td::EC_MAX_CLUSTER));
  cudaError_t err = cudaFuncSetAttribute(em_iter_ub_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n_streams * td::EC_MAX_CLUSTER);
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

extern "C" int trackdlo_em_iter(const float* s2, int s2_stride, const float* dyn, const float* cc,
                                const float* y, const float* y0, const float* coord,
                                const float* nm, const float* g, const float* hg,
                                const float* hy0, const float* jg, const float* pd,
                                const float* x, const float* xm, int n_streams, int m, int n,
                                float muf, float k_vis, float tau_vis, float lam, float coef_lle,
                                float alpha, float* t, float* stats, void* stream) {
  if (m < 1 || m > td::EC_MMAX_WIDE || n < 0 || n_streams < 0 ||
      (long long)n_streams * td::ec_cluster_size(n) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_streams == 0) return 0;
  const FArgs a{s2, dyn, cc, y, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, s2_stride, m, n,
                muf, k_vis, tau_vis, lam, coef_lle, alpha, t, stats};
  return m <= td::EC_MMAX ? launch<td::EC_MMAX>(a, n_streams, stream)
                          : launch<td::EC_MMAX_WIDE>(a, n_streams, stream);
}

// For n rows and m nodes: out[0] the cluster size, out[1] the rows per CTA,
// out[2] how many such clusters the card can hold at once, out[3] the
// shared memory of one CTA in bytes.
// The unbounded build (m > 128): ``ws`` a workspace of
// trackdlo_em_iter_workspace bytes.
extern "C" int trackdlo_em_iter_ub(const float* s2, int s2_stride, const float* dyn,
                                   const float* cc, const float* y, const float* y0,
                                   const float* coord, const float* nm, const float* g,
                                   const float* hg, const float* hy0, const float* jg,
                                   const float* pd, const float* x, const float* xm,
                                   int n_streams, int m, int n, float muf, float k_vis,
                                   float tau_vis, float lam, float coef_lle, float alpha,
                                   float* t, float* stats, void* ws, void* stream) {
  if (m < td::UB_MMIN || n < 0 || n_streams < 0 ||
      (long long)n_streams * td::EC_MAX_CLUSTER > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_streams == 0) return 0;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const FArgs a{s2, dyn, cc, y, y0, coord, nm, g, hg, hy0, jg, pd, x, xm, s2_stride, m, n,
                muf, k_vis, tau_vis, lam, coef_lle, alpha, t, stats};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = em_iter_ub_config(n_streams, m, &cfg, &attr, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, em_iter_ub_kernel, a, static_cast<float*>(ws));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The unbounded build's workspace in bytes for B streams of m nodes (0
// where m takes a bounded build).
extern "C" int trackdlo_em_iter_workspace(int n_streams, int m, int n, long long* out) {
  if (m < 1 || n < 0 || n_streams < 0) return (int)cudaErrorInvalidValue;
  *out = m < td::UB_MMIN ? 0 : (long long)n_streams * 4 * (long long)ub_stream_floats(m);
  return 0;
}

extern "C" int trackdlo_em_iter_cluster_info(int n, int m, int* out) {
  if (n < 0 || m < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (m >= td::UB_MMIN) {
    cudaError_t err = em_iter_ub_config(1, m, &cfg, &attr, nullptr);
    if (err != cudaSuccess) return (int)err;
    out[0] = td::EC_MAX_CLUSTER;
    out[1] = td::ub_rows_per_cta(n);
    out[3] = (int)cfg.dynamicSmemBytes;
    return (int)cudaOccupancyMaxActiveClusters(&out[2], em_iter_ub_kernel, &cfg);
  }
  const bool narrow = m <= td::EC_MMAX;
  cudaError_t err = narrow ? em_iter_config<td::EC_MMAX>(1, n, &cfg, &attr, nullptr)
                           : em_iter_config<td::EC_MMAX_WIDE>(1, n, &cfg, &attr, nullptr);
  if (err != cudaSuccess) return (int)err;
  out[0] = td::ec_cluster_size(n);
  out[1] = td::ec_rows_per_cta(n);
  out[3] = (int)cfg.dynamicSmemBytes;
  return narrow ? (int)cudaOccupancyMaxActiveClusters(&out[2], em_iter_kernel<td::EC_MMAX>, &cfg)
                : (int)cudaOccupancyMaxActiveClusters(&out[2], em_iter_kernel<td::EC_MMAX_WIDE>,
                                                      &cfg);
}
