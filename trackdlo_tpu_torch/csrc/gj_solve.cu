// Kernel G: B equilibrated Gauss-Jordan solves A w = B in one launch, and,
// for the EM's M-step, its node update T = Y0 + G w.
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py gauss_jordan_solve_batched
// (_batched_gj_kernel, and the three refinement steps after it), the M-step
// solve of the batched per-iteration EM.
//
// What bounds it on an H100: latency. A (48, 48) system with three
// right-hand sides is ~0.5 MFLOP and 9.8 KB; the elimination is a chain of
// m dependent pivot steps (a search, one factor per row, an update of the
// m + 3 live columns of [A | I | B]), each behind one barrier (gj.cuh). The
// TPU vectorised all B eliminations across sublanes in one 48-step loop;
// here the B systems are independent blocks that run side by side on B SMs.
//
// Design: one block of 512 threads per system, [A | I | B] (20 KB at
// m = 48, rows padded against bank conflicts) and the inverse in shared
// memory, the solve of gj.cuh (the one kernel E runs in its M-step, there
// with B1's row-scale rule): power-of-two row equilibration by
// 2^ceil(log2 max|row|), partial pivoting with ties to the lowest row
// (searched one step ahead by a warp of its own), the zero-pivot guards,
// the inverse and three refinement steps against the unscaled system, so
// that one launch computes the whole function. Several systems per block
// would lengthen each system's chain: at 8-16 systems a launch the card
// has SMs to spare, and the time of a launch is one system's chain.
//
// The refinement's residual and, where G and Y0 are given, T's product G w
// are taken as kernel E takes them (B1's _exact_dot, gj.cuh): in the
// lockstep EM both cancel as heavily as in kernel E's, and float32 products
// there put noise of the order of the EM's tolerance into every iteration
// (ROADMAP, fault 1).
//
// Node bound: compiled for at most 48 nodes (the layout above) and for at
// most 128, where A, G and their pieces stay in global memory (L2), cut
// into pieces where they are read, and [A | I | B] takes the shared memory.
// Past 128 nodes the unbounded build runs: one thread-block cluster of 8
// CTAs per system, [A | I | B] in a global workspace and the elimination
// spread over the cluster (unbounded.cuh's gjc_solve, the one kernel E's
// unbounded build runs), so a system's chain of m pivot steps has 8 SMs'
// load and store rate behind each step, where one CTA over the same global
// [A | I | B] would have one; CTA 0 then extracts w, refines it and forms T.
#include "unbounded.cuh"

namespace {

constexpr int THREADS = 512;

template <int MM, bool NARROW = (MM <= td::GJ_MMAX)>
struct Smem {
  float a[MM * MM];
  float b[MM * 3], w[MM * 3];
  float asp[3 * MM * MM], gsp[3 * MM * MM], wsp[3 * MM * 3];  // split3 pieces
  td::GjSmem<MM> gj;
};
template <int MM>
struct Smem<MM, false> {
  float b[MM * 3], w[MM * 3];
  float wsp[3 * MM * 3];
  float aug[MM * td::gj_wmax(MM)];
  td::GjSmem<MM> gj;
};

// A (m, m) in global memory, its pieces cut where they are read.
struct GlobalA {
  const float* a;
  int m;
  __device__ __forceinline__ float value(int r, int c) const { return a[r * m + c]; }
  __device__ __forceinline__ void get(int r, int c, float (&p)[3]) const {
    td::split3(a[r * m + c], p[0], p[1], p[2]);
  }
};

template <int MM>
__global__ void __launch_bounds__(THREADS, 1)
    gj_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ g, const float* __restrict__ y0, int m,
                    float* __restrict__ w, float* __restrict__ t) {
  constexpr bool NARROW = MM <= td::GJ_MMAX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MM>& S = *reinterpret_cast<Smem<MM>*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t sys = blockIdx.x;
  const int mm = m * m;
  if constexpr (NARROW) {
    for (int k = tid; k < mm; k += THREADS) {
      const float v = a[sys * mm + k];
      S.a[k] = v;
      td::split3(v, S.asp[k], S.asp[mm + k], S.asp[2 * mm + k]);
      if (g != nullptr) td::split3(g[sys * mm + k], S.gsp[k], S.gsp[mm + k], S.gsp[2 * mm + k]);
    }
  }
  for (int k = tid; k < m * 3; k += THREADS) S.b[k] = b[sys * m * 3 + k];
  __syncthreads();
  if constexpr (NARROW) {
    const td::DenseA am{S.a, td::SplitPieces{S.asp, mm, m}, m};
    td::gj_solve<THREADS, td::GjScale::kCeilLog2>(m, am, S.b, S.w, S.gj, S.gj.aug, S.wsp);
  } else {
    const GlobalA am{a + sys * mm, m};
    td::gj_solve<THREADS, td::GjScale::kCeilLog2>(m, am, S.b, S.w, S.gj, S.aug, S.wsp);
  }
  for (int k = tid; k < m * 3; k += THREADS) w[sys * m * 3 + k] = S.w[k];
  if (g == nullptr) return;
  td::split3_all<THREADS>(m * 3, S.w, S.wsp);
  __syncthreads();
  for (int q = tid; q < m * 3; q += THREADS) {
    float gw;
    if constexpr (NARROW) {
      gw = td::exact_split_dot(m, td::SplitPieces{S.gsp, mm, m}, q / 3, S.wsp, m * 3, q % 3);
    } else {
      gw = td::exact_split_dot(m, td::SplitOnRead{g + sys * mm, m}, q / 3, S.wsp, m * 3, q % 3);
    }
    t[sys * m * 3 + q] = y0[sys * m * 3 + q] + gw;
  }
}

template <int MM>
int launch_mm(const float* a, const float* b, const float* g, const float* y0, int n_sys, int m,
              float* w, float* t, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<MM>);
  cudaError_t err = cudaFuncSetAttribute(gj_solve_kernel<MM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gj_solve_kernel<MM><<<n_sys, THREADS, smem, stream>>>(a, b, g, y0, m, w, t);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The unbounded build (m > 128).
// ---------------------------------------------------------------------------

// Its global workspace in floats, per system: [A | I | B] in float64 and the
// row scales (shared), then each CTA's solve record (its pivots in float64
// first), w, w's pieces and the residual; every part an even number of
// floats, so the float64 arrays stay 8-byte aligned.
__host__ __device__ inline size_t ub_shared_floats(int m) {
  return 2 * (size_t)m * (2 * (size_t)m + 3) + m + (m & 1);
}
__host__ __device__ inline size_t ub_private_floats(int m) {
  const size_t n = 4 * (size_t)m + 15 * (size_t)m;
  return n + (n & 1);
}
__host__ __device__ inline size_t ub_system_floats(int m) {
  return ub_shared_floats(m) + td::EC_MAX_CLUSTER * ub_private_floats(m);
}

namespace cg = cooperative_groups;

__global__ void __launch_bounds__(THREADS, 1)
    gj_solve_ub_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ g, const float* __restrict__ y0, int m,
                       float* __restrict__ w_out, float* __restrict__ t_out, float* ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& S = *reinterpret_cast<td::GjcSmem<THREADS, double>*>(smem_raw);
  unsigned char* tail = smem_raw + sizeof(td::GjcSmem<THREADS, double>);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const size_t sys = blockIdx.x / c;
  const size_t mm = (size_t)m * m, width = 2 * (size_t)m + 3;
  float* base = ws + sys * ub_system_floats(m);
  double* aug = reinterpret_cast<double*>(base);
  float* e = reinterpret_cast<float*>(aug + (size_t)m * width);
  double* diag = reinterpret_cast<double*>(base + ub_shared_floats(m) +
                                           (size_t)rank * ub_private_floats(m));
  int* perm = reinterpret_cast<int*>(diag + m);
  int* pos = perm + m;
  float* w = reinterpret_cast<float*>(pos + m);
  float* wsp = w + 3 * m;
  float* res = wsp + 9 * m;
  const td::GjcRecord<double> rec{perm, pos, diag};
  const GlobalA am{a + sys * mm, m};
  const float* bs = b + sys * m * 3;
  td::gjc_build_scaled<THREADS, td::GjScale::kCeilLog2>(m, c, rank, am, bs, aug, width, e);
  td::gjc_solve<THREADS, true>(m, cluster, aug, width, rec, S, tail);
  if (rank != 0) return;
  td::gjc_extract<THREADS>(m, aug, width, 2 * m, rec, w);
  td::gjc_refine<THREADS>(m, am, bs, w, e, aug, width, rec, wsp, res);
  for (int k = tid; k < m * 3; k += THREADS) w_out[sys * m * 3 + k] = w[k];
  if (g == nullptr) return;
  td::split3_all<THREADS>(m * 3, w, wsp);
  __syncthreads();
  for (int q = tid; q < m * 3; q += THREADS) {
    const float gw = td::exact_split_dot<true>(m, td::SplitOnRead{g + sys * mm, m}, q / 3, wsp,
                                               m * 3, q % 3);
    t_out[sys * m * 3 + q] = y0[sys * m * 3 + q] + gw;
  }
}

int launch_ub(const float* a, const float* b, const float* g, const float* y0, int n_sys, int m,
              float* w, float* t, float* ws, cudaStream_t stream) {
  const int smem = (int)(sizeof(td::GjcSmem<THREADS, double>) +
                         td::ub_solve_tail_bytes<double>(m, td::EC_MAX_CLUSTER));
  cudaError_t err = cudaFuncSetAttribute(gj_solve_ub_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(n_sys * td::EC_MAX_CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = td::EC_MAX_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gj_solve_ub_kernel, a, b, g, y0, m, w, t, ws);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch(const float* a, const float* b, const float* g, const float* y0, int n_sys, int m,
           float* w, float* t, void* stream) {
  if (m < 1 || m > td::GJ_MMAX_WIDE || n_sys < 0) return (int)cudaErrorInvalidValue;
  if (n_sys == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return m <= td::GJ_MMAX ? launch_mm<td::GJ_MMAX>(a, b, g, y0, n_sys, m, w, t, st)
                          : launch_mm<td::GJ_MMAX_WIDE>(a, b, g, y0, n_sys, m, w, t, st);
}

}  // namespace

extern "C" int trackdlo_gj_solve(const float* a, const float* b, int n_sys, int m, float* w,
                                 void* stream) {
  return launch(a, b, nullptr, nullptr, n_sys, m, w, nullptr, stream);
}

// The solve and the M-step's node update t = y0 + g w, g (n_sys, m, m) and
// y0, t (n_sys, m, 3).
extern "C" int trackdlo_gj_solve_update(const float* a, const float* b, const float* g,
                                        const float* y0, int n_sys, int m, float* w, float* t,
                                        void* stream) {
  if (g == nullptr || y0 == nullptr || t == nullptr) return (int)cudaErrorInvalidValue;
  return launch(a, b, g, y0, n_sys, m, w, t, stream);
}

// The unbounded build (m > 128) of both entry points: g, y0 and t null for
// the solve alone; ``ws`` a workspace of trackdlo_gj_solve_workspace bytes.
extern "C" int trackdlo_gj_solve_ub(const float* a, const float* b, const float* g,
                                    const float* y0, int n_sys, int m, float* w, float* t,
                                    void* ws, void* stream) {
  if (m < td::UB_MMIN || n_sys < 0 || (g == nullptr) != (t == nullptr) ||
      (g != nullptr && y0 == nullptr) || (long long)n_sys * td::EC_MAX_CLUSTER > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_sys == 0) return 0;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  return launch_ub(a, b, g, y0, n_sys, m, w, t, static_cast<float*>(ws), (cudaStream_t)stream);
}

// The unbounded build's workspace in bytes for n_sys systems of m nodes (0
// where m takes a bounded build).
extern "C" int trackdlo_gj_solve_workspace(int n_sys, int m, int n, long long* out) {
  (void)n;
  if (m < 1 || n_sys < 0) return (int)cudaErrorInvalidValue;
  *out = m < td::UB_MMIN ? 0 : (long long)n_sys * 4 * (long long)ub_system_floats(m);
  return 0;
}
