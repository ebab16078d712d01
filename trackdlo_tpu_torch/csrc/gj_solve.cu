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
#include "gj.cuh"

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
