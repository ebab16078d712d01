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
#include "gj.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MM = td::GJ_MMAX * td::GJ_MMAX;

struct Smem {
  float a[MM];
  float b[td::GJ_MMAX * 3], w[td::GJ_MMAX * 3];
  float asp[3 * MM], gsp[3 * MM], wsp[3 * td::GJ_MMAX * 3];  // split3 pieces
  td::GjSmem gj;
};

__global__ void __launch_bounds__(THREADS, 1)
    gj_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ g, const float* __restrict__ y0, int m,
                    float* __restrict__ w, float* __restrict__ t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t sys = blockIdx.x;
  const int mm = m * m;
  for (int k = tid; k < mm; k += THREADS) {
    const float v = a[sys * mm + k];
    S.a[k] = v;
    td::split3(v, S.asp[k], S.asp[mm + k], S.asp[2 * mm + k]);
    if (g != nullptr) td::split3(g[sys * mm + k], S.gsp[k], S.gsp[mm + k], S.gsp[2 * mm + k]);
  }
  for (int k = tid; k < m * 3; k += THREADS) S.b[k] = b[sys * m * 3 + k];
  __syncthreads();
  td::gj_solve<THREADS, td::GjScale::kCeilLog2>(m, S.a, S.b, S.w, S.gj, S.asp, S.wsp);
  for (int k = tid; k < m * 3; k += THREADS) w[sys * m * 3 + k] = S.w[k];
  if (g == nullptr) return;
  td::split3_all<THREADS>(m * 3, S.w, S.wsp);
  __syncthreads();
  for (int q = tid; q < m * 3; q += THREADS) {
    const float gw = td::exact_split_dot(m, S.gsp, mm, q / 3, S.wsp, m * 3, q % 3);
    t[sys * m * 3 + q] = y0[sys * m * 3 + q] + gw;
  }
}

int launch(const float* a, const float* b, const float* g, const float* y0, int n_sys, int m,
           float* w, float* t, void* stream) {
  if (m < 1 || m > td::GJ_MMAX || n_sys < 0) return (int)cudaErrorInvalidValue;
  if (n_sys == 0) return 0;
  const int smem = (int)sizeof(Smem);
  cudaError_t err =
      cudaFuncSetAttribute(gj_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gj_solve_kernel<<<n_sys, THREADS, smem, (cudaStream_t)stream>>>(a, b, g, y0, m, w, t);
  return (int)cudaGetLastError();
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
