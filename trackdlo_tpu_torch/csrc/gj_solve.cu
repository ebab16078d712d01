// Kernel G: B equilibrated Gauss-Jordan solves A w = B in one launch.
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
#include "gj.cuh"

namespace {

constexpr int THREADS = 512;

struct Smem {
  float a[td::GJ_MMAX * td::GJ_MMAX];
  float b[td::GJ_MMAX * 3], w[td::GJ_MMAX * 3];
  td::GjSmem gj;
};

__global__ void __launch_bounds__(THREADS, 1)
    gj_solve_kernel(const float* __restrict__ a, const float* __restrict__ b, int m,
                    float* __restrict__ w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t sys = blockIdx.x;
  for (int k = tid; k < m * m; k += THREADS) S.a[k] = a[sys * m * m + k];
  for (int k = tid; k < m * 3; k += THREADS) S.b[k] = b[sys * m * 3 + k];
  __syncthreads();
  td::gj_solve<THREADS, td::GjScale::kCeilLog2>(m, S.a, S.b, S.w, S.gj);
  for (int k = tid; k < m * 3; k += THREADS) w[sys * m * 3 + k] = S.w[k];
}

}  // namespace

extern "C" int trackdlo_gj_solve(const float* a, const float* b, int n_sys, int m, float* w,
                                 void* stream) {
  if (m < 1 || m > td::GJ_MMAX || n_sys < 0) return (int)cudaErrorInvalidValue;
  if (n_sys == 0) return 0;
  const int smem = (int)sizeof(Smem);
  cudaError_t err =
      cudaFuncSetAttribute(gj_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gj_solve_kernel<<<n_sys, THREADS, smem, (cudaStream_t)stream>>>(a, b, m, w);
  return (int)cudaGetLastError();
}
