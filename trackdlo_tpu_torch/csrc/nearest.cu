// Kernel N: each node's squared distance to its nearest valid point, for B
// streams in one launch.
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py nearest_point_sq
// (_nearest_kernel): the per-node minimum of the point-sharded EM's main
// pass, taken on one shard of the cloud before the cross-shard minimum.
//
// What bounds it on an H100: latency. One stream at M = 45 and a shard of
// 1024 points is ~0.4 M operations over ~18 KB of inputs; the output is
// (M,). The TPU streamed (m_pad, 512) tiles through one core and carried
// the running minimum in its output block from one grid step to the next.
//
// Design: one block of 256 threads per stream; the nodes and their mask in
// shared memory. Each thread strides over the points and keeps its 48 node
// minima in registers; warp min trees, then one thread per node over the
// warps. The squared distance is summed d = 0, 1, 2 in that order and the
// library builds with -fmad=false, so every candidate is the plain
// version's float32 value, and a minimum is exact in any order: the result
// is bit-equal to the plain version. 1e5 where the node is masked or no
// point is valid, as the TPU kernel gives.
#include "common.cuh"

namespace {

constexpr int MMAX = 48;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr float BIG = 1e5f;

__global__ void __launch_bounds__(THREADS) nearest_kernel(const float* __restrict__ y,
                                                          const float* __restrict__ nm,
                                                          const float* __restrict__ x,
                                                          const float* __restrict__ xm, int m,
                                                          int n, float* __restrict__ out) {
  __shared__ float ys[MMAX * 3], nms[MMAX], wmin[NWARPS * MMAX];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x;
  for (int k = tid; k < m * 3; k += THREADS) ys[k] = y[(size_t)s * m * 3 + k];
  for (int k = tid; k < m; k += THREADS) nms[k] = nm[(size_t)s * m + k];
  __syncthreads();

  const float* xs = x + (size_t)s * n * 3;
  const float* xms = xm + (size_t)s * n;
  float mn[MMAX];
#pragma unroll
  for (int j = 0; j < MMAX; ++j) mn[j] = BIG;
  for (int i = tid; i < n; i += THREADS) {
    if (!(xms[i] > 0.0f)) continue;
    const float x0 = xs[i * 3], x1 = xs[i * 3 + 1], x2 = xs[i * 3 + 2];
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      if (j < m && nms[j] > 0.0f) {
        const float d0 = ys[j * 3] - x0, d1 = ys[j * 3 + 1] - x1, d2 = ys[j * 3 + 2] - x2;
        mn[j] = fminf(mn[j], d0 * d0 + d1 * d1 + d2 * d2);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < MMAX; ++j) {
    if (j < m) {
      const float v = td_warp_min(mn[j]);
      if (lane == 0) wmin[warp * MMAX + j] = v;
    }
  }
  __syncthreads();
  if (tid < m) {
    float v = BIG;
    for (int w = 0; w < NWARPS; ++w) v = fminf(v, wmin[w * MMAX + tid]);
    out[(size_t)s * m + tid] = v;
  }
}

}  // namespace

extern "C" int trackdlo_nearest(const float* y, const float* nm, const float* x, const float* xm,
                                int n_streams, int m, int n, float* out, void* stream) {
  if (m < 1 || m > MMAX || n < 0 || n_streams < 0) return (int)cudaErrorInvalidValue;
  if (n_streams == 0) return 0;
  nearest_kernel<<<n_streams, THREADS, 0, (cudaStream_t)stream>>>(y, nm, x, xm, m, n, out);
  return (int)cudaGetLastError();
}
