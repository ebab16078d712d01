// Kernel N: each node's squared distance to its nearest valid point, for B
// streams in one launch.
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py nearest_point_sq
// (_nearest_kernel): the per-node minimum of the point-sharded EM's main
// pass, taken on one shard of the cloud before the cross-shard minimum.
//
// What bounds it on an H100: latency. One stream at M = 45 and a shard of
// 1024 rows (~170 valid) is ~0.07 M operations over ~18 KB of inputs; the
// output is (M,). The TPU streamed (m_pad, 512) tiles through one core and
// carried the running minimum in its output block from one grid step to the
// next. A block whose threads each kept all 48 node minima over a stride of
// rows ended in 48 warp min trees (perf/em_phase_stamps.py --only n: a third
// of the launch).
//
// Design: one block of 512 threads per stream. The valid rows are compacted
// into shared memory in row order (warp ballot and block prefix), up to
// 2048 at a time. Thread t owns node t mod m and slice t / m of the points
// (points slice, slice + S, ..., with S = 512 / m slices): one running
// minimum in a register, the nodes in registers, a point read by a whole
// warp at once. The slices' minima then merge through shared memory, one
// thread per node. The masks are read as given, bool (one byte) or float32
// 0/1, so the wrapper casts nothing. The squared distance is summed
// d = 0, 1, 2 in that order and the library builds with -fmad=false, so
// every candidate is the plain version's float32 value, and a minimum is
// exact in any order: the result is bit-equal to the plain version. 1e5
// where the node is masked or no point is valid, as the TPU kernel gives.
//
// Past 128 nodes the unbounded build runs: each compacted tile is swept for
// the nodes 128 at a time (thread t owns node 128 b + t mod 128 of block b
// and slice t / 128 of the points), each block's slices merged into the
// running minima in the output; a minimum is exact in any order, so the
// result stays bit-equal to the plain version.
#include "common.cuh"

namespace {

// Nothing in the layout depends on the node bound (a thread keeps one node);
// it needs m <= THREADS / 4, so that a node has at least four slices.
constexpr int MMAX = 128;
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE = 2048;  // rows compacted at a time
constexpr float BIG = 1e5f;

template <typename T>
__device__ __forceinline__ bool mask_on(const T* mask, size_t i) {
  return mask[i] > T(0);
}

template <typename NMT, typename XMT>
__global__ void __launch_bounds__(THREADS) nearest_kernel(const float* __restrict__ y,
                                                          const NMT* __restrict__ nm,
                                                          const float* __restrict__ x,
                                                          const XMT* __restrict__ xm, int m,
                                                          int n, float* __restrict__ out) {
  __shared__ float xs[TILE * 3], part[THREADS];
  __shared__ int wcount[NWARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x;
  const int slices = THREADS / m;
  const int j = tid % m, slice = tid / m;
  const bool mine = slice < slices && mask_on(nm, (size_t)s * m + j);
  float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f;
  if (mine) {
    y0 = y[((size_t)s * m + j) * 3];
    y1 = y[((size_t)s * m + j) * 3 + 1];
    y2 = y[((size_t)s * m + j) * 3 + 2];
  }
  const float* xs_g = x + (size_t)s * n * 3;
  float best = BIG;
  for (int base = 0; base < n; base += TILE) {
    // The tile's valid rows into xs, in row order.
    const int end = min(n, base + TILE);
    int count = 0;
    for (int seg = base; seg < end; seg += THREADS) {
      const int i = seg + tid;
      const bool v = i < end && mask_on(xm, (size_t)s * n + i);
      const unsigned bal = __ballot_sync(TD_FULL_MASK, v);
      if (lane == 0) wcount[warp] = __popc(bal);
      __syncthreads();
      int off = count, seg_total = 0;
      for (int w = 0; w < NWARPS; ++w) {
        if (w < warp) off += wcount[w];
        seg_total += wcount[w];
      }
      off += __popc(bal & ((1u << lane) - 1u));
      if (v) {
        xs[off * 3 + 0] = xs_g[(size_t)i * 3 + 0];
        xs[off * 3 + 1] = xs_g[(size_t)i * 3 + 1];
        xs[off * 3 + 2] = xs_g[(size_t)i * 3 + 2];
      }
      count += seg_total;
      __syncthreads();
    }
    if (mine) {
      for (int i = slice; i < count; i += slices) {
        const float d0 = y0 - xs[i * 3], d1 = y1 - xs[i * 3 + 1], d2 = y2 - xs[i * 3 + 2];
        best = fminf(best, d0 * d0 + d1 * d1 + d2 * d2);
      }
    }
    __syncthreads();  // the next tile rewrites xs
  }
  part[tid] = best;
  __syncthreads();
  if (tid < m) {
    float v = BIG;
    for (int k = 0; k < slices; ++k) v = fminf(v, part[k * m + tid]);
    out[(size_t)s * m + tid] = v;
  }
}

template <typename NMT, typename XMT>
__global__ void __launch_bounds__(THREADS) nearest_ub_kernel(const float* __restrict__ y,
                                                             const NMT* __restrict__ nm,
                                                             const float* __restrict__ x,
                                                             const XMT* __restrict__ xm, int m,
                                                             int n, float* __restrict__ out) {
  constexpr int SLICES = THREADS / MMAX;
  __shared__ float xs[TILE * 3], part[THREADS];
  __shared__ int wcount[NWARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x;
  const int jl = tid % MMAX, slice = tid / MMAX;
  const float* xs_g = x + (size_t)s * n * 3;
  float* o = out + (size_t)s * m;
  for (int j = tid; j < m; j += THREADS) o[j] = BIG;
  for (int base = 0; base < n; base += TILE) {
    // The tile's valid rows into xs, in row order (starts with a barrier:
    // the last tile's readers are done).
    const int end = min(n, base + TILE);
    int count = 0;
    __syncthreads();
    for (int seg = base; seg < end; seg += THREADS) {
      const int i = seg + tid;
      const bool v = i < end && mask_on(xm, (size_t)s * n + i);
      const unsigned bal = __ballot_sync(TD_FULL_MASK, v);
      if (lane == 0) wcount[warp] = __popc(bal);
      __syncthreads();
      int off = count, seg_total = 0;
      for (int w = 0; w < NWARPS; ++w) {
        if (w < warp) off += wcount[w];
        seg_total += wcount[w];
      }
      off += __popc(bal & ((1u << lane) - 1u));
      if (v) {
        xs[off * 3 + 0] = xs_g[(size_t)i * 3 + 0];
        xs[off * 3 + 1] = xs_g[(size_t)i * 3 + 1];
        xs[off * 3 + 2] = xs_g[(size_t)i * 3 + 2];
      }
      count += seg_total;
      __syncthreads();
    }
    for (int b = 0; b < m; b += MMAX) {
      const int j = b + jl;
      float best = BIG;
      if (j < m && mask_on(nm, (size_t)s * m + j)) {
        const float y0 = y[((size_t)s * m + j) * 3];
        const float y1 = y[((size_t)s * m + j) * 3 + 1];
        const float y2 = y[((size_t)s * m + j) * 3 + 2];
        for (int i = slice; i < count; i += SLICES) {
          const float d0 = y0 - xs[i * 3], d1 = y1 - xs[i * 3 + 1], d2 = y2 - xs[i * 3 + 2];
          best = fminf(best, d0 * d0 + d1 * d1 + d2 * d2);
        }
      }
      part[tid] = best;
      __syncthreads();
      if (tid < MMAX && j < m) {
        float v = o[j];
        for (int k = 0; k < SLICES; ++k) v = fminf(v, part[k * MMAX + tid]);
        o[j] = v;
      }
      __syncthreads();
    }
  }
}

template <typename NMT, typename XMT>
cudaError_t launch(const float* y, const void* nm, const float* x, const void* xm, int n_streams,
                   int m, int n, float* out, cudaStream_t stream) {
  if (m > MMAX) {
    nearest_ub_kernel<NMT, XMT><<<n_streams, THREADS, 0, stream>>>(
        y, static_cast<const NMT*>(nm), x, static_cast<const XMT*>(xm), m, n, out);
  } else {
    nearest_kernel<NMT, XMT><<<n_streams, THREADS, 0, stream>>>(
        y, static_cast<const NMT*>(nm), x, static_cast<const XMT*>(xm), m, n, out);
  }
  return cudaGetLastError();
}

}  // namespace

// nm_bytes / xm_bytes: the node / point mask is one byte a value (a bool
// tensor), else float32 0/1.
extern "C" int trackdlo_nearest(const float* y, const void* nm, const float* x, const void* xm,
                                int n_streams, int m, int n, int nm_bytes, int xm_bytes,
                                float* out, void* stream) {
  if (m < 1 || n < 0 || n_streams < 0) return (int)cudaErrorInvalidValue;
  if (n_streams == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  using u8 = unsigned char;
  cudaError_t err;
  if (nm_bytes) {
    err = xm_bytes ? launch<u8, u8>(y, nm, x, xm, n_streams, m, n, out, st)
                   : launch<u8, float>(y, nm, x, xm, n_streams, m, n, out, st);
  } else {
    err = xm_bytes ? launch<float, u8>(y, nm, x, xm, n_streams, m, n, out, st)
                   : launch<float, float>(y, nm, x, xm, n_streams, m, n, out, st);
  }
  return (int)err;
}
