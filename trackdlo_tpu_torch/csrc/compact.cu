// Kernel C: stable per-channel stream compaction of the kept cells.
//
// Replaces: trackdlo_tpu/ops/preprocess_kernel.py compact_onehot_pallas
// (_compact_onehot_kernel).
//
// What bounds it on an H100: latency. One frame has 8 parity channels of
// n_per cells (7722 at 720p) and cap_per slots each (256 at the live leaf);
// it reads 62 KB of kept flags and copies at most 2048 cells of 16 B. The
// cost is the chain of block-wide scans over the chunks of a channel.
//
// Design: one block per channel. Each chunk of 1024 cells takes the exact
// integer exclusive rank of its kept cells: a warp ballot and popc within
// the warp, then one warp scans the 32 warp totals in shared memory. A kept
// cell with rank r < cap_per is copied (x, y, z sums and count) into slot r,
// so the slots hold the kept cells in raster order; the scan stops once the
// slots are full. Slots past the kept count are zeroed and marked invalid,
// as the TPU kernel's output is. A permutation is a store here: the TPU's
// one-hot MXU product and its 3-way bf16 operand split are not needed, and
// every slot is a bit-exact copy of one cell.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;  // == 32: one warp scans the warp totals

__global__ void compact_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                               const float* __restrict__ zs, const float* __restrict__ counts,
                               const uint8_t* __restrict__ kept, int n_per, int cap_per,
                               float* __restrict__ pts, float* __restrict__ cnt,
                               uint8_t* __restrict__ valid) {
  __shared__ int warp_off[WARPS];
  __shared__ int chunk_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * n_per;
  float* P = pts + (size_t)blockIdx.x * cap_per * 3;
  float* N = cnt + (size_t)blockIdx.x * cap_per;
  uint8_t* V = valid + (size_t)blockIdx.x * cap_per;

  int base = 0;  // kept cells in earlier chunks; the same in every thread
  for (int start = 0; start < n_per && base < cap_per; start += THREADS) {
    const int i = start + threadIdx.x;
    const bool k = i < n_per && kept[row + i] != 0;
    const unsigned bal = __ballot_sync(TD_FULL_MASK, k);
    if (lane == 0) warp_off[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int t = warp_off[lane];
      int incl = t;
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(TD_FULL_MASK, incl, off);
        if (lane >= off) incl += u;
      }
      warp_off[lane] = incl - t;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    if (k) {
      const int r = base + warp_off[warp] + __popc(bal & ((1u << lane) - 1u));
      if (r < cap_per) {
        P[r * 3 + 0] = xs[row + i];
        P[r * 3 + 1] = ys[row + i];
        P[r * 3 + 2] = zs[row + i];
        N[r] = counts[row + i];
        V[r] = 1;
      }
    }
    base += chunk_total;
    __syncthreads();  // the next chunk rewrites warp_off and chunk_total
  }
  for (int r = min(base, cap_per) + threadIdx.x; r < cap_per; r += THREADS) {
    P[r * 3 + 0] = 0.0f;
    P[r * 3 + 1] = 0.0f;
    P[r * 3 + 2] = 0.0f;
    N[r] = 0.0f;
    V[r] = 0;
  }
}

}  // namespace

extern "C" int trackdlo_compact(const float* xs, const float* ys, const float* zs,
                                const float* counts, const uint8_t* kept, int n_channels,
                                int n_per, int cap_per, float* pts, float* cnt,
                                uint8_t* valid, void* stream) {
  if (n_channels < 0 || n_per < 0 || cap_per <= 0) return (int)cudaErrorInvalidValue;
  if (n_channels == 0) return 0;
  compact_kernel<<<n_channels, THREADS, 0, (cudaStream_t)stream>>>(
      xs, ys, zs, counts, kept, n_per, cap_per, pts, cnt, valid);
  return (int)cudaGetLastError();
}
