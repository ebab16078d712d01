// Kernel C: stable per-channel stream compaction of the kept cells.
//
// Replaces: trackdlo_tpu/ops/preprocess_kernel.py compact_onehot_pallas
// (_compact_onehot_kernel), and in its derived mode also the overflow
// thinning before it (trackdlo_tpu/ops/preprocess.py compact_parity_channels:
// kept cells by an even stride) and the centroid division after it
// (``inputs_are_sums``).
//
// What bounds it on an H100: latency. One frame has 8 parity channels of
// n_per cells (7722 at 720p) and cap_per slots each (256 at the live leaf);
// it reads 247 KB of counts and copies at most 2048 cells. The cost is the
// chain from a cell's flag to its rank in the row.
//
// Design: one thread-block cluster per channel row, of up to 8 CTAs of 1024
// threads (fewer when the rows would take more CTAs than the card has SMs:
// 2 for the 64 rows of a cohort of 8 streams); CTA r owns the r-th
// contiguous span of the row's cells and takes it in chunks of 1024 (one
// chunk at 720p and 8 rows). Each CTA flags its cells (the
// given kept flags, or in the derived mode count > 0), counts them per warp
// with a ballot and per CTA with one scan of the warp totals, and publishes
// its total; after one cluster barrier every CTA reads the others' totals
// over distributed shared memory, which gives its base and the row's total
// n. A flagged cell's rank r in the row is then exact integer arithmetic:
// base + the chunk's and the warp's offsets + the ballot's popcount below
// the lane.
//
// - Explicit mode: the kept cell of rank r < cap_per goes to slot r.
// - Derived mode (kept = null): the flags are the occupied cells; with
//   n_eff = max(n, cap_per) a cell is kept when (r+1)·cap_per / n_eff >
//   r·cap_per / n_eff (int32, as the JAX package's thinning), and its slot
//   is r·cap_per / n_eff: the count of kept cells below it, since the kept
//   test telescopes (each step of the floor is 0 or 1). So the thinning
//   needs no second exchange, and below the cap it is the identity.
// - With ``divide`` a slot holds x / max(cnt, 1) (IEEE division), not the
//   sum x.
//
// Slots past the kept count are zeroed and marked invalid, as the TPU
// kernel's output is. Every slot is a bit-exact copy (or one IEEE quotient)
// of one cell, so the outputs equal the plain version's (the packed-key sort
// after kept_cells, then the division) bit for bit. A CTA must not exit while
// another may still read its shared memory: each arrives at a second cluster
// barrier after its reads and waits on it at the end.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;  // == 32: one warp scans a chunk's warp totals
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_CHUNKS = 16;       // cells per CTA up to 16 x 1024: rows up to 2^17 cells

struct CArgs {
  const float* xs;
  const float* ys;
  const float* zs;
  const float* counts;
  const uint8_t* kept;  // null: the derived mode
  int n_per, cap_per, divide;
  float* pts;
  float* cnt;
  uint8_t* valid;
};

// Relaxed: what it guards are this thread's reads of other CTAs' shared
// memory, whose values are used (so complete) before it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 2) compact_kernel(const CArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int warp_off[MAX_CHUNKS][WARPS];
  __shared__ int chunk_off[MAX_CHUNKS];
  __shared__ int cta_total;  // read by the cluster's other CTAs
  __shared__ int row_base, row_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int row = blockIdx.x / cs;
  const int span = (a.n_per + cs - 1) / cs;
  const int s0 = min(a.n_per, rank * span), s1 = min(a.n_per, s0 + span);
  const int n_chunks = (s1 - s0 + THREADS - 1) / THREADS;
  const size_t roff = (size_t)row * a.n_per;
  const bool derived = a.kept == nullptr;

  unsigned flags = 0;  // bit ch: this thread's cell of chunk ch is flagged
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int i = s0 + ch * THREADS + tid;
    bool f = false;
    if (i < s1) f = derived ? a.counts[roff + i] > 0.0f : a.kept[roff + i] != 0;
    const unsigned bal = __ballot_sync(TD_FULL_MASK, f);
    if (lane == 0) warp_off[ch][warp] = __popc(bal);
    flags |= (unsigned)f << ch;
  }
  __syncthreads();
  if (warp < n_chunks) {
    const int t = warp_off[warp][lane];
    int incl = t;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(TD_FULL_MASK, incl, off);
      if (lane >= off) incl += u;
    }
    warp_off[warp][lane] = incl - t;
    if (lane == 31) chunk_off[warp] = incl;
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int t = chunk_off[ch];
      chunk_off[ch] = run;
      run += t;
    }
    cta_total = run;
  }
  cluster.sync();
  if (warp == 0) {
    int t = lane < cs ? *cluster.map_shared_rank(&cta_total, lane) : 0;
    int below = lane < rank ? t : 0;
    for (int off = 16; off > 0; off >>= 1) {
      t += __shfl_xor_sync(TD_FULL_MASK, t, off);
      below += __shfl_xor_sync(TD_FULL_MASK, below, off);
    }
    if (lane == 0) {
      row_base = below;
      row_total = t;
    }
  }
  cluster_arrive();  // this CTA's reads of the others' totals are done
  __syncthreads();

  const int base = row_base, n = row_total, cap = a.cap_per;
  const int n_eff = max(n, cap);
  float* P = a.pts + (size_t)row * cap * 3;
  float* N = a.cnt + (size_t)row * cap;
  uint8_t* V = a.valid + (size_t)row * cap;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const bool f = (flags >> ch) & 1u;
    const unsigned bal = __ballot_sync(TD_FULL_MASK, f);
    if (!f) continue;
    const int r = base + chunk_off[ch] + warp_off[ch][warp] + __popc(bal & ((1u << lane) - 1u));
    int slot = r;
    if (derived) {
      slot = r * cap / n_eff;
      if ((r + 1) * cap / n_eff <= slot) continue;  // thinned out
    } else if (r >= cap) {
      continue;
    }
    const size_t i = roff + s0 + ch * THREADS + tid;
    const float c = a.counts[i];
    float x = a.xs[i], y = a.ys[i], z = a.zs[i];
    if (a.divide) {
      const float d = fmaxf(c, 1.0f);
      x = x / d;
      y = y / d;
      z = z / d;
    }
    P[slot * 3 + 0] = x;
    P[slot * 3 + 1] = y;
    P[slot * 3 + 2] = z;
    N[slot] = c;
    V[slot] = 1;
  }
  for (int s = min(n, cap) + rank * THREADS + tid; s < cap; s += cs * THREADS) {
    P[s * 3 + 0] = 0.0f;
    P[s * 3 + 1] = 0.0f;
    P[s * 3 + 2] = 0.0f;
    N[s] = 0.0f;
    V[s] = 0;
  }
  cluster_wait();
}

}  // namespace

// kept: the explicit kept flags, or null to derive them from the counts by
// the even-stride thinning; divide: store x / max(cnt, 1) for the sums.
extern "C" int trackdlo_compact(const float* xs, const float* ys, const float* zs,
                                const float* counts, const uint8_t* kept, int n_channels,
                                int n_per, int cap_per, int divide, float* pts, float* cnt,
                                uint8_t* valid, void* stream) {
  if (n_channels < 0 || n_per < 0 || cap_per <= 0) return (int)cudaErrorInvalidValue;
  if (kept == nullptr && (long long)n_per * cap_per >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  // A CTA for each 1024 cells, at most 8, and no more CTAs in all than the
  // card has SMs while the chunks allow: the ranks are exact integers, so
  // the cluster size changes no output.
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  int cs = (n_per + THREADS - 1) / THREADS;
  const int fit = n_channels > 0 ? sm_count / n_channels : 1;
  cs = cs > fit ? fit : cs;
  cs = cs > MAX_CLUSTER ? MAX_CLUSTER : cs;
  const int min_cs = (n_per + MAX_CHUNKS * THREADS - 1) / (MAX_CHUNKS * THREADS);
  cs = cs < min_cs ? min_cs : (cs < 1 ? 1 : cs);
  if (cs > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  if ((long long)n_channels * cs > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  if (n_channels == 0) return 0;
  const CArgs a{xs, ys, zs, counts, kept, n_per, cap_per, divide, pts, cnt, valid};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_channels * cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, compact_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
