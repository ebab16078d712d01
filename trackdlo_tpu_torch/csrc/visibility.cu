// Kernel V: node visibility for one frame.
//
// Replaces: trackdlo_tpu/ops/visibility_kernel.py fused_visibility
// (_visibility_kernel).
//
// What bounds it on an H100: latency. The (M, N) distance sweeps are ~0.3
// MFLOP over the ~360 valid points of a live cloud (~50 KB of points); the
// node-space logic (edge ranks, painter's coverage, gap fill, prefix packs)
// is O(M^2) on 45 nodes. As plain tensor code it is ~60 small launches.
//
// Design: one CTA of 512 threads per stream (B streams of a batch take one
// launch, one CTA each).
// - The valid rows of the cloud are compacted into shared memory once (warp
//   ballots and a block prefix, in row order; clouds longer than one
//   segment of SEG rows are taken a segment at a time), so both sweeps
//   touch only the valid points: about a sixth of the rows of a live cloud,
//   whose valid points sit at the front of each parity channel's block,
//   where a stride over all rows leaves most threads idle.
// - Each node's nearest valid point: the nodes are split over the warps
//   (warp w takes nodes w, w + 16, w + 32, ...) and each warp sweeps the
//   compacted points for its nodes, then a warp minimum per node; no
//   block-wide step per node.
// - The node-space logic runs in shared memory: stable edge ranks by
//   counting (ties by index); painter's coverage over every (node, edge)
//   pair on every thread, a covering pair setting its node's flag (the
//   arithmetic per pair is the plain version's); the gap fill and both
//   prefix packs from 64-bit node masks made by warp ballots (nearest
//   visible neighbours by bit scans, pack slots by __popcll), empty slots
//   holding m - 1.
// - Each point's minimum over all nodes and over the extended nodes: one
//   thread per compacted point, recomputing the distances (the TPU kept the
//   (M, N) block resident); rows that are not valid get the sentinel.
// - The outputs are written in the layouts of VisibilityOut (masks as
//   bytes of 0/1 that PyTorch reads as bool, indices and counts as int64),
//   into the views of one allocation, so no cast follows the launch.
// A minimum is exact in any order, so every value is the plain version's;
// pixel coordinates use an IEEE divide and truncation, with pz == 0
// guarded.
//
// Node bound: compiled for at most 64 nodes (one 64-bit word a node mask,
// four nodes a warp in sweep 1) and for at most 128 (two words, eight).
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int SEG = 2048;  // rows compacted at a time
constexpr float SENTINEL = 1e10f;
constexpr int BIG_RANK = 1 << 30;

__device__ __forceinline__ float sqd(const float* y, int j, float x0, float x1, float x2) {
  float d0 = y[j * 3 + 0] - x0, d1 = y[j * 3 + 1] - x1, d2 = y[j * 3 + 2] - x2;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

template <int MMAX>
struct Smem {
  float px[SEG], py[SEG], pz[SEG];  // the segment's valid points, in row order
  int pidx[SEG];                    // and their rows
  float y[MMAX * 3], coord[MMAX];
  float shortest[MMAX], edge_d2[MMAX];
  float pu[MMAX], pv[MMAX], ru[MMAX], rv[MMAX];
  int rank[MMAX];
  int covered[MMAX];
  unsigned bits[2][MMAX / 32];  // vis and ext masks, a word per 32 nodes
  int wcount[NWARPS];
};

// A set of nodes, one bit a node in W 64-bit words.
template <int W>
struct NodeMask {
  unsigned long long w[W];
  __device__ __forceinline__ bool has(int j) const { return (w[j >> 6] >> (j & 63)) & 1ull; }
  __device__ __forceinline__ int count() const {
    int c = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) c += __popcll(w[i]);
    return c;
  }
  // Members below node j.
  __device__ __forceinline__ int count_below(int j) const {
    int c = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int lo = 64 * i;
      if (j >= lo + 64) c += __popcll(w[i]);
      else if (j > lo) c += __popcll(w[i] & ((1ull << (j - lo)) - 1ull));
    }
    return c;
  }
  // The highest member at or below node j, else -1.
  __device__ __forceinline__ int prev_at_or_below(int j) const {
    for (int i = j >> 6; i >= 0; --i) {
      unsigned long long x = w[i];
      if (i == (j >> 6)) x &= ~0ull >> (63 - (j & 63));
      if (x) return 64 * i + 63 - __clzll(x);
    }
    return -1;
  }
  // The lowest member at or above node j, else -1.
  __device__ __forceinline__ int next_at_or_above(int j) const {
    const unsigned long long x = w[j >> 6] >> (j & 63);
    if (x) return j + __ffsll(x) - 1;
    for (int i = (j >> 6) + 1; i < W; ++i)
      if (w[i]) return 64 * i + __ffsll(w[i]) - 1;
    return -1;
  }
};

// Compacts the valid rows [r0, min(n, r0 + SEG)) into S (row order) and
// writes the sentinel to both point minima of every other row; returns the
// count (the same in every thread). Starts with a barrier (no thread still
// reads the previous segment) and ends in one.
template <class SM>
__device__ int compact_segment(const float* x, const uint8_t* xm, int n, int r0, SM& S,
                               float* pmin_all, float* pmin_ext) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r1 = min(n, r0 + SEG);
  int count = 0;
  __syncthreads();
  for (int seg = r0; seg < r1; seg += THREADS) {
    const int i = seg + tid;
    const bool v = i < r1 && xm[i];
    if (i < r1 && !v) {
      pmin_all[i] = SENTINEL;
      pmin_ext[i] = SENTINEL;
    }
    const unsigned bal = __ballot_sync(TD_FULL_MASK, v);
    if (lane == 0) S.wcount[warp] = __popc(bal);
    __syncthreads();
    int off = count, total = 0;
    for (int w = 0; w < NWARPS; ++w) {
      if (w < warp) off += S.wcount[w];
      total += S.wcount[w];
    }
    off += __popc(bal & ((1u << lane) - 1u));
    if (v) {
      S.px[off] = x[(size_t)i * 3 + 0];
      S.py[off] = x[(size_t)i * 3 + 1];
      S.pz[off] = x[(size_t)i * 3 + 2];
      S.pidx[off] = i;
    }
    count += total;
    __syncthreads();
  }
  return count;
}

// The node mask of the flags ``f`` of threads 0..MMAX-1 (the others pass
// false): every thread calls it; ends in a barrier.
template <int MMAX>
__device__ NodeMask<MMAX / 64> node_mask(bool f, unsigned (&word)[MMAX / 32]) {
  const int tid = threadIdx.x;
  const unsigned bal = __ballot_sync(TD_FULL_MASK, f);
  if (tid < MMAX && (tid & 31) == 0) word[tid >> 5] = bal;
  __syncthreads();
  NodeMask<MMAX / 64> mask;
#pragma unroll
  for (int i = 0; i < MMAX / 64; ++i)
    mask.w[i] = (unsigned long long)word[2 * i] | ((unsigned long long)word[2 * i + 1] << 32);
  return mask;
}

template <int MMAX>
__global__ void __launch_bounds__(THREADS, 1) visibility_kernel(
    const float* __restrict__ y_in, const float* __restrict__ x,
    const uint8_t* __restrict__ xm, const float* __restrict__ proj,
    const float* __restrict__ coord_in, int m, int n, int img_rows, int img_cols,
    float tau_vis, float w_half, float d_vis, uint8_t* visible_out,
    uint8_t* extended_out, uint8_t* not_occ_out, float* shortest_out,
    long long* vis_idx, long long* ext_idx, long long* counts, float* pmin_all,
    float* pmin_ext) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MMAX>& S = *reinterpret_cast<Smem<MMAX>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sm = (size_t)blockIdx.x * m, sn = (size_t)blockIdx.x * n;
  y_in += sm * 3;
  coord_in += sm;
  x += sn * 3;
  xm += sn;
  visible_out += sm;
  extended_out += sm;
  not_occ_out += sm;
  shortest_out += sm;
  vis_idx += sm;
  ext_idx += sm;
  counts += (size_t)blockIdx.x * 2;
  pmin_all += sn;
  pmin_ext += sn;

  for (int k = tid; k < m * 3; k += THREADS) S.y[k] = y_in[k];
  for (int k = tid; k < m; k += THREADS) {
    S.coord[k] = coord_in[k];
    S.covered[k] = 0;
  }

  __syncthreads();

  // Sweep 1: each node's nearest valid point; warp w keeps nodes
  // w + 16 t in registers across the segments.
  constexpr int NPW = MMAX / NWARPS;  // nodes per warp
  float ny[NPW][3], mn[NPW];
#pragma unroll
  for (int t = 0; t < NPW; ++t) {
    const int j = warp + NWARPS * t;
    mn[t] = SENTINEL;
    for (int d = 0; d < 3; ++d) ny[t][d] = j < m ? S.y[j * 3 + d] : 0.0f;
  }
  int count = 0;
  for (int r0 = 0; r0 < max(n, 1); r0 += SEG) {
    count = compact_segment(x, xm, n, r0, S, pmin_all, pmin_ext);
    for (int q = lane; q < count; q += 32) {
      const float x0 = S.px[q], x1 = S.py[q], x2 = S.pz[q];
#pragma unroll
      for (int t = 0; t < NPW; ++t) {
        if (warp + NWARPS * t >= m) continue;  // the same in the whole warp
        const float d0 = ny[t][0] - x0, d1 = ny[t][1] - x1, d2 = ny[t][2] - x2;
        mn[t] = fminf(mn[t], d0 * d0 + d1 * d1 + d2 * d2);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NPW; ++t) {
    const int j = warp + NWARPS * t;
    const float v = td_warp_min(mn[t]);
    if (lane == 0 && j < m) S.shortest[j] = sqrtf(v);
  }
  if (tid < m) {
    // Edge tid joins nodes tid and tid+1; draw order by midpoint distance.
    const float* y = S.y;
    if (tid < m - 1) {
      const float mx = (y[tid * 3 + 0] + y[tid * 3 + 3]) / 2.0f;
      const float my = (y[tid * 3 + 1] + y[tid * 3 + 4]) / 2.0f;
      const float mz = (y[tid * 3 + 2] + y[tid * 3 + 5]) / 2.0f;
      S.edge_d2[tid] = mx * mx + my * my + mz * mz;
    }
    const float y0 = y[tid * 3], y1 = y[tid * 3 + 1], y2 = y[tid * 3 + 2];
    const float px = y0 * proj[0] + y1 * proj[1] + y2 * proj[2] + proj[3];
    const float py = y0 * proj[4] + y1 * proj[5] + y2 * proj[6] + proj[7];
    const float pz = y0 * proj[8] + y1 * proj[9] + y2 * proj[10] + proj[11];
    const float pz_s = pz == 0.0f ? 1.0f : pz;
    const float u = (float)(int)(px / pz_s);
    const float v = (float)(int)(py / pz_s);
    S.pu[tid] = u;
    S.pv[tid] = v;
    S.ru[tid] = fminf(fmaxf(u, 0.0f), (float)(img_cols - 1));
    S.rv[tid] = fminf(fmaxf(v, 0.0f), (float)(img_rows - 1));
  }
  __syncthreads();

  // Stable ascending edge ranks (ties broken by index).
  if (tid < m - 1) {
    const float d = S.edge_d2[tid];
    int r = 0;
    for (int e = 0; e < m - 1; ++e)
      r += (S.edge_d2[e] < d || (S.edge_d2[e] == d && e < tid)) ? 1 : 0;
    S.rank[tid] = r;
  }
  __syncthreads();

  // Painter's self-occlusion over every (node, edge) pair: a node is
  // occluded if an edge drawn before its first adjacent edge covers its
  // pixel. Every covering pair stores the same 1.
  for (int q = tid; q < m * (m - 1); q += THREADS) {
    const int i = q / (m - 1), e = q - i * (m - 1);
    const int r_next = i < m - 1 ? S.rank[i] : BIG_RANK;
    const int r_prev = i > 0 ? S.rank[i - 1] : BIG_RANK;
    if (S.rank[e] >= min(r_next, r_prev)) continue;
    const float ax = S.pu[e], ay = S.pv[e];
    const float abx = S.pu[e + 1] - ax, aby = S.pv[e + 1] - ay;
    const float apx = S.ru[i] - ax, apy = S.rv[i] - ay;
    const float denom = fmaxf(abx * abx + aby * aby, 1e-12f);
    const float t = fminf(fmaxf((apx * abx + apy * aby) / denom, 0.0f), 1.0f);
    const float dx = S.ru[i] - (ax + t * abx);
    const float dy = S.rv[i] - (ay + t * aby);
    if (sqrtf(dx * dx + dy * dy) <= w_half) S.covered[i] = 1;
  }
  __syncthreads();

  // Visible: not self-occluded and near the cloud; then the geodesic gap
  // fill between the nearest visible neighbours, and the packs.
  const bool vis = tid < m && !S.covered[tid] && S.shortest[tid] <= tau_vis;
  const auto vmask = node_mask<MMAX>(vis, S.bits[0]);
  bool ext = false;
  if (tid < m) {
    ext = vis;
    if (!ext) {
      const int prev = vmask.prev_at_or_below(tid);
      const int next = vmask.next_at_or_above(tid);
      if (prev >= 0 && next >= 0) ext = fabsf(S.coord[next] - S.coord[prev]) <= d_vis;
    }
    not_occ_out[tid] = S.covered[tid] ? 0 : 1;
    shortest_out[tid] = S.shortest[tid];
    visible_out[tid] = vis ? 1 : 0;
    extended_out[tid] = ext ? 1 : 0;
  }
  const auto emask = node_mask<MMAX>(ext, S.bits[1]);
  if (tid < m) {
    const int cv = vmask.count(), ce = emask.count();
    if (vis) vis_idx[vmask.count_below(tid)] = tid;
    if (ext) ext_idx[emask.count_below(tid)] = tid;
    if (tid >= cv) vis_idx[tid] = m - 1;
    if (tid >= ce) ext_idx[tid] = m - 1;
    if (tid == 0) {
      counts[0] = cv;
      counts[1] = ce;
    }
  }

  // Sweep 2: each valid point's minimum over all nodes and over the
  // extended nodes, one thread per compacted point (the last segment is
  // still in shared memory; earlier ones are compacted again).
  const int nseg = (n + SEG - 1) / SEG;
  for (int s = 0; s < nseg; ++s) {
    const int r0 = s * SEG;
    if (nseg > 1) count = compact_segment(x, xm, n, r0, S, pmin_all, pmin_ext);
    for (int q = tid; q < count; q += THREADS) {
      const float x0 = S.px[q], x1 = S.py[q], x2 = S.pz[q];
      float ma = SENTINEL, me = SENTINEL;
      for (int j = 0; j < m; ++j) {
        const float d = sqd(S.y, j, x0, x1, x2);
        ma = fminf(ma, d);
        if (emask.has(j)) me = fminf(me, d);
      }
      pmin_all[S.pidx[q]] = ma;
      pmin_ext[S.pidx[q]] = me;
    }
  }
}

template <int MMAX>
int launch(const float* y, const float* x, const uint8_t* xm, const float* proj,
           const float* coord, int n_streams, int m, int n, int img_rows, int img_cols,
           float tau_vis, float w_half, float d_vis, uint8_t* visible, uint8_t* extended,
           uint8_t* not_occ, float* shortest, long long* vis_idx, long long* ext_idx,
           long long* counts, float* pmin_all, float* pmin_ext, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<MMAX>);
  cudaError_t err = cudaFuncSetAttribute(visibility_kernel<MMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  visibility_kernel<MMAX><<<n_streams, THREADS, smem, stream>>>(
      y, x, xm, proj, coord, m, n, img_rows, img_cols, tau_vis, w_half, d_vis,
      visible, extended, not_occ, shortest, vis_idx, ext_idx, counts, pmin_all,
      pmin_ext);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int trackdlo_visibility(
    const float* y, const float* x, const uint8_t* xm, const float* proj,
    const float* coord, int n_streams, int m, int n, int img_rows, int img_cols,
    float tau_vis, float w_half, float d_vis, uint8_t* visible,
    uint8_t* extended, uint8_t* not_occ, float* shortest, long long* vis_idx,
    long long* ext_idx, long long* counts, float* pmin_all, float* pmin_ext, void* stream) {
  if (m < 2 || m > 128 || n < 0 || n_streams < 0) return (int)cudaErrorInvalidValue;
  if (n_streams == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return m <= 64 ? launch<64>(y, x, xm, proj, coord, n_streams, m, n, img_rows, img_cols,
                              tau_vis, w_half, d_vis, visible, extended, not_occ, shortest,
                              vis_idx, ext_idx, counts, pmin_all, pmin_ext, st)
                 : launch<128>(y, x, xm, proj, coord, n_streams, m, n, img_rows, img_cols,
                               tau_vis, w_half, d_vis, visible, extended, not_occ, shortest,
                               vis_idx, ext_idx, counts, pmin_all, pmin_ext, st);
}
