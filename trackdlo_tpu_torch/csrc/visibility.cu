// Kernel V: node visibility for one frame.
//
// Replaces: trackdlo_tpu/ops/visibility_kernel.py fused_visibility
// (_visibility_kernel).
//
// What bounds it on an H100: latency. The (M, N) distance sweep is ~0.4
// MFLOP over ~50 KB of points; the node-space logic (edge ranks, painter's
// coverage, gap fill, prefix packs) is O(M²) on 45 nodes. As plain tensor
// code it is ~60 small launches.
//
// Design: one CTA of 512 threads. A first sweep over the points gives each
// node's nearest valid point (warp min trees, then a min over warps). The
// node-space logic then runs in shared memory with one thread per node or
// edge: stable edge ranks by counting (ties by index), painter's coverage in
// pixel space, gap fill, and prefix packs whose empty slots hold m-1. A
// second sweep recomputes the distances (instead of keeping the (M, N)
// block, which the TPU kept resident) for each point's minimum over all
// nodes and over the extended-visible nodes. Pixel coordinates use an IEEE
// divide and truncation, with pz == 0 guarded.
#include "common.cuh"

namespace {

constexpr int MMAX = 64;
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr float SENTINEL = 1e10f;
constexpr int BIG_RANK = 1 << 30;

__device__ __forceinline__ float sqd(const float* y, int j, float x0, float x1, float x2) {
  float d0 = y[j * 3 + 0] - x0, d1 = y[j * 3 + 1] - x1, d2 = y[j * 3 + 2] - x2;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

__global__ void __launch_bounds__(THREADS, 1) visibility_kernel(
    const float* __restrict__ y_in, const float* __restrict__ x,
    const uint8_t* __restrict__ xm, const float* __restrict__ proj,
    const float* __restrict__ coord_in, int m, int n, int img_rows, int img_cols,
    float tau_vis, float w_half, float d_vis, uint8_t* visible_out,
    uint8_t* extended_out, uint8_t* not_occ_out, float* shortest_out,
    int* vis_idx, int* ext_idx, int* counts, float* pmin_all, float* pmin_ext) {
  __shared__ float y[MMAX * 3], coord[MMAX], wmin[NWARPS * MMAX];
  __shared__ float shortest[MMAX], edge_d2[MMAX];
  __shared__ float pu[MMAX], pv[MMAX], ru[MMAX], rv[MMAX];
  __shared__ int rank[MMAX];
  __shared__ uint8_t vis[MMAX], ext[MMAX];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int k = tid; k < m * 3; k += THREADS) y[k] = y_in[k];
  for (int k = tid; k < m; k += THREADS) coord[k] = coord_in[k];
  __syncthreads();

  // Sweep 1: per-node nearest valid point.
  for (int j = 0; j < m; ++j) {
    float mn = SENTINEL;
    for (int i = tid; i < n; i += THREADS)
      if (xm[i]) mn = fminf(mn, sqd(y, j, x[i * 3], x[i * 3 + 1], x[i * 3 + 2]));
    mn = td_warp_min(mn);
    if (lane == 0) wmin[warp * MMAX + j] = mn;
  }
  __syncthreads();

  if (tid < m) {
    float mn = SENTINEL;
    for (int w = 0; w < NWARPS; ++w) mn = fminf(mn, wmin[w * MMAX + tid]);
    shortest[tid] = sqrtf(mn);
    // Edge tid joins nodes tid and tid+1; draw order by midpoint distance.
    if (tid < m - 1) {
      const float mx = (y[tid * 3 + 0] + y[tid * 3 + 3]) / 2.0f;
      const float my = (y[tid * 3 + 1] + y[tid * 3 + 4]) / 2.0f;
      const float mz = (y[tid * 3 + 2] + y[tid * 3 + 5]) / 2.0f;
      edge_d2[tid] = mx * mx + my * my + mz * mz;
    }
    const float y0 = y[tid * 3], y1 = y[tid * 3 + 1], y2 = y[tid * 3 + 2];
    const float px = y0 * proj[0] + y1 * proj[1] + y2 * proj[2] + proj[3];
    const float py = y0 * proj[4] + y1 * proj[5] + y2 * proj[6] + proj[7];
    const float pz = y0 * proj[8] + y1 * proj[9] + y2 * proj[10] + proj[11];
    const float pz_s = pz == 0.0f ? 1.0f : pz;
    const float u = (float)(int)(px / pz_s);
    const float v = (float)(int)(py / pz_s);
    pu[tid] = u;
    pv[tid] = v;
    ru[tid] = fminf(fmaxf(u, 0.0f), (float)(img_cols - 1));
    rv[tid] = fminf(fmaxf(v, 0.0f), (float)(img_rows - 1));
  }
  __syncthreads();

  // Stable ascending edge ranks (ties broken by index).
  if (tid < m - 1) {
    const float d = edge_d2[tid];
    int r = 0;
    for (int e = 0; e < m - 1; ++e)
      r += (edge_d2[e] < d || (edge_d2[e] == d && e < tid)) ? 1 : 0;
    rank[tid] = r;
  }
  __syncthreads();

  // Painter's self-occlusion: a node is occluded if an edge drawn before
  // its first adjacent edge covers its pixel.
  if (tid < m) {
    const int r_next = tid < m - 1 ? rank[tid] : BIG_RANK;
    const int r_prev = tid > 0 ? rank[tid - 1] : BIG_RANK;
    const int check = min(r_next, r_prev);
    bool covered = false;
    for (int e = 0; e < m - 1; ++e) {
      if (rank[e] >= check) continue;
      const float ax = pu[e], ay = pv[e];
      const float abx = pu[e + 1] - ax, aby = pv[e + 1] - ay;
      const float apx = ru[tid] - ax, apy = rv[tid] - ay;
      const float denom = fmaxf(abx * abx + aby * aby, 1e-12f);
      const float t = fminf(fmaxf((apx * abx + apy * aby) / denom, 0.0f), 1.0f);
      const float dx = ru[tid] - (ax + t * abx);
      const float dy = rv[tid] - (ay + t * aby);
      if (sqrtf(dx * dx + dy * dy) <= w_half) covered = true;
    }
    not_occ_out[tid] = covered ? 0 : 1;
    shortest_out[tid] = shortest[tid];
    vis[tid] = (!covered && shortest[tid] <= tau_vis) ? 1 : 0;
  }
  __syncthreads();

  // Geodesic gap fill between the nearest visible neighbours.
  if (tid < m) {
    int prev = -1, next = -1;
    for (int j = tid; j >= 0; --j)
      if (vis[j]) { prev = j; break; }
    for (int j = tid; j < m; ++j)
      if (vis[j]) { next = j; break; }
    bool e = vis[tid] != 0;
    if (!e && prev >= 0 && next >= 0) e = fabsf(coord[next] - coord[prev]) <= d_vis;
    ext[tid] = e ? 1 : 0;
    visible_out[tid] = vis[tid];
    extended_out[tid] = ext[tid];
  }
  __syncthreads();

  if (tid == 0) {
    int cv = 0, ce = 0;
    for (int j = 0; j < m; ++j) {
      if (vis[j]) vis_idx[cv++] = j;
      if (ext[j]) ext_idx[ce++] = j;
    }
    for (int j = cv; j < m; ++j) vis_idx[j] = m - 1;
    for (int j = ce; j < m; ++j) ext_idx[j] = m - 1;
    counts[0] = cv;
    counts[1] = ce;
  }

  // Sweep 2: per-point minima over all nodes and over extended nodes.
  for (int i = tid; i < n; i += THREADS) {
    float ma = SENTINEL, me = SENTINEL;
    if (xm[i]) {
      const float x0 = x[i * 3], x1 = x[i * 3 + 1], x2 = x[i * 3 + 2];
      for (int j = 0; j < m; ++j) {
        const float s = sqd(y, j, x0, x1, x2);
        ma = fminf(ma, s);
        if (ext[j]) me = fminf(me, s);
      }
    }
    pmin_all[i] = ma;
    pmin_ext[i] = me;
  }
}

}  // namespace

extern "C" int trackdlo_visibility(
    const float* y, const float* x, const uint8_t* xm, const float* proj,
    const float* coord, int m, int n, int img_rows, int img_cols,
    float tau_vis, float w_half, float d_vis, uint8_t* visible,
    uint8_t* extended, uint8_t* not_occ, float* shortest, int* vis_idx,
    int* ext_idx, int* counts, float* pmin_all, float* pmin_ext, void* stream) {
  if (m < 2 || m > MMAX || n < 0) return (int)cudaErrorInvalidValue;
  visibility_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      y, x, xm, proj, coord, m, n, img_rows, img_cols, tau_vis, w_half, d_vis,
      visible, extended, not_occ, shortest, vis_idx, ext_idx, counts, pmin_all,
      pmin_ext);
  return (int)cudaGetLastError();
}
