// Kernel W: the pure-pursuit correspondence-prior walks.
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py pursuit_walks_fused
// (_walks_kernel, _walks_impl).
//
// What bounds it on an H100: latency. Each walk is M-1 = 44 dependent steps
// of a sphere-vs-segment test over at most 44 segments; the data (a few KB)
// sits in registers. As plain tensor code every step is ~40 launches.
//
// Design: one warp per walk (four warps for one stream, 4·B for B streams),
// lanes cover the segments (two per lane), the first acceptable hit is a
// warp min, and the chosen intersection is broadcast from its lane with a
// shuffle. The steps run in sequence inside the warp; nothing leaves
// registers except the visited node positions. Arithmetic follows the
// plain version's operation order (the library is built with -fmad=false).
#include "common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 4;
constexpr int SEG_PER_LANE = 2;  // up to 64 segments (m <= 65)

__global__ void walks_kernel(const float* __restrict__ guides,
                             const float* __restrict__ seglens,
                             const int* __restrict__ ints, int n_walks, int m,
                             float eps, float* __restrict__ pos,
                             uint8_t* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const int wk = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (wk >= n_walks) return;  // warp-uniform
  const float* G = guides + (size_t)wk * m * 3;
  const int n_seg = m - 1;
  const int start_guide = ints[wk * 5 + 0];
  const int seg_hi = ints[wk * 5 + 1];
  const int outer_hi = ints[wk * 5 + 2];
  const int start_node = ints[wk * 5 + 3];
  const int count = ints[wk * 5 + 4];
  float* P = pos + (size_t)wk * m * 3;
  uint8_t* V = valid + (size_t)wk * m;

  float ax[SEG_PER_LANE], ay[SEG_PER_LANE], az[SEG_PER_LANE];
  float bx[SEG_PER_LANE], by[SEG_PER_LANE], bz[SEG_PER_LANE];
  float abx[SEG_PER_LANE], aby[SEG_PER_LANE], abz[SEG_PER_LANE], qa[SEG_PER_LANE];
  bool exists[SEG_PER_LANE];
#pragma unroll
  for (int k = 0; k < SEG_PER_LANE; ++k) {
    const int s = lane + 32 * k;
    exists[k] = s < n_seg && s < count - 1;
    const int sa = min(s, n_seg - 1);
    ax[k] = G[sa * 3 + 0];
    ay[k] = G[sa * 3 + 1];
    az[k] = G[sa * 3 + 2];
    bx[k] = G[sa * 3 + 3];
    by[k] = G[sa * 3 + 4];
    bz[k] = G[sa * 3 + 5];
    abx[k] = bx[k] - ax[k];
    aby[k] = by[k] - ay[k];
    abz[k] = bz[k] - az[k];
    qa[k] = abx[k] * abx[k] + aby[k] * aby[k] + abz[k] * abz[k];
  }

  for (int j = lane; j < m; j += 32) {
    P[j * 3 + 0] = 0.0f;
    P[j * 3 + 1] = 0.0f;
    P[j * 3 + 2] = 0.0f;
    V[j] = 0;
  }
  __syncwarp();
  const int sg = min(max(start_guide, 0), m - 1);
  float cx = G[sg * 3 + 0], cy = G[sg * 3 + 1], cz = G[sg * 3 + 2];
  if (lane == 0 && start_node >= 0 && start_node < m) {
    P[start_node * 3 + 0] = cx;
    P[start_node * 3 + 1] = cy;
    P[start_node * 3 + 2] = cz;
    V[start_node] = 1;
  }
  int last = start_guide, node_pos = start_node;
  bool alive = true;

  for (int step = 0; step < m - 1; ++step) {
    const bool alive_t = alive && last <= outer_hi && node_pos + 1 <= m - 1;
    const float look = seglens[(size_t)wk * (m - 1) + min(max(node_pos, 0), m - 2)];
    float chx[SEG_PER_LANE], chy[SEG_PER_LANE], chz[SEG_PER_LANE];
    float first_local = 1e9f;
#pragma unroll
    for (int k = SEG_PER_LANE - 1; k >= 0; --k) {
      const int s = lane + 32 * k;
      const float cax = ax[k] - cx, cay = ay[k] - cy, caz = az[k] - cz;
      const float qb = 2.0f * (abx[k] * cax + aby[k] * cay + abz[k] * caz);
      const float qc = (cax * cax + cay * cay + caz * caz) - look * look;
      const float delta = qb * qb - 4.0f * qa[k] * qc;
      const float sq = sqrtf(fmaxf(delta, 0.0f));
      const float qa_s = qa[k] == 0.0f ? 1.0f : qa[k];
      const float d1 = (-qb + sq) / (2.0f * qa_s);
      const float d2 = (-qb - sq) / (2.0f * qa_s);
      const float p1x = ax[k] + d1 * abx[k], p1y = ay[k] + d1 * aby[k], p1z = az[k] + d1 * abz[k];
      const float p2x = ax[k] + d2 * abx[k], p2y = ay[k] + d2 * aby[k], p2z = az[k] + d2 * abz[k];
      const float lox = fminf(ax[k], bx[k]) - eps, hix = fmaxf(ax[k], bx[k]) + eps;
      const float loy = fminf(ay[k], by[k]) - eps, hiy = fmaxf(ay[k], by[k]) + eps;
      const float loz = fminf(az[k], bz[k]) - eps, hiz = fmaxf(az[k], bz[k]) + eps;
      const bool btw1 = p1x >= lox && p1x <= hix && p1y >= loy && p1y <= hiy && p1z >= loz && p1z <= hiz;
      const bool btw2 = p2x >= lox && p2x <= hix && p2y >= loy && p2y <= hiy && p2z >= loz && p2z <= hiz;
      const bool v1 = delta >= 0.0f && btw1 && qa[k] > 0.0f;  // a zero discriminant gives one root
      const bool v2 = delta > 0.0f && btw2 && qa[k] > 0.0f;
      const int cnt = (int)v1 + (int)v2;
      const float e1x = p1x - bx[k], e1y = p1y - by[k], e1z = p1z - bz[k];
      const float e2x = p2x - bx[k], e2y = p2y - by[k], e2z = p2z - bz[k];
      const float ecx = cx - bx[k], ecy = cy - by[k], ecz = cz - bz[k];
      const float d1b = sqrtf(e1x * e1x + e1y * e1y + e1z * e1z);
      const float d2b = sqrtf(e2x * e2x + e2y * e2y + e2z * e2z);
      const float dcb = sqrtf(ecx * ecx + ecy * ecy + ecz * ecz);
      const float dsb = v1 ? d1b : d2b;
      const bool acceptable = cnt == 2 || (cnt == 1 && dsb <= dcb);
      const bool pick1 = cnt == 2 ? d1b <= d2b : v1;
      chx[k] = pick1 ? p1x : p2x;
      chy[k] = pick1 ? p1y : p2y;
      chz[k] = pick1 ? p1z : p2z;
      const bool ok = acceptable && exists[k] && s >= last && s <= seg_hi;
      if (ok) first_local = (float)s;  // k descends, so the lowest s wins
    }
    const float first = td_warp_first(first_local < 1e9f, first_local);
    const bool found = first < 1e9f;
    const bool eff = alive_t && found;
    if (eff) {
      const int fs = (int)first;
      const int owner = fs & 31, kk = fs >> 5;
      float sx = chx[0], sy = chy[0], sz = chz[0];
#pragma unroll
      for (int k = 1; k < SEG_PER_LANE; ++k) {
        if (kk == k) {
          sx = chx[k];
          sy = chy[k];
          sz = chz[k];
        }
      }
      cx = __shfl_sync(TD_FULL_MASK, sx, owner);
      cy = __shfl_sync(TD_FULL_MASK, sy, owner);
      cz = __shfl_sync(TD_FULL_MASK, sz, owner);
      last = fs;
      node_pos += 1;
      if (lane == 0) {
        P[node_pos * 3 + 0] = cx;
        P[node_pos * 3 + 1] = cy;
        P[node_pos * 3 + 2] = cz;
        V[node_pos] = 1;
      }
    }
    alive = alive && found;
  }
}

}  // namespace

extern "C" int trackdlo_walks(const float* guides, const float* seglens,
                              const int* ints, int n_walks, int m, float eps,
                              float* pos, uint8_t* valid, void* stream) {
  if (m < 2 || m > 32 * SEG_PER_LANE + 1 || n_walks < 0) return (int)cudaErrorInvalidValue;
  if (n_walks == 0) return 0;
  const int blocks = (n_walks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  walks_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      guides, seglens, ints, n_walks, m, eps, pos, valid);
  return (int)cudaGetLastError();
}
