// Kernel W: the pure-pursuit correspondence-prior walks.
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py pursuit_walks_fused
// (_walks_kernel, _walks_impl).
//
// What bounds it on an H100: latency. Each walk is at most M-1 = 44
// dependent steps of a sphere-vs-segment test over at most 44 segments; the
// data (a few KB) sits in registers. As plain tensor code every step is ~40
// launches.
//
// Design: one warp per walk (four warps for one stream, 4·B for B streams);
// lanes own the segments (two per lane); the first acceptable hit is a warp
// minimum and the chosen intersection is broadcast from its lane with a
// shuffle. The steps run in sequence inside the warp. What a step's chain
// holds is cut to what the walk needs:
// - the walk's look-ahead lengths sit in registers (two per lane) and a
//   step reads its own with a shuffle, not a load from global memory;
// - each segment's loop-invariant terms (its box, 2 qa) are computed once;
// - a segment that cannot be taken (outside [last, seg_hi], missing, of
//   length 0, or with no real root) skips the roots; the roots' divisions
//   and square roots, and the distances that decide between them, are
//   computed only for the segments that can be (a step's chain then holds
//   them only where a lane of the warp has such a segment);
// - the lowest acceptable segment is one __reduce_min_sync;
// - the loop ends when the walk can no longer move (past outer_hi, at the
//   last node, or no acceptable segment: the warp-uniform conditions under
//   which every later step changes nothing).
// Every value is the previous design's: the same IEEE operations on the same
// operands (the library is built with -fmad=false), each division a true
// quotient. `valid` is written as bytes 0/1 straight into the caller's
// torch.bool tensor.
//
// Node bound: two segments a lane take up to 65 nodes, four up to 129; a
// launch takes the two-segment build where m <= 65. Past 129 nodes the
// unbounded build runs: a step tests the segments from ``last`` up in
// groups of 32, a segment a lane, read from the guides (L1) instead of
// registers, and stops at the first group holding an acceptable segment,
// whose lowest is one __reduce_min_sync (every segment of a later group is
// higher): the same operations on the same operands, so the same values.
#include <climits>

#include "common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 4;

// Element i of a lane's registers v[0..K) for a warp-uniform i.
template <int K>
__device__ __forceinline__ float pick_reg(const float (&v)[K], int i) {
  float out = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (i == k) out = v[k];
  return out;
}

template <int SEG_PER_LANE>
__global__ void walks_kernel(const float* __restrict__ guides,
                             const float* __restrict__ seglens,
                             const int* __restrict__ ints, int n_walks, int m,
                             float eps, float* __restrict__ pos,
                             uint8_t* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const int wk = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (wk >= n_walks) return;  // warp-uniform
  const float* G = guides + (size_t)wk * m * 3;
  const float* L = seglens + (size_t)wk * (m - 1);
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
  float den[SEG_PER_LANE];  // 2 qa (2 where qa is 0)
  float lox[SEG_PER_LANE], loy[SEG_PER_LANE], loz[SEG_PER_LANE];
  float hix[SEG_PER_LANE], hiy[SEG_PER_LANE], hiz[SEG_PER_LANE];
  float look_at[SEG_PER_LANE];  // the look-ahead of node position lane + 32 k
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
    den[k] = 2.0f * (qa[k] == 0.0f ? 1.0f : qa[k]);
    lox[k] = fminf(ax[k], bx[k]) - eps;
    hix[k] = fmaxf(ax[k], bx[k]) + eps;
    loy[k] = fminf(ay[k], by[k]) - eps;
    hiy[k] = fmaxf(ay[k], by[k]) + eps;
    loz[k] = fminf(az[k], bz[k]) - eps;
    hiz[k] = fmaxf(az[k], bz[k]) + eps;
    look_at[k] = L[sa];
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

  for (int step = 0; step < m - 1; ++step) {
    if (!(last <= outer_hi && node_pos + 1 <= m - 1)) break;
    const int li = min(max(node_pos, 0), m - 2);
    const float look = __shfl_sync(TD_FULL_MASK, pick_reg(look_at, li >> 5), li & 31);
    float chx[SEG_PER_LANE], chy[SEG_PER_LANE], chz[SEG_PER_LANE];
    int first_local = INT_MAX;
#pragma unroll
    for (int k = SEG_PER_LANE - 1; k >= 0; --k) {  // k descends, so the lowest s wins
      const int s = lane + 32 * k;
      chx[k] = chy[k] = chz[k] = 0.0f;
      if (!(exists[k] && s >= last && s <= seg_hi && qa[k] > 0.0f)) continue;
      const float cax = ax[k] - cx, cay = ay[k] - cy, caz = az[k] - cz;
      const float qb = 2.0f * (abx[k] * cax + aby[k] * cay + abz[k] * caz);
      const float qc = (cax * cax + cay * cay + caz * caz) - look * look;
      const float delta = qb * qb - 4.0f * qa[k] * qc;
      if (!(delta >= 0.0f)) continue;  // no real root
      const float sq = sqrtf(fmaxf(delta, 0.0f));
      const float d1 = (-qb + sq) / den[k];
      const float d2 = (-qb - sq) / den[k];
      const float p1x = ax[k] + d1 * abx[k], p1y = ay[k] + d1 * aby[k], p1z = az[k] + d1 * abz[k];
      const float p2x = ax[k] + d2 * abx[k], p2y = ay[k] + d2 * aby[k], p2z = az[k] + d2 * abz[k];
      const bool v1 = p1x >= lox[k] && p1x <= hix[k] && p1y >= loy[k] && p1y <= hiy[k] &&
                      p1z >= loz[k] && p1z <= hiz[k];
      const bool v2 = delta > 0.0f &&  // a zero discriminant gives one root
                      p2x >= lox[k] && p2x <= hix[k] && p2y >= loy[k] && p2y <= hiy[k] &&
                      p2z >= loz[k] && p2z <= hiz[k];
      if (!v1 && !v2) continue;
      bool pick1, acceptable;
      if (v1 && v2) {
        const float e1x = p1x - bx[k], e1y = p1y - by[k], e1z = p1z - bz[k];
        const float e2x = p2x - bx[k], e2y = p2y - by[k], e2z = p2z - bz[k];
        const float d1b = sqrtf(e1x * e1x + e1y * e1y + e1z * e1z);
        const float d2b = sqrtf(e2x * e2x + e2y * e2y + e2z * e2z);
        pick1 = d1b <= d2b;
        acceptable = true;
      } else {
        const float ex = (v1 ? p1x : p2x) - bx[k], ey = (v1 ? p1y : p2y) - by[k],
                    ez = (v1 ? p1z : p2z) - bz[k];
        const float ecx = cx - bx[k], ecy = cy - by[k], ecz = cz - bz[k];
        const float dsb = sqrtf(ex * ex + ey * ey + ez * ez);
        const float dcb = sqrtf(ecx * ecx + ecy * ecy + ecz * ecz);
        pick1 = v1;
        acceptable = dsb <= dcb;
      }
      if (!acceptable) continue;
      chx[k] = pick1 ? p1x : p2x;
      chy[k] = pick1 ? p1y : p2y;
      chz[k] = pick1 ? p1z : p2z;
      first_local = s;
    }
    const int first = __reduce_min_sync(TD_FULL_MASK, first_local);
    if (first == INT_MAX) break;  // no acceptable segment: the walk ends
    const int owner = first & 31, k_seg = first >> 5;
    cx = __shfl_sync(TD_FULL_MASK, pick_reg(chx, k_seg), owner);
    cy = __shfl_sync(TD_FULL_MASK, pick_reg(chy, k_seg), owner);
    cz = __shfl_sync(TD_FULL_MASK, pick_reg(chz, k_seg), owner);
    last = first;
    node_pos += 1;
    if (lane == 0) {
      P[node_pos * 3 + 0] = cx;
      P[node_pos * 3 + 1] = cy;
      P[node_pos * 3 + 2] = cz;
      V[node_pos] = 1;
    }
  }
}

__global__ void walks_ub_kernel(const float* __restrict__ guides,
                                const float* __restrict__ seglens,
                                const int* __restrict__ ints, int n_walks, int m, float eps,
                                float* __restrict__ pos, uint8_t* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const int wk = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (wk >= n_walks) return;  // warp-uniform
  const float* G = guides + (size_t)wk * m * 3;
  const float* L = seglens + (size_t)wk * (m - 1);
  const int n_seg = m - 1;
  const int start_guide = ints[wk * 5 + 0];
  const int seg_hi = ints[wk * 5 + 1];
  const int outer_hi = ints[wk * 5 + 2];
  const int start_node = ints[wk * 5 + 3];
  const int count = ints[wk * 5 + 4];
  float* P = pos + (size_t)wk * m * 3;
  uint8_t* V = valid + (size_t)wk * m;
  // The segments a step may take: s <= seg_hi that exist (s < n_seg and
  // s < count - 1).
  const int s_top = min(seg_hi, min(n_seg - 1, count - 2));

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

  for (int step = 0; step < m - 1; ++step) {
    if (!(last <= outer_hi && node_pos + 1 <= m - 1)) break;
    const float look = L[min(max(node_pos, 0), m - 2)];
    int first = INT_MAX;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    for (int base = max(last, 0); base <= s_top && first == INT_MAX; base += 32) {
      const int s = base + lane;
      int first_local = INT_MAX;
      float chx = 0.0f, chy = 0.0f, chz = 0.0f;
      if (s <= s_top) {
        const float ax = G[s * 3 + 0], ay = G[s * 3 + 1], az = G[s * 3 + 2];
        const float bx = G[s * 3 + 3], by = G[s * 3 + 4], bz = G[s * 3 + 5];
        const float abx = bx - ax, aby = by - ay, abz = bz - az;
        const float qa = abx * abx + aby * aby + abz * abz;
        if (qa > 0.0f) {
          const float den = 2.0f * qa;
          const float lox = fminf(ax, bx) - eps, hix = fmaxf(ax, bx) + eps;
          const float loy = fminf(ay, by) - eps, hiy = fmaxf(ay, by) + eps;
          const float loz = fminf(az, bz) - eps, hiz = fmaxf(az, bz) + eps;
          const float cax = ax - cx, cay = ay - cy, caz = az - cz;
          const float qb = 2.0f * (abx * cax + aby * cay + abz * caz);
          const float qc = (cax * cax + cay * cay + caz * caz) - look * look;
          const float delta = qb * qb - 4.0f * qa * qc;
          if (delta >= 0.0f) {
            const float sq = sqrtf(fmaxf(delta, 0.0f));
            const float d1 = (-qb + sq) / den;
            const float d2 = (-qb - sq) / den;
            const float p1x = ax + d1 * abx, p1y = ay + d1 * aby, p1z = az + d1 * abz;
            const float p2x = ax + d2 * abx, p2y = ay + d2 * aby, p2z = az + d2 * abz;
            const bool v1 = p1x >= lox && p1x <= hix && p1y >= loy && p1y <= hiy &&
                            p1z >= loz && p1z <= hiz;
            const bool v2 = delta > 0.0f && p2x >= lox && p2x <= hix && p2y >= loy &&
                            p2y <= hiy && p2z >= loz && p2z <= hiz;
            if (v1 || v2) {
              bool pick1, acceptable;
              if (v1 && v2) {
                const float e1x = p1x - bx, e1y = p1y - by, e1z = p1z - bz;
                const float e2x = p2x - bx, e2y = p2y - by, e2z = p2z - bz;
                const float d1b = sqrtf(e1x * e1x + e1y * e1y + e1z * e1z);
                const float d2b = sqrtf(e2x * e2x + e2y * e2y + e2z * e2z);
                pick1 = d1b <= d2b;
                acceptable = true;
              } else {
                const float ex = (v1 ? p1x : p2x) - bx, ey = (v1 ? p1y : p2y) - by,
                            ez = (v1 ? p1z : p2z) - bz;
                const float ecx = cx - bx, ecy = cy - by, ecz = cz - bz;
                const float dsb = sqrtf(ex * ex + ey * ey + ez * ez);
                const float dcb = sqrtf(ecx * ecx + ecy * ecy + ecz * ecz);
                pick1 = v1;
                acceptable = dsb <= dcb;
              }
              if (acceptable) {
                chx = pick1 ? p1x : p2x;
                chy = pick1 ? p1y : p2y;
                chz = pick1 ? p1z : p2z;
                first_local = s;
              }
            }
          }
        }
      }
      const int f = __reduce_min_sync(TD_FULL_MASK, first_local);
      if (f != INT_MAX) {
        fx = __shfl_sync(TD_FULL_MASK, chx, f - base);
        fy = __shfl_sync(TD_FULL_MASK, chy, f - base);
        fz = __shfl_sync(TD_FULL_MASK, chz, f - base);
        first = f;
      }
    }
    if (first == INT_MAX) break;  // no acceptable segment: the walk ends
    cx = fx;
    cy = fy;
    cz = fz;
    last = first;
    node_pos += 1;
    if (lane == 0) {
      P[node_pos * 3 + 0] = cx;
      P[node_pos * 3 + 1] = cy;
      P[node_pos * 3 + 2] = cz;
      V[node_pos] = 1;
    }
  }
}

}  // namespace

extern "C" int trackdlo_walks(const float* guides, const float* seglens,
                              const int* ints, int n_walks, int m, float eps,
                              float* pos, uint8_t* valid, void* stream) {
  if (m < 2 || n_walks < 0) return (int)cudaErrorInvalidValue;
  if (n_walks == 0) return 0;
  const int blocks = (n_walks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const cudaStream_t st = (cudaStream_t)stream;
  if (m > 32 * 4 + 1) {
    walks_ub_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0, st>>>(guides, seglens, ints, n_walks, m,
                                                             eps, pos, valid);
  } else if (m <= 32 * 2 + 1) {
    walks_kernel<2><<<blocks, 32 * WARPS_PER_BLOCK, 0, st>>>(guides, seglens, ints, n_walks, m,
                                                            eps, pos, valid);
  } else {
    walks_kernel<4><<<blocks, 32 * WARPS_PER_BLOCK, 0, st>>>(guides, seglens, ints, n_walks, m,
                                                            eps, pos, valid);
  }
  return (int)cudaGetLastError();
}
