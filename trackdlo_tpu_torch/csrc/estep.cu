// Kernel S: the streamed E-step of B EM streams in one launch (B = 1 is the
// unbatched E-step).
//
// Replaces: trackdlo_tpu/ops/pallas_kernels.py fused_estep_packed_batch
// (_estep_kernel_batch) and, launched for one stream, fused_estep_packed
// (_estep_kernel): the E-step of one iteration of the per-iteration EM.
//
// What bounds it on an H100: latency and the exponentials. One stream at
// M = 45 and 4096 points is ~0.4 M exp and ~8 MFLOP over ~70 KB of inputs;
// the outputs are O(M). The TPU streamed (m_pad, 512) tiles of all B streams
// through VMEM together; here each stream is an independent block.
//
// Design: one block of 512 threads per stream, as kernel E's E-step. With
// two phases and the visibility gate of ANY stream on, a first sweep keeps
// each thread's 48 node minima in registers and reduces them with warp min
// trees (the batched kernel skips that sweep only when no stream's gate is
// on; shortest_sq then keeps the 1e5 sentinel). Then one thread per point
// keeps the point's 48 memberships in registers: first normalisation, the
// first argmax (ties to the lowest row), the anchor pair with the TPU's
// boundary fallbacks and its out-of-range row select (0 outside [0, m_pad);
// rows in [m, m_pad) are the TPU's zero pad rows), the geodesic re-distance,
// the gate blends p·(1 + g·(pv − 1)) and c_plain + g·(c_vis − c_plain), the
// second normalisation and the pair mask. The chunk's memberships go to
// shared memory, where one warp per (node, quantity) sums them in a fixed
// order; Np and tr(XᵀdPt1X) use a fixed-order block tree. No float atomics.
#include "common.cuh"

namespace {

constexpr int MMAX = 48;
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int CHUNK = THREADS;
constexpr float BIG = 1e5f;

struct EArgs {
  const float* scal;   // (B, 8): sigma2, c_plain, c_vis, gate, v_count, k_vis, tau_vis, -
  const float* y;      // (B, m, 3)
  const float* coord;  // (B, m)
  const float* nm;     // (B, m) 0/1
  const float* pv;     // (B, m) visibility weights (one-phase mode)
  const float* x;      // (B, n, 3)
  const float* xm;     // (B, n) 0/1
  int n_streams, m, n, two_phase;
  float* p1;     // (B, m)
  float* px;     // (B, m, 3)
  float* stats;  // (B, 2): Np, tr(X^T dPt1 X)
  float* short_sq;  // (B, m)
};

struct Smem {
  float y[MMAX * 3], coord[MMAX], nm[MMAX], pv[MMAX], short_sq[MMAX];
  float p[MMAX * CHUNK];  // memberships of the current chunk
  float xs[CHUNK * 3];    // the chunk's points
  float acc[MMAX * 4];    // per node: P1, PX0, PX1, PX2
  float wmin[NWARPS * MMAX];
  float red[THREADS], red2[THREADS];
};

__device__ __forceinline__ float sq_dist(const float* y, int j, float x0, float x1, float x2) {
  float d0 = y[j * 3 + 0] - x0, d1 = y[j * 3 + 1] - x1, d2 = y[j * 3 + 2] - x2;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

__global__ void __launch_bounds__(THREADS, 1) estep_kernel(EArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x;
  const int m = A.m, n = A.n;
  const int m_pad = (m + 7) / 8 * 8;
  const float* sc = A.scal + (size_t)s * 8;
  const float s2 = sc[0], c_plain = sc[1], c_vis = sc[2], gate = sc[3];
  const int v_count = (int)sc[4];
  const float k_vis = sc[5], tau_vis = sc[6];
  const float neg_half_inv_s2 = -0.5f / s2;
  const float c_eff = c_plain + gate * (c_vis - c_plain);
  bool gate_any = false;
  for (int t = 0; t < A.n_streams; ++t) gate_any = gate_any || A.scal[(size_t)t * 8 + 3] > 0.0f;
  const float* x = A.x + (size_t)s * n * 3;
  const float* xm = A.xm + (size_t)s * n;

  // Rows [m, m_pad) are zero, as the TPU's pad rows are.
  for (int k = tid; k < m_pad * 3; k += THREADS) S.y[k] = k < m * 3 ? A.y[(size_t)s * m * 3 + k] : 0.0f;
  for (int k = tid; k < m_pad; k += THREADS) {
    const bool in = k < m;
    S.coord[k] = in ? A.coord[(size_t)s * m + k] : 0.0f;
    S.nm[k] = in ? A.nm[(size_t)s * m + k] : 0.0f;
    S.pv[k] = in && !A.two_phase ? A.pv[(size_t)s * m + k] : 0.0f;
    S.short_sq[k] = BIG;
  }
  for (int k = tid; k < m * 4; k += THREADS) S.acc[k] = 0.0f;
  __syncthreads();

  // Phase 0: per-node nearest valid point.
  if (A.two_phase && gate_any) {
    float mn[MMAX];
#pragma unroll
    for (int j = 0; j < MMAX; ++j) mn[j] = BIG;
    for (int i = tid; i < n; i += THREADS) {
      if (!(xm[i] > 0.0f)) continue;
      const float x0 = x[i * 3], x1 = x[i * 3 + 1], x2 = x[i * 3 + 2];
#pragma unroll
      for (int j = 0; j < MMAX; ++j)
        if (j < m && S.nm[j] > 0.0f) mn[j] = fminf(mn[j], sq_dist(S.y, j, x0, x1, x2));
    }
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      if (j < m) {
        const float v = td_warp_min(mn[j]);
        if (lane == 0) S.wmin[warp * MMAX + j] = v;
      }
    }
    __syncthreads();
    if (tid < m) {
      float v = BIG;
      for (int w = 0; w < NWARPS; ++w) v = fminf(v, S.wmin[w * MMAX + tid]);
      S.short_sq[tid] = v;
    }
    __syncthreads();
  }
  if (A.two_phase && tid == 0) {
    // Visibility weights from the minima (inert where the gate is off).
    float total = 0.0f;
    for (int j = 0; j < m; ++j) {
      float sh = sqrtf(S.short_sq[j]);
      if (sh <= tau_vis) sh = 0.0f;
      const float w = S.nm[j] > 0.0f ? expf(-k_vis * sh) : 0.0f;
      S.pv[j] = w;
      total += w;
    }
    total = fmaxf(total, 1e-30f);
    for (int j = 0; j < m; ++j) S.pv[j] = S.pv[j] / total;
  }
  __syncthreads();

  float np_loc = 0.0f, trx_loc = 0.0f;
  for (int base = 0; base < n; base += CHUNK) {
    const int i = base + tid;
    const bool valid = i < n && xm[i] > 0.0f;
    float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
    if (valid) {
      x0 = x[i * 3];
      x1 = x[i * 3 + 1];
      x2 = x[i * 3 + 2];
    }
    S.xs[tid * 3] = x0;
    S.xs[tid * 3 + 1] = x1;
    S.xs[tid * 3 + 2] = x2;
    if (valid) {
      float p[MMAX];
      float sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < MMAX; ++j) {
        float e = 0.0f;
        if (j < m && S.nm[j] > 0.0f) e = expf(sq_dist(S.y, j, x0, x1, x2) * neg_half_inv_s2);
        p[j] = e;
        sum1 += e;
      }
      const float den1 = sum1 + c_plain;
      int mp = 0;
      float best = -1.0f;
#pragma unroll
      for (int j = 0; j < MMAX; ++j) {
        if (j < m) {
          const float q = S.nm[j] > 0.0f ? p[j] / den1 : -1.0f;
          if (q > best) {
            best = q;
            mp = j;
          }
        }
      }
      const int cand1 = (mp - 1 == -1) ? 2 : mp - 1;
      const int cand2 = (mp + 1 == v_count) ? v_count - 3 : mp + 1;
      auto sel_sq = [&](int r) {
        return (r >= 0 && r < m_pad) ? sq_dist(S.y, r, x0, x1, x2) : 0.0f;
      };
      auto sel_coord = [&](int r) { return (r >= 0 && r < m_pad) ? S.coord[r] : 0.0f; };
      const int nxt = sel_sq(cand1) < sel_sq(cand2) ? cand1 : cand2;
      const int lo = min(mp, nxt), hi = max(mp, nxt);
      const float d_lo = sqrtf(sel_sq(lo)), d_hi = sqrtf(sel_sq(hi));
      const float c_lo = sel_coord(lo), c_hi = sel_coord(hi);
      float sum2 = 0.0f;
#pragma unroll
      for (int j = 0; j < MMAX; ++j) {
        float e = 0.0f;
        if (j < m && S.nm[j] > 0.0f) {
          float geo;
          if (j < lo) {
            const float u = fabsf(S.coord[j] - c_lo) + d_lo;
            geo = u * u;
          } else if (j >= hi) {
            const float u = fabsf(S.coord[j] - c_hi) + d_hi;
            geo = u * u;
          } else if (j == lo) {
            geo = d_lo * d_lo;
          } else {
            geo = 0.0f;
          }
          e = expf(geo * neg_half_inv_s2);
          e = e * (1.0f + gate * (S.pv[j] - 1.0f));
        }
        p[j] = e;
        sum2 += e;
      }
      const float den2 = sum2 + c_eff;
      float pt1 = 0.0f;
#pragma unroll
      for (int j = 0; j < MMAX; ++j) {
        if (j < m) {
          const float q = S.nm[j] > 0.0f ? p[j] / den2 : 0.0f;
          S.p[j * CHUNK + tid] = q;
          pt1 += q;
        }
      }
      np_loc += pt1;
      trx_loc += pt1 * (x0 * x0 + x1 * x1 + x2 * x2);
    } else {
      for (int j = 0; j < m; ++j) S.p[j * CHUNK + tid] = 0.0f;
    }
    __syncthreads();
    for (int o = warp; o < m * 4; o += NWARPS) {
      const int j = o >> 2, q = o & 3;
      float acc = 0.0f;
      for (int k = lane; k < CHUNK; k += 32) {
        const float pk = S.p[j * CHUNK + k];
        acc += q == 0 ? pk : pk * S.xs[k * 3 + q - 1];
      }
      acc = td_warp_sum(acc);
      if (lane == 0) S.acc[o] += acc;
    }
    __syncthreads();
  }
  S.red[tid] = np_loc;
  S.red2[tid] = trx_loc;
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (tid < h) {
      S.red[tid] += S.red[tid + h];
      S.red2[tid] += S.red2[tid + h];
    }
  }
  __syncthreads();
  for (int k = tid; k < m; k += THREADS) {
    A.p1[(size_t)s * m + k] = S.acc[k * 4];
    A.short_sq[(size_t)s * m + k] = S.short_sq[k];
  }
  for (int k = tid; k < m * 3; k += THREADS) {
    const int j = k / 3, d = k % 3;
    A.px[(size_t)s * m * 3 + k] = S.acc[j * 4 + 1 + d];
  }
  if (tid == 0) {
    A.stats[(size_t)s * 2] = S.red[0];
    A.stats[(size_t)s * 2 + 1] = S.red2[0];
  }
}

}  // namespace

extern "C" int trackdlo_estep(const float* scal, const float* y, const float* coord,
                              const float* nm, const float* pv, const float* x, const float* xm,
                              int n_streams, int m, int n, int two_phase, float* p1, float* px,
                              float* stats, float* short_sq, void* stream) {
  if (m < 1 || m > MMAX || n < 0 || n_streams < 0) return (int)cudaErrorInvalidValue;
  if (n_streams == 0) return 0;
  EArgs a{scal, y, coord, nm, pv, x, xm, n_streams, m, n, two_phase, p1, px, stats, short_sq};
  const int smem = (int)sizeof(Smem);
  cudaError_t err =
      cudaFuncSetAttribute(estep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  estep_kernel<<<n_streams, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
