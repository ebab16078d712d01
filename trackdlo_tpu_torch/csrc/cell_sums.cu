// Kernel P: frame -> per-(parity channel, image cell) coordinate sums, or
// per-cell sums in one channel (with or without the voxel floor votes).
//
// Replaces: trackdlo_tpu/ops/preprocess_kernel.py cell_sums_pallas
// (_make_kernel, _hsv_mask_block) in its three modes: the parity
// channel-grid variant (mode 0), the single channel with the floor votes of
// the coarse two-stage path (`with_votes`, mode 2) and the single channel
// with no leaf (`exact_voxels=False`, mode 1).
//
// What bounds it on an H100: memory. A 720p frame is read once: 2.76 MB of
// interleaved RGB, 1.84 MB of u16 depth and 0.92 MB of the occlusion mask,
// ~5.5 MB in all (under 2 us at 3.35 TB/s); the per-pixel work is a few
// dozen float ops.
//
// Design: one warp per image cell (cell_px² pixels; 121 at 720p), reading
// the frame in place (no planar copies); the grid's second axis is the
// stream, so B frames of a batch take one launch. Each lane tests its pixels (the
// division-free HSV in-range predicate, occlusion, depth > 0) and deprojects
// them. In parity mode it assigns the bit-pinned voxel parity channel
// bx·4+by·2+bz and keeps 8 channels x (Σx, Σy, Σz, count) in registers; in
// the single-channel modes it keeps (Σx, Σy, Σz, count) and, with votes, the
// sums of the per-pixel voxel floors (Σfkx, Σfky, Σfkz). A fixed shuffle
// tree reduces them and lane 0 writes raw sums: (4, B, 8, n_cells) in parity
// mode, (Q, B, n_cells) with Q = 4 or 7 in one channel, raster order. No
// float atomics, so the sums are identical run to run; the votes are
// integer-valued and far below 2^24, hence exact in any order and equal to
// the plain version's bit for bit. The floors use the host-computed float32
// constants and multiply-only chains of the plain version; with -fmad=false
// nothing contracts.
#include "common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int MODE_PARITY = 0, MODE_CELLS = 1, MODE_VOTES = 2;

__device__ __forceinline__ bool hsv_in_range(float r, float g, float b, const float* band) {
  const float lo_h = band[0], lo_s = band[1], lo_v = band[2];
  const float hi_h = band[3], hi_s = band[4], hi_v = band[5];
  const float v = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float d = v - mn;
  const bool s_test = (255.0f * d >= lo_s * v) && (255.0f * d <= hi_s * v);
  const bool s_ok = lo_s <= 0.0f ? (s_test || v <= 0.0f) : (s_test && v > 0.0f);
  float hn;
  if (v == r) hn = 60.0f * (g - b);
  else if (v == g) hn = 120.0f * d + 60.0f * (b - r);
  else hn = 240.0f * d + 60.0f * (r - g);
  if (hn < 0.0f) hn = hn + 360.0f * d;
  const bool h_test = (hn >= 2.0f * lo_h * d) && (hn <= 2.0f * hi_h * d);
  const bool h_ok = lo_h <= 0.0f ? (h_test || d <= 0.0f) : (h_test && d > 0.0f);
  return h_ok && s_ok && v >= lo_v && v <= hi_v;
}

// The accumulators of one lane: 8 channels x 4 sums in parity mode, 1 x 7
// (4 used without votes) in one channel.
template <int MODE>
struct Acc {
  static constexpr int CH = MODE == MODE_PARITY ? 8 : 1;
  static constexpr int Q = MODE == MODE_VOTES ? 7 : 4;
};

template <int MODE>
__global__ void cell_sums_kernel(const uint8_t* __restrict__ rgb,
                                 const uint16_t* __restrict__ depth,
                                 const uint8_t* __restrict__ occ, int h, int w,
                                 int cell_px, const float* __restrict__ bands,
                                 int n_bands, float fx, float fy, float cx, float cy,
                                 float kx, float ky, float k_zq, float kz,
                                 int z_from_mm, float* __restrict__ out) {
  constexpr int CH = Acc<MODE>::CH, Q = Acc<MODE>::Q;
  const int n_cols = (w + cell_px - 1) / cell_px;
  const int n_rows = (h + cell_px - 1) / cell_px;
  const int n_cells = n_rows * n_cols;
  const int cell = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (cell >= n_cells) return;  // warp-uniform
  const int stream = blockIdx.y, n_streams = gridDim.y;
  const size_t frame = (size_t)stream * h * w;
  rgb += frame * 3;
  depth += frame;
  occ += frame;
  const int cr = cell / n_cols, cc = cell % n_cols;

  float acc[CH][Q];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[c][q] = 0.0f;

  const int npx = cell_px * cell_px;
  for (int p = lane; p < npx; p += 32) {
    const int row = cr * cell_px + p / cell_px;
    const int col = cc * cell_px + p % cell_px;
    if (row >= h || col >= w) continue;
    const size_t pix = (size_t)row * w + col;
    const uint16_t dmm = depth[pix];
    if (dmm == 0 || occ[pix] == 0) continue;
    const float r = (float)rgb[pix * 3 + 0];
    const float g = (float)rgb[pix * 3 + 1];
    const float b = (float)rgb[pix * 3 + 2];
    bool keep = false;
    for (int k = 0; k < n_bands; ++k) keep = keep || hsv_in_range(r, g, b, bands + 6 * k);
    if (!keep) continue;
    const float df = (float)dmm;
    const float z = df / 1000.0f;
    const float u = (float)col, v = (float)row;
    const float px = ((u - cx) * z) / fx;
    const float py = ((v - cy) * z) / fy;
    // The bit-pinned voxel floors (parity and vote modes).
    const float zq = df * k_zq;
    const float fkx = floorf(((u - cx) * zq) * kx);
    const float fky = floorf(((v - cy) * zq) * ky);
    const float fkz = floorf(z_from_mm ? df * kz : zq * kz);
    if constexpr (MODE == MODE_PARITY) {
      const int ch = (((int)fkx) & 1) * 4 + (((int)fky) & 1) * 2 + (((int)fkz) & 1);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (ch == c) {
          acc[c][0] += px;
          acc[c][1] += py;
          acc[c][2] += z;
          acc[c][3] += 1.0f;
        }
      }
    } else {
      acc[0][0] += px;
      acc[0][1] += py;
      acc[0][2] += z;
      acc[0][3] += 1.0f;
      if constexpr (MODE == MODE_VOTES) {
        acc[0][4] += fkx;
        acc[0][5] += fky;
        acc[0][6] += fkz;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float s = td_warp_sum(acc[c][q]);
      if (lane == 0) out[(((size_t)q * n_streams + stream) * CH + c) * n_cells + cell] = s;
    }
}

}  // namespace

// mode: 0 parity (out (4, B, 8, n_cells)), 1 one channel without votes
// (out (4, B, n_cells)), 2 one channel with the floor votes (out (7, B, n_cells)).
extern "C" int trackdlo_cell_sums(const uint8_t* rgb, const uint16_t* depth,
                                  const uint8_t* occ, int n_streams, int h, int w, int cell_px,
                                  const float* bands, int n_bands, float fx,
                                  float fy, float cx, float cy, float kx, float ky,
                                  float k_zq, float kz, int z_from_mm, int mode, float* out,
                                  void* stream) {
  if (n_streams <= 0 || n_streams > 65535 || h <= 0 || w <= 0 || cell_px <= 0 || n_bands <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_cells = ((h + cell_px - 1) / cell_px) * ((w + cell_px - 1) / cell_px);
  const dim3 grid((n_cells + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK, n_streams);
  const int threads = 32 * WARPS_PER_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == MODE_PARITY)
    cell_sums_kernel<MODE_PARITY><<<grid, threads, 0, s>>>(
        rgb, depth, occ, h, w, cell_px, bands, n_bands, fx, fy, cx, cy, kx, ky, k_zq, kz,
        z_from_mm, out);
  else if (mode == MODE_CELLS)
    cell_sums_kernel<MODE_CELLS><<<grid, threads, 0, s>>>(
        rgb, depth, occ, h, w, cell_px, bands, n_bands, fx, fy, cx, cy, kx, ky, k_zq, kz,
        z_from_mm, out);
  else if (mode == MODE_VOTES)
    cell_sums_kernel<MODE_VOTES><<<grid, threads, 0, s>>>(
        rgb, depth, occ, h, w, cell_px, bands, n_bands, fx, fy, cx, cy, kx, ky, k_zq, kz,
        z_from_mm, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
