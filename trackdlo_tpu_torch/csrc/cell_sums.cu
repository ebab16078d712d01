// Kernel P: frame -> per-(parity channel, image cell) coordinate sums.
//
// Replaces: trackdlo_tpu/ops/preprocess_kernel.py cell_sums_pallas
// (_make_kernel, _hsv_mask_block), parity channel-grid variant.
//
// What bounds it on an H100: memory. A 720p frame is read once: 2.76 MB of
// interleaved RGB, 1.84 MB of u16 depth and 0.92 MB of the occlusion mask,
// ~5.5 MB in all (under 2 us at 3.35 TB/s); the per-pixel work is a few
// dozen float ops.
//
// Design: one warp per image cell (cell_px² pixels; 121 at 720p), reading
// the frame in place (no planar copies); the grid's second axis is the
// stream, so B frames of a batch take one launch. Each lane tests its pixels (the
// division-free HSV in-range predicate, occlusion, depth > 0), deprojects
// them and assigns the bit-pinned voxel parity channel bx·4+by·2+bz, then
// keeps 8 channels x (Σx, Σy, Σz, count) in registers. A fixed shuffle tree
// reduces them and lane 0 writes raw sums in the (4, B, 8, n_rows·n_cols)
// raster layout. No float atomics, so the sums are identical run to run.
// The floors use the host-computed float32 constants and multiply-only
// chains of the plain version; with -fmad=false nothing contracts.
#include "common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

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

__global__ void cell_sums_kernel(const uint8_t* __restrict__ rgb,
                                 const uint16_t* __restrict__ depth,
                                 const uint8_t* __restrict__ occ, int h, int w,
                                 int cell_px, const float* __restrict__ bands,
                                 int n_bands, float fx, float fy, float cx, float cy,
                                 float kx, float ky, float k_zq, float kz,
                                 int z_from_mm, float* __restrict__ out) {
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

  float acc[8][4];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[c][q] = 0.0f;

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
    const float zq = df * k_zq;
    const int bx = ((int)floorf(((u - cx) * zq) * kx)) & 1;
    const int by = ((int)floorf(((v - cy) * zq) * ky)) & 1;
    const int bz = ((int)floorf(z_from_mm ? df * kz : zq * kz)) & 1;
    const int ch = bx * 4 + by * 2 + bz;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (ch == c) {
        acc[c][0] += px;
        acc[c][1] += py;
        acc[c][2] += z;
        acc[c][3] += 1.0f;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float s = td_warp_sum(acc[c][q]);
      if (lane == 0) out[(((size_t)q * n_streams + stream) * 8 + c) * n_cells + cell] = s;
    }
}

}  // namespace

extern "C" int trackdlo_cell_sums(const uint8_t* rgb, const uint16_t* depth,
                                  const uint8_t* occ, int n_streams, int h, int w, int cell_px,
                                  const float* bands, int n_bands, float fx,
                                  float fy, float cx, float cy, float kx, float ky,
                                  float k_zq, float kz, int z_from_mm, float* out,
                                  void* stream) {
  if (n_streams <= 0 || n_streams > 65535 || h <= 0 || w <= 0 || cell_px <= 0 || n_bands <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_cells = ((h + cell_px - 1) / cell_px) * ((w + cell_px - 1) / cell_px);
  const int blocks = (n_cells + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  cell_sums_kernel<<<dim3(blocks, n_streams), 32 * WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      rgb, depth, occ, h, w, cell_px, bands, n_bands, fx, fy, cx, cy, kx, ky,
      k_zq, kz, z_from_mm, out);
  return (int)cudaGetLastError();
}
