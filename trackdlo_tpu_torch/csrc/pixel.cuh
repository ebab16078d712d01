// The per-pixel chains that kernels P (cell_sums.cu) and X (split_cells.cu)
// share, in the plain version's float32 order (ops/preprocess.py: the
// division-free HSV test, the deprojection and the bit-pinned voxel
// floors). With -fmad=false nothing contracts, so both kernels give every
// pixel the plain version's bits.
#pragma once

#include <climits>

#include "common.cuh"

// Division-free HSV in-range test of one band (lo_h, lo_s, lo_v, hi_h,
// hi_s, hi_v): products of u8-valued floats stay below 2^24, so every
// comparison is the exact rational predicate.
__device__ __forceinline__ bool td_hsv_in_range(float r, float g, float b, const float* band) {
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

// Whether u8 RGB px3 falls in any of n_bands bands.
__device__ __forceinline__ bool td_in_bands(const uint8_t* px3, const float* bands, int n_bands) {
  const float r = (float)px3[0];
  const float g = (float)px3[1];
  const float b = (float)px3[2];
  bool keep = false;
  for (int q = 0; q < n_bands; ++q) keep = keep || td_hsv_in_range(r, g, b, bands + 6 * q);
  return keep;
}

// The camera and the floor chain's host-computed float32 constants.
struct TdPixelConsts {
  float fx, fy, cx, cy, kx, ky, k_zq, kz;
  int z_from_mm;
};

// A pixel (u, v) at df millimetres: its point (x, y, z) in metres.
__device__ __forceinline__ void td_deproject(const TdPixelConsts& k, float df, float u, float v,
                                             float (&val)[3]) {
  const float z = df / 1000.0f;
  val[0] = ((u - k.cx) * z) / k.fx;
  val[1] = ((v - k.cy) * z) / k.fy;
  val[2] = z;
}

// Its voxel floors: z in the integer-mm domain, x and y through
// multiply-only chains (integer-valued floats).
__device__ __forceinline__ void td_voxel_floors(const TdPixelConsts& k, float df, float u, float v,
                                                float (&fk)[3]) {
  const float zq = df * k.k_zq;
  fk[0] = floorf(((u - k.cx) * zq) * k.kx);
  fk[1] = floorf(((v - k.cy) * zq) * k.ky);
  fk[2] = floorf(k.z_from_mm ? df * k.kz : zq * k.kz);
}

// The parity channel bx·4 + by·2 + bz of the floors.
__device__ __forceinline__ int td_parity_channel(const float (&fk)[3]) {
  return (((int)fk[0]) & 1) * 4 + (((int)fk[1]) & 1) * 2 + (((int)fk[2]) & 1);
}
