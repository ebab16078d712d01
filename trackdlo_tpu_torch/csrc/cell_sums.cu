// Kernel P: frame -> per-(parity channel, image cell) coordinate sums, or
// per-cell sums in one channel (with or without the voxel floor votes).
//
// Replaces: trackdlo_tpu/ops/preprocess_kernel.py cell_sums_pallas
// (_make_kernel, _hsv_mask_block) in its three modes: the parity
// channel-grid variant (mode 0), the single channel with the floor votes of
// the coarse two-stage path (`with_votes`, mode 2) and the single channel
// with no leaf (`exact_voxels=False`, mode 1).
//
// What bounds it on an H100: by bytes, memory. A 720p frame is read once:
// 2.76 MB of interleaved RGB, 1.84 MB of u16 depth and 0.92 MB of the
// occlusion mask, ~5.5 MB in all (under 2 us at 3.35 TB/s); the per-pixel
// work is a few dozen float ops. In practice latency: the blocks that hold
// the rope run chains of dependent steps (HSV test, three IEEE divisions,
// floors) a kept pixel, while the others only test depths.
//
// Design: a block of 16 warps (two an SM) takes a strip of one cell row,
// up to 32 cells (cell_px rows of 32·cell_px pixels; 74 KB of shared memory
// at 720p). It stages the strip's interleaved RGB, depth and mask in shared
// memory, with 16-byte cp.async copies where every row is 16-byte aligned
// (a width that is a multiple of 16 pixels) and byte copies otherwise, so
// the frame is read coalesced with all of a block's loads in flight at
// once. Then two passes over shared memory:
// - the pixel pass: the threads take runs of eight pixels, skip a run with
//   no depth return after one 16-byte read and list the others, which the
//   warps then deal out a pixel a lane (the HSV in-range test, occlusion,
//   depth > 0, the deprojection and, in parity mode, the bit-pinned voxel
//   parity channel bx·4+by·2+bz; with votes the per-pixel voxel floors),
//   storing each kept pixel's values and channel; so a rope crossing a few
//   cells spreads its work over the block, not over the warps that own
//   them;
// - the cell pass: each warp takes the strip's cells in turn, and lane l
//   adds the cell's pixels l, l+32, … in raster order, keeping 8 channels
//   x (Σx, Σy, Σz, count) in parity mode, or (Σx, Σy, Σz, count) and with
//   votes the floor sums (Σfkx, Σfky, Σfkz) in one channel. A cell without
//   a depth return (a flag of the pixel pass) or whose lanes kept no pixel
//   (a warp vote) is skipped: its sums are +0.0, which is what the tree
//   gives. Otherwise a transposed butterfly reduces every sum at once (31
//   shuffles for the 32 parity sums, not 160): each level pairs lane l with
//   l ^ 16, ^ 8, …, the pairs of td_warp_sum's tree, so each sum has the
//   same bits as lane 0's there, and lane j ends holding sum j.
// The sums go through shared memory, and the block writes each output
// row's run of consecutive cells: (4, B, 8, n_cells) in parity mode,
// (Q, B, n_cells) with Q = 4 or 7 in one channel, raster order. A cell too
// large to stage its pixels' values (cell_px above ~100) computes them in
// the cell pass. The grid's third axis is the stream, so B frames take one
// launch. No float atomics, so the sums are identical run to run; the
// votes are integer-valued and far below 2^24, hence exact in any order
// and equal to the plain version's bit for bit. The floors use the
// host-computed float32 constants and multiply-only chains of the plain
// version; with -fmad=false nothing contracts.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_CELLS = 32;           // most cells a block takes along a cell row
constexpr int TILE_BUDGET = 128 * 1024;  // shared bytes a strip may take, above its floor of one cell
constexpr int MAX_DYN_SMEM = 232448 - 4096;  // the block's limit less the static arrays
constexpr int MAX_BANDS = 4;
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

// The sums of one lane: CH channels x Q quantities, flattened c·Q + q and
// padded to N = 2^LOGN values for the transposed reduction.
template <int MODE>
struct Acc {
  static constexpr int CH = MODE == MODE_PARITY ? 8 : 1;
  static constexpr int Q = MODE == MODE_VOTES ? 7 : 4;
  static constexpr int NQ = CH * Q;
  static constexpr int LOGN = MODE == MODE_PARITY ? 5 : (MODE == MODE_VOTES ? 3 : 2);
  static constexpr int N = 1 << LOGN;
  static constexpr int NV = MODE == MODE_VOTES ? 6 : 3;  // a kept pixel's values
};

// The 32 lanes' v[0..N) summed at once: at each level a lane keeps half of
// its live values, sends the other half to lane ^ off and adds what it
// receives; once one value is left, the plain butterfly. The pairs at each
// level are td_warp_sum's (l with l ^ 16, then ^ 8, …) and float addition
// is commutative, so every sum has the bits of td_warp_sum's lane 0. Lane l
// ends holding sum l >> (5 - LOGN).
template <int N, int LV = 0>
__device__ __forceinline__ float transpose_sum(float (&v)[N], int lane) {
  if constexpr (LV == 5) {
    return v[0];
  } else {
    constexpr int OFF = 16 >> LV, LIVE = N >> LV;
    if constexpr (LIVE > 1) {
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < LIVE / 2; ++i) {
        const float send = up ? v[i] : v[i + LIVE / 2];
        const float keep = up ? v[i + LIVE / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(TD_FULL_MASK, send, OFF);
      }
    } else {
      v[0] += __shfl_xor_sync(TD_FULL_MASK, v[0], OFF);
    }
    return transpose_sum<N, LV + 1>(v, lane);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// th rows of nb bytes, row r at src + r·src_pitch, into shared rows of
// dst_pitch bytes: 16-byte asynchronous copies when ``vec`` (every row and
// length 16-byte aligned), else bytes.
__device__ __forceinline__ void stage_rows(uint8_t* dst, int dst_pitch, const uint8_t* src,
                                           size_t src_pitch, int th, int nb, bool vec) {
  if (vec) {
    const int nv = nb >> 4;
    for (int i = threadIdx.x; i < th * nv; i += THREADS) {
      const int r = i / nv, o = (i - r * nv) << 4;
      cp_async16(dst + r * dst_pitch + o, src + r * src_pitch + o);
    }
  } else {
    for (int i = threadIdx.x; i < th * nb; i += THREADS) {
      const int r = i / nb, o = i - r * nb;
      dst[r * dst_pitch + o] = src[r * src_pitch + o];
    }
  }
}

struct PArgs {
  const uint8_t* rgb;
  const uint16_t* depth;
  const uint8_t* occ;
  int h, w, cell_px, n_rows, n_cols, tile_cells;
  const float* bands;
  int n_bands;
  float fx, fy, cx, cy, kx, ky, k_zq, kz;
  int z_from_mm;
  int vec;                            // 16-byte staging (see stage_rows)
  int staged;                         // the pixel pass stores each pixel's values
  int rgb_pitch, d_pitch, m_pitch;    // bytes per staged row: 3, 2 and 1 x m_pitch
  float* out;
};

// One pixel: -1 unless it is kept (depth > 0, not occluded, in an HSV
// band); else its channel (0 in one channel) and its values px, py, z and,
// with votes, its voxel floors, in the plain version's float32 chains.
template <int MODE>
__device__ __forceinline__ int pixel_values(const PArgs& a, const float* band, uint16_t dmm,
                                            uint8_t m, const uint8_t* px3, int row, int col,
                                            float (&val)[Acc<MODE>::NV]) {
  if (dmm == 0 || m == 0) return -1;
  const float r = (float)px3[0];
  const float g = (float)px3[1];
  const float b = (float)px3[2];
  bool keep = false;
  for (int q = 0; q < a.n_bands; ++q) keep = keep || hsv_in_range(r, g, b, band + 6 * q);
  if (!keep) return -1;
  const float df = (float)dmm;
  const float z = df / 1000.0f;
  const float u = (float)col, v = (float)row;
  val[0] = ((u - a.cx) * z) / a.fx;
  val[1] = ((v - a.cy) * z) / a.fy;
  val[2] = z;
  if constexpr (MODE == MODE_CELLS) {
    return 0;
  } else {
    // The bit-pinned voxel floors.
    const float zq = df * a.k_zq;
    const float fkx = floorf(((u - a.cx) * zq) * a.kx);
    const float fky = floorf(((v - a.cy) * zq) * a.ky);
    const float fkz = floorf(a.z_from_mm ? df * a.kz : zq * a.kz);
    if constexpr (MODE == MODE_VOTES) {
      val[3] = fkx;
      val[4] = fky;
      val[5] = fkz;
      return 0;
    } else {
      return (((int)fkx) & 1) * 4 + (((int)fky) & 1) * 2 + (((int)fkz) & 1);
    }
  }
}

// A kept pixel into a lane's sums: (Σx, Σy, Σz, count) of its channel and,
// with votes, the floor sums.
template <int MODE>
__device__ __forceinline__ void add_pixel(float (&acc)[Acc<MODE>::N], int tag,
                                          const float (&val)[Acc<MODE>::NV]) {
  if constexpr (MODE == MODE_PARITY) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (tag == c) {
        acc[c * 4 + 0] += val[0];
        acc[c * 4 + 1] += val[1];
        acc[c * 4 + 2] += val[2];
        acc[c * 4 + 3] += 1.0f;
      }
    }
  } else {
    acc[0] += val[0];
    acc[1] += val[1];
    acc[2] += val[2];
    acc[3] += 1.0f;
    if constexpr (MODE == MODE_VOTES) {
      acc[4] += val[3];
      acc[5] += val[4];
      acc[6] += val[5];
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) cell_sums_kernel(const PArgs a) {
  using A = Acc<MODE>;
  constexpr int NV = A::NV;
  extern __shared__ __align__(16) uint8_t tile[];
  __shared__ float s_out[A::N][TILE_CELLS];
  __shared__ float s_band[6 * MAX_BANDS];
  __shared__ int s_any[TILE_CELLS];
  __shared__ int s_n_runs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cr = blockIdx.y, stream = blockIdx.z, n_streams = gridDim.z;
  const int cp = a.cell_px, n_cells = a.n_rows * a.n_cols;
  const int cc0 = blockIdx.x * a.tile_cells;
  const int n_tc = min(a.tile_cells, a.n_cols - cc0);
  const int row0 = cr * cp, col0 = cc0 * cp;
  const int th = min(cp, a.h - row0), tw = min(n_tc * cp, a.w - col0);
  const int strip_px = cp * a.m_pitch;
  uint8_t* s_rgb = tile;
  uint16_t* s_d = reinterpret_cast<uint16_t*>(tile + cp * a.rgb_pitch);
  uint8_t* s_m = tile + cp * (a.rgb_pitch + a.d_pitch);
  float* s_val = reinterpret_cast<float*>(tile + cp * (a.rgb_pitch + a.d_pitch + a.m_pitch));
  int8_t* s_tag = reinterpret_cast<int8_t*>(s_val + NV * strip_px);
  int* s_runs = reinterpret_cast<int*>(s_tag + strip_px);
  const int d_pitch = a.d_pitch >> 1;

  if (tid < 6 * a.n_bands) s_band[tid] = a.bands[tid];
  if (tid < TILE_CELLS) s_any[tid] = 0;
  if (tid == 0) s_n_runs = 0;
  const size_t px0 = (size_t)stream * a.h * a.w + (size_t)row0 * a.w + col0;
  stage_rows(s_rgb, a.rgb_pitch, a.rgb + px0 * 3, (size_t)a.w * 3, th, tw * 3, a.vec);
  stage_rows(reinterpret_cast<uint8_t*>(s_d), a.d_pitch,
             reinterpret_cast<const uint8_t*>(a.depth + px0), (size_t)a.w * 2, th, tw * 2, a.vec);
  stage_rows(s_m, a.m_pitch, a.occ + px0, (size_t)a.w, th, tw, a.vec);
  if (a.vec) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (a.staged) {
    // The pixel pass. Each thread takes runs of eight pixels, reads a
    // run's depths with one 16-byte load, gives its pixels the tag -1 and
    // lists the run if it has a return (the list's order is free: every
    // pixel's values are its own). Then the warps deal the listed runs out
    // four at a time, a pixel a lane, so that the few runs a rope crosses
    // keep every warp of the block busy.
    const int groups = a.m_pitch >> 3, n_groups = th * groups;
    for (int g0 = 0; g0 < n_groups; g0 += THREADS) {  // the same trips in every thread
      const int gi = g0 + tid;
      bool busy = false;
      if (gi < n_groups) {
        const int pr = gi / groups, tc0 = (gi - pr * groups) << 3;
        const uint4 d8 = *reinterpret_cast<const uint4*>(s_d + pr * d_pitch + tc0);
        busy = (d8.x | d8.y | d8.z | d8.w) != 0u && tc0 < tw;
        *reinterpret_cast<uint2*>(s_tag + pr * a.m_pitch + tc0) = make_uint2(~0u, ~0u);
        if (busy) {  // the cells the run touches may hold a kept pixel
          const int k1 = min(tc0 + 7, tw - 1) / cp;
          for (int k = tc0 / cp; k <= k1; ++k) s_any[k] = 1;
        }
      }
      const unsigned bal = __ballot_sync(TD_FULL_MASK, busy);
      int base = 0;
      if (lane == 0 && bal != 0u) base = atomicAdd(&s_n_runs, __popc(bal));
      base = __shfl_sync(TD_FULL_MASK, base, 0);
      if (busy) s_runs[base + __popc(bal & ((1u << lane) - 1u))] = gi;
    }
    __syncthreads();
    const int n_runs = s_n_runs, j = lane & 7;
    for (int item = warp * 4 + (lane >> 3); item < n_runs; item += THREADS / 8) {
      const int gi = s_runs[item];
      const int pr = gi / groups, tc = ((gi - pr * groups) << 3) + j;
      if (tc >= tw) continue;
      const uint16_t dmm = s_d[pr * d_pitch + tc];
      if (dmm == 0) continue;
      float val[NV];
      const int tag = pixel_values<MODE>(a, s_band, dmm, s_m[pr * a.m_pitch + tc],
                                         s_rgb + pr * a.rgb_pitch + tc * 3, row0 + pr, col0 + tc, val);
      if (tag >= 0) {
        const int si = pr * a.m_pitch + tc;
#pragma unroll
        for (int q = 0; q < NV; ++q) s_val[q * strip_px + si] = val[q];
        s_tag[si] = (int8_t)tag;
      }
    }
    __syncthreads();
  }

  // The cells: lane l adds the cell's pixels l, l+32, … in raster order.
  const int npx = cp * cp, d32 = 32 / cp, m32 = 32 % cp;
  for (int k = warp; k < n_tc; k += WARPS) {
    float acc[A::N];
#pragma unroll
    for (int i = 0; i < A::N; ++i) acc[i] = 0.0f;
    bool any = false;
    if (!a.staged || s_any[k] != 0) {
      bool mine = false;
      int pr = lane / cp, pc = lane % cp;
      for (int p = lane; p < npx; p += 32) {
        const int tc = k * cp + pc;
        if (pr < th && tc < tw) {
          float val[NV];
          int tag;
          if (a.staged) {
            const int si = pr * a.m_pitch + tc;
            tag = s_tag[si];
            if (tag >= 0) {
#pragma unroll
              for (int q = 0; q < NV; ++q) val[q] = s_val[q * strip_px + si];
            }
          } else {
            tag = pixel_values<MODE>(a, s_band, s_d[pr * d_pitch + tc], s_m[pr * a.m_pitch + tc],
                                     s_rgb + pr * a.rgb_pitch + tc * 3, row0 + pr, col0 + tc, val);
          }
          if (tag >= 0) {
            add_pixel<MODE>(acc, tag, val);
            mine = true;
          }
        }
        pc += m32;
        pr += d32;
        if (pc >= cp) {
          pc -= cp;
          ++pr;
        }
      }
      any = __any_sync(TD_FULL_MASK, mine);
    }
    const float s = any ? transpose_sum<A::N>(acc, lane) : 0.0f;
    constexpr int SHIFT = 5 - A::LOGN;
    if ((lane & ((1 << SHIFT) - 1)) == 0 && (lane >> SHIFT) < A::NQ) s_out[lane >> SHIFT][k] = s;
  }
  __syncthreads();
  // Each output row (q, c) gets the strip's run of consecutive cells.
  const int cell0 = cr * a.n_cols + cc0;
  for (int i = tid; i < A::NQ * TILE_CELLS; i += THREADS) {
    const int j = i / TILE_CELLS, k = i % TILE_CELLS;
    if (k < n_tc) {
      const int c = j / A::Q, q = j % A::Q;
      a.out[(((size_t)q * n_streams + stream) * A::CH + c) * n_cells + cell0 + k] = s_out[j][k];
    }
  }
}

template <int MODE>
int launch(const PArgs& a, int n_streams, int smem, cudaStream_t s) {
  if (smem > 32 * 1024) {  // past the default limit beside the static arrays
    const cudaError_t err = cudaFuncSetAttribute(
        cell_sums_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.n_cols + a.tile_cells - 1) / a.tile_cells, a.n_rows, n_streams);
  cell_sums_kernel<MODE><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int round16(int n) { return (n + 15) & ~15; }

}  // namespace

// mode: 0 parity (out (4, B, 8, n_cells)), 1 one channel without votes
// (out (4, B, n_cells)), 2 one channel with the floor votes (out (7, B, n_cells)).
extern "C" int trackdlo_cell_sums(const uint8_t* rgb, const uint16_t* depth,
                                  const uint8_t* occ, int n_streams, int h, int w, int cell_px,
                                  const float* bands, int n_bands, float fx,
                                  float fy, float cx, float cy, float kx, float ky,
                                  float k_zq, float kz, int z_from_mm, int mode, float* out,
                                  void* stream) {
  if (n_streams <= 0 || n_streams > 65535 || h <= 0 || w <= 0 || cell_px <= 0 || n_bands <= 0 ||
      n_bands > MAX_BANDS)
    return (int)cudaErrorInvalidValue;
  PArgs a{};
  a.rgb = rgb;
  a.depth = depth;
  a.occ = occ;
  a.h = h;
  a.w = w;
  a.cell_px = cell_px;
  a.n_rows = (h + cell_px - 1) / cell_px;
  a.n_cols = (w + cell_px - 1) / cell_px;
  if (a.n_rows > 65535) return (int)cudaErrorInvalidValue;
  const int nv = mode == MODE_VOTES ? 6 : 3;
  // The strip's shared bytes for t cells: the frame's rows and, staged, each
  // pixel's values and tag. The most cells (halving from 32) that fit the
  // budget; a cell too large to stage its values computes them in place.
  auto bytes = [&](int t, int staged) {
    const int pitch = round16(t * cell_px);  // and a run of 8 pixels listed in 4 bytes
    return cell_px * pitch * (6 + (staged ? 4 * nv + 1 : 0)) + (staged ? cell_px * pitch / 2 : 0);
  };
  a.staged = 1;
  a.tile_cells = TILE_CELLS;
  while (a.tile_cells > 1 && bytes(a.tile_cells, 1) > TILE_BUDGET) a.tile_cells >>= 1;
  if (bytes(a.tile_cells, 1) > MAX_DYN_SMEM) {
    a.staged = 0;
    while (a.tile_cells > 1 && bytes(a.tile_cells, 0) > TILE_BUDGET) a.tile_cells >>= 1;
  }
  const int smem = bytes(a.tile_cells, a.staged);
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  const int tile_px = a.tile_cells * cell_px;
  a.m_pitch = round16(tile_px);
  a.rgb_pitch = 3 * a.m_pitch;
  a.d_pitch = 2 * a.m_pitch;
  const uintptr_t addr = (uintptr_t)rgb | (uintptr_t)depth | (uintptr_t)occ;
  a.vec = (addr & 15) == 0 && w % 16 == 0 && tile_px % 16 == 0;
  a.bands = bands;
  a.n_bands = n_bands;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  a.kx = kx;
  a.ky = ky;
  a.k_zq = k_zq;
  a.kz = kz;
  a.z_from_mm = z_from_mm;
  a.out = out;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == MODE_PARITY) return launch<MODE_PARITY>(a, n_streams, smem, s);
  if (mode == MODE_CELLS) return launch<MODE_CELLS>(a, n_streams, smem, s);
  if (mode == MODE_VOTES) return launch<MODE_VOTES>(a, n_streams, smem, s);
  return (int)cudaErrorInvalidValue;
}
