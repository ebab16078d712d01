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
// version (pixel.cuh, shared with kernel X); with -fmad=false nothing
// contracts.
//
// The exact route (parity mode, `exact`, its own build; the step's): a
// masked pixel with no depth return is a point at the origin in the
// reference, so the block counts such pixels (kernel X gives them one
// candidate at the origin). The listing thread tests the pixels of a run
// without any depth return itself (the last colour's answer kept, since a
// background repeats one colour), and the pixel pass those of the listed
// runs; the runs listed and the cells taken are the other mode's. After a
// cell's sums, one walk takes each axis' least and greatest voxel floor
// over the cell's kept pixels (integer warp reductions): two floors of one
// parity are equal or two apart, so where no axis spans more than one
// voxel no channel is split, and the cell is done. Otherwise a walk a
// channel its lanes hold compares the channel's floors the same way. A
// channel-cell whose pixels span two voxels (k and k+2 of one parity:
// depth noise, or a cell wider than the leaf) writes zero sums, and its
// bit in the cell's byte of `split_mask`. Each
// block writes how many it found and its pixels without depth to
// `split_count` (always, so a frame without any needs no clearing), and
// the cells' bytes where it found some. Kernel X regroups those pixels by
// voxel. A non-null `tally` (the span recorder's graphs) gains the masked
// pixels with no depth (tally[0]) and the cells with a split channel
// (tally[1]).
#include "pixel.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_CELLS = 32;           // most cells a block takes along a cell row
constexpr int TILE_BUDGET = 128 * 1024;  // shared bytes a strip may take, above its floor of one cell
constexpr int MAX_DYN_SMEM = 232448 - 4096;  // the block's limit less the static arrays
constexpr int MAX_BANDS = 4;
constexpr int MODE_PARITY = 0, MODE_CELLS = 1, MODE_VOTES = 2;

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
  TdPixelConsts k;
  int vec;                            // 16-byte staging (see stage_rows)
  int staged;                         // the pixel pass stores each pixel's values
  int rgb_pitch, d_pitch, m_pitch;    // bytes per staged row: 3, 2 and 1 x m_pitch
  float* out;
  uint8_t* split_mask;                // (B, n_cells): split channels a cell
  int* split_count;                   // (B, blocks a stream, 2): split channel-cells, pixels without depth
  unsigned long long* tally;          // null, or the recorder's two counters
};

// One pixel: -1 unless it is kept (depth > 0, not occluded, in an HSV
// band); else its channel (0 in one channel) and its values px, py, z and,
// with votes, its voxel floors, in the plain version's float32 chains.
template <int MODE>
__device__ __forceinline__ int pixel_values(const PArgs& a, const float* band, uint16_t dmm,
                                            uint8_t m, const uint8_t* px3, int row, int col,
                                            float (&val)[Acc<MODE>::NV]) {
  if (dmm == 0 || m == 0) return -1;
  if (!td_in_bands(px3, band, a.n_bands)) return -1;
  const float df = (float)dmm;
  const float u = (float)col, v = (float)row;
  float xyz[3];
  td_deproject(a.k, df, u, v, xyz);
  val[0] = xyz[0];
  val[1] = xyz[1];
  val[2] = xyz[2];
  if constexpr (MODE == MODE_CELLS) {
    return 0;
  } else {
    float fk[3];  // the bit-pinned voxel floors
    td_voxel_floors(a.k, df, u, v, fk);
    if constexpr (MODE == MODE_VOTES) {
      val[3] = fk[0];
      val[4] = fk[1];
      val[5] = fk[2];
      return 0;
    } else {
      return td_parity_channel(fk);
    }
  }
}

// The band test of the pixels a thread takes in turn: a background repeats
// one colour, so the last colour's answer is kept.
struct BandMemo {
  unsigned key = ~0u;
  bool in = false;
};

__device__ __forceinline__ bool memo_in_bands(BandMemo& m, const uint8_t* px3, const float* bands,
                                              int n_bands) {
  const unsigned key = px3[0] | ((unsigned)px3[1] << 8) | ((unsigned)px3[2] << 16);
  if (key != m.key) {
    m.key = key;
    m.in = td_in_bands(px3, bands, n_bands);
  }
  return m.in;
}

// Whether each axis' floors over the lanes' values lo and hi span at most
// one voxel.
__device__ __forceinline__ bool one_voxel_apart(const int (&lo)[3], const int (&hi)[3]) {
  bool narrow = true;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    narrow &= __reduce_max_sync(TD_FULL_MASK, hi[i]) - __reduce_min_sync(TD_FULL_MASK, lo[i]) <= 1;
  return narrow;
}

// Exact route: the channels whose pixels among the cell's (lane l's are l,
// l+32, … in raster order, as in the cell pass) carry more than one voxel
// floor on some axis. Warp-uniform, on a cell with a kept pixel. A first
// walk finds the channels the lanes hold and each axis' least and greatest
// floor over all of them; then, unless those lie within one voxel, a walk a
// channel does the same over the channel's pixels.
__device__ __forceinline__ unsigned split_channels(const PArgs& a, const float* band,
                                                   const uint16_t* s_d, const uint8_t* s_m,
                                                   const uint8_t* s_rgb, const int8_t* s_tag,
                                                   int d_pitch, int k, int row0, int col0, int th,
                                                   int tw, int lane) {
  const int cp = a.cell_px, npx = cp * cp, d32 = 32 / cp, m32 = 32 % cp;
  // The tag of each of the lane's pixels in turn: visit(tag, dmm, row, col).
  auto walk = [&](auto visit) {
    int pr = lane / cp, pc = lane % cp;
    for (int p = lane; p < npx; p += 32) {
      const int tc = k * cp + pc;
      if (pr < th && tc < tw) {
        const uint16_t dmm = s_d[pr * d_pitch + tc];
        int tag;
        if (a.staged) {
          tag = s_tag[pr * a.m_pitch + tc];
        } else {
          float val[3];
          tag = pixel_values<MODE_PARITY>(a, band, dmm, s_m[pr * a.m_pitch + tc],
                                          s_rgb + pr * a.rgb_pitch + tc * 3, row0 + pr, col0 + tc,
                                          val);
        }
        visit(tag, dmm, row0 + pr, col0 + tc);
      }
      pc += m32;
      pr += d32;
      if (pc >= cp) {
        pc -= cp;
        ++pr;
      }
    }
  };
  // Each axis' least and greatest floor over the pixels of channel `only`
  // (-1: of every channel); the channels seen.
  auto span = [&](int only, int (&lo)[3], int (&hi)[3]) {
    unsigned held = 0u;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      lo[i] = INT_MAX;
      hi[i] = INT_MIN;
    }
    walk([&](int tag, uint16_t dmm, int row, int col) {
      if (tag < 0 || (only >= 0 && tag != only)) return;
      held |= 1u << tag;
      float fk[3];
      td_voxel_floors(a.k, (float)dmm, (float)col, (float)row, fk);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        lo[i] = min(lo[i], (int)fk[i]);
        hi[i] = max(hi[i], (int)fk[i]);
      }
    });
    return held;
  };
  int lo[3], hi[3];
  const unsigned held = __reduce_or_sync(TD_FULL_MASK, span(-1, lo, hi));
  if (one_voxel_apart(lo, hi)) return 0u;
  unsigned split = 0;
  for (unsigned rest = held; rest != 0u; rest &= rest - 1u) {
    const int c = __ffs(rest) - 1;
    span(c, lo, hi);
    if (!one_voxel_apart(lo, hi)) split |= 1u << c;  // one parity: floors k and k+2
  }
  return split;
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

template <int MODE, bool EXACT>
__global__ void __launch_bounds__(THREADS, 2) cell_sums_kernel(const PArgs a) {
  static_assert(!EXACT || MODE == MODE_PARITY, "the exact route is parity mode's");
  using A = Acc<MODE>;
  constexpr int NV = A::NV;
  extern __shared__ __align__(16) uint8_t tile[];
  __shared__ float s_out[A::N][TILE_CELLS];
  __shared__ float s_band[6 * MAX_BANDS];
  __shared__ int s_any[TILE_CELLS];
  __shared__ unsigned s_split[TILE_CELLS];
  __shared__ int s_n_runs, s_no_depth;
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
  if (tid < TILE_CELLS) {
    s_any[tid] = 0;
    s_split[tid] = 0u;
  }
  if (tid == 0) {
    s_n_runs = 0;
    s_no_depth = 0;
  }
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
    BandMemo memo;
    int no_depth = 0;  // the exact route: this thread's masked pixels without depth
    for (int g0 = 0; g0 < n_groups; g0 += THREADS) {  // the same trips in every thread
      const int gi = g0 + tid;
      bool busy = false;
      if (gi < n_groups) {
        const int pr = gi / groups, tc0 = (gi - pr * groups) << 3;
        const uint4 d8 = *reinterpret_cast<const uint4*>(s_d + pr * d_pitch + tc0);
        const bool ret = (d8.x | d8.y | d8.z | d8.w) != 0u;
        busy = ret && tc0 < tw;
        *reinterpret_cast<uint2*>(s_tag + pr * a.m_pitch + tc0) = make_uint2(~0u, ~0u);
        if (busy) {  // the cells the run touches may hold a kept pixel
          const int k1 = min(tc0 + 7, tw - 1) / cp;
          for (int k = tc0 / cp; k <= k1; ++k) s_any[k] = 1;
        }
        if constexpr (EXACT) {
          const uint2 m8 = *reinterpret_cast<const uint2*>(s_m + pr * a.m_pitch + tc0);
          if (!ret && tc0 < tw && (m8.x | m8.y) != 0u) {  // unlisted: its masked pixels here
            for (int tc = tc0; tc < min(tc0 + 8, tw); ++tc)
              no_depth += s_m[pr * a.m_pitch + tc] != 0 &&
                          memo_in_bands(memo, s_rgb + pr * a.rgb_pitch + tc * 3, s_band, a.n_bands);
          }
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
      if (dmm == 0) {
        if constexpr (EXACT)
          no_depth += s_m[pr * a.m_pitch + tc] != 0 &&
                      td_in_bands(s_rgb + pr * a.rgb_pitch + tc * 3, s_band, a.n_bands);
        continue;
      }
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
    if constexpr (EXACT) {
      no_depth = __reduce_add_sync(TD_FULL_MASK, no_depth);
      if (lane == 0 && no_depth != 0) atomicAdd(&s_no_depth, no_depth);
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
            const uint16_t dmm = s_d[pr * d_pitch + tc];
            const uint8_t m = s_m[pr * a.m_pitch + tc];
            const uint8_t* px3 = s_rgb + pr * a.rgb_pitch + tc * 3;
            tag = pixel_values<MODE>(a, s_band, dmm, m, px3, row0 + pr, col0 + tc, val);
            if constexpr (EXACT) {  // a cell too large to stage: counted here
              if (dmm == 0 && m != 0 && td_in_bands(px3, s_band, a.n_bands))
                atomicAdd(&s_no_depth, 1);
            }
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
    float s = any ? transpose_sum<A::N>(acc, lane) : 0.0f;
    constexpr int SHIFT = 5 - A::LOGN;
    if constexpr (EXACT) {
      if (any) {
        const unsigned split =
            split_channels(a, s_band, s_d, s_m, s_rgb, s_tag, d_pitch, k, row0, col0, th, tw, lane);
        if ((split >> ((lane >> SHIFT) / A::Q)) & 1u) s = 0.0f;  // sum j = channel j / Q's
        if (lane == 0) s_split[k] = split;
      }
    }
    if ((lane & ((1 << SHIFT) - 1)) == 0 && (lane >> SHIFT) < A::NQ) s_out[lane >> SHIFT][k] = s;
  }
  __syncthreads();
  if constexpr (EXACT) {
    if (warp == 0) {
      // The block's split channel-cells, and the cells' bytes where it has any.
      const unsigned bits = lane < n_tc ? s_split[lane] : 0u;
      const int found = __reduce_add_sync(TD_FULL_MASK, __popc(bits));
      const size_t blk = (size_t)stream * gridDim.x * gridDim.y + blockIdx.y * gridDim.x + blockIdx.x;
      if (lane == 0) {
        a.split_count[2 * blk] = found;
        a.split_count[2 * blk + 1] = s_no_depth;
      }
      if (found != 0 && lane < n_tc)
        a.split_mask[(size_t)stream * n_cells + cr * a.n_cols + cc0 + lane] = (uint8_t)bits;
      if (a.tally != nullptr) {
        const int cells = __popc(__ballot_sync(TD_FULL_MASK, bits != 0u));
        if (lane == 0 && s_no_depth != 0) atomicAdd(&a.tally[0], (unsigned long long)s_no_depth);
        if (lane == 0 && cells != 0) atomicAdd(&a.tally[1], (unsigned long long)cells);
      }
    }
  }
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

template <int MODE, bool EXACT = false>
int launch(const PArgs& a, int n_streams, int smem, cudaStream_t s) {
  if (smem > 32 * 1024) {  // past the default limit beside the static arrays
    const cudaError_t err = cudaFuncSetAttribute(
        cell_sums_kernel<MODE, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.n_cols + a.tile_cells - 1) / a.tile_cells, a.n_rows, n_streams);
  cell_sums_kernel<MODE, EXACT><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int round16(int n) { return (n + 15) & ~15; }

// A strip's cells, whether its pixels' values are staged, and its shared
// bytes: for t cells, the frame's rows and, staged, each pixel's values and
// tag. The most cells (halving from 32) that fit the budget; a cell too
// large to stage its values computes them in place. -1 where none fits.
int strip_layout(int cell_px, int mode, int* staged, int* smem) {
  const int nv = mode == MODE_VOTES ? 6 : 3;
  auto bytes = [&](int t, int st) {
    const int pitch = round16(t * cell_px);  // and a run of 8 pixels listed in 4 bytes
    return cell_px * pitch * (6 + (st ? 4 * nv + 1 : 0)) + (st ? cell_px * pitch / 2 : 0);
  };
  *staged = 1;
  int tile = TILE_CELLS;
  while (tile > 1 && bytes(tile, 1) > TILE_BUDGET) tile >>= 1;
  if (bytes(tile, 1) > MAX_DYN_SMEM) {
    *staged = 0;
    while (tile > 1 && bytes(tile, 0) > TILE_BUDGET) tile >>= 1;
  }
  *smem = bytes(tile, *staged);
  return *smem > MAX_DYN_SMEM ? -1 : tile;
}

}  // namespace

// Kernel P's strip of cells for (cell_px, mode): out[0] the cells a block
// takes along a cell row (-1 where the cell is too large), out[1] the
// blocks of one stream's frame (h, w): the layout of `split_count`.
extern "C" int trackdlo_cell_sums_grid(int h, int w, int cell_px, int mode, int* out) {
  if (h <= 0 || w <= 0 || cell_px <= 0) return (int)cudaErrorInvalidValue;
  int staged, smem;
  const int tile = strip_layout(cell_px, mode, &staged, &smem);
  const int n_cols = (w + cell_px - 1) / cell_px, n_rows = (h + cell_px - 1) / cell_px;
  out[0] = tile;
  out[1] = tile > 0 ? ((n_cols + tile - 1) / tile) * n_rows : 0;
  return 0;
}

// mode: 0 parity (out (4, B, 8, n_cells)), 1 one channel without votes
// (out (4, B, n_cells)), 2 one channel with the floor votes (out (7, B, n_cells)).
// exact (mode 0): the exact route, with split_mask (B, n_cells) u8 and
// split_count (B, trackdlo_cell_sums_grid's blocks, 2) int32; tally null or
// two u64 counters.
extern "C" int trackdlo_cell_sums(const uint8_t* rgb, const uint16_t* depth,
                                  const uint8_t* occ, int n_streams, int h, int w, int cell_px,
                                  const float* bands, int n_bands, float fx,
                                  float fy, float cx, float cy, float kx, float ky,
                                  float k_zq, float kz, int z_from_mm, int mode, float* out,
                                  int exact, uint8_t* split_mask, int* split_count,
                                  unsigned long long* tally, void* stream) {
  if (n_streams <= 0 || n_streams > 65535 || h <= 0 || w <= 0 || cell_px <= 0 || n_bands <= 0 ||
      n_bands > MAX_BANDS)
    return (int)cudaErrorInvalidValue;
  if (exact && (mode != MODE_PARITY || split_mask == nullptr || split_count == nullptr))
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
  int smem;
  a.tile_cells = strip_layout(cell_px, mode, &a.staged, &smem);
  if (a.tile_cells < 0) return (int)cudaErrorInvalidValue;
  const int tile_px = a.tile_cells * cell_px;
  a.m_pitch = round16(tile_px);
  a.rgb_pitch = 3 * a.m_pitch;
  a.d_pitch = 2 * a.m_pitch;
  const uintptr_t addr = (uintptr_t)rgb | (uintptr_t)depth | (uintptr_t)occ;
  a.vec = (addr & 15) == 0 && w % 16 == 0 && tile_px % 16 == 0;
  a.bands = bands;
  a.n_bands = n_bands;
  a.k = TdPixelConsts{fx, fy, cx, cy, kx, ky, k_zq, kz, z_from_mm};
  a.out = out;
  a.split_mask = split_mask;
  a.split_count = split_count;
  a.tally = tally;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == MODE_PARITY)
    return exact ? launch<MODE_PARITY, true>(a, n_streams, smem, s)
                 : launch<MODE_PARITY>(a, n_streams, smem, s);
  if (mode == MODE_CELLS) return launch<MODE_CELLS>(a, n_streams, smem, s);
  if (mode == MODE_VOTES) return launch<MODE_VOTES>(a, n_streams, smem, s);
  return (int)cudaErrorInvalidValue;
}
