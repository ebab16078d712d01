// Kernel X: the exact route's split channel-cells, summed voxel by voxel.
//
// Replaces no TPU kernel. The parity split (kernel P, mode 0; the JAX
// package's cell_sums_pallas) keeps PCL's VoxelGrid only while each parity
// channel's pixels in an image cell lie in one voxel. Depth noise (a
// millimetre or more at a 5 mm leaf) or a cell wider than the leaf puts
// voxels k and k+2 of one parity in one cell, and the route merges them;
// and it drops the masked pixels with no depth return, which the reference
// keeps as points at the origin. On the exact route kernel P leaves such a
// channel-cell's sums at zero and marks it, and counts the pixels without
// depth (split_mask, split_count); kernel C packs the other cells; this
// kernel then sums each marked channel-cell's masked pixels voxel by voxel
// and appends the groups to the channel's row of kernel C's output, after
// the packed cells, and after channel 0's groups one candidate at the
// origin weighing the pixels without depth. The voxel snap merges them
// with the rest of their voxels. So the cloud holds PCL's voxels at any
// depth noise, up to the rows' cap_per slots (the route's capacity, as for
// the packed cells: twice the cloud's max_points).
//
// What bounds it on an H100: on a frame with no split channel-cell, launch
// latency (it reads kernel P's per-block counts, 618 ints at 720p and a
// 5 mm leaf, and exits). Otherwise latency: ~900 split channel-cells a
// 720p frame at 2 mm depth noise and 5% dropout, each a chain of passes
// over one cell's 49 pixels (re-read from L2, where kernel P left the
// frame); the bytes (those cells' pixels, ~6 B each) take under a
// microsecond at 3.35 TB/s.
//
// Design: one block of 1024 threads a stream.
// 1. Any block of kernel P's with a split channel-cell or a pixel without
//    depth? If none, exit.
// 2. The blocks' counts give each block's first entry (a block scan); a
//    warp a block with splits (found 32 blocks at a time by a ballot) lists
//    its channel-cells in (cell, channel) order from the cells' bytes (a
//    warp scan of their popcounts).
// 3. Eight warps count the packed slots of the stream's eight rows.
// 4. A warp an entry walks its voxels in ascending (x, y, z) floor order:
//    a lane reads its pixels once (all loads in flight; keys and depths in
//    registers for cells up to 64 pixels), then each pass sums the pixels
//    of the current voxel (a lane its pixels in raster order, then
//    td_warp_sum's tree, so the sums are the same run to run) and finds the
//    next voxel (a warp minimum of packed 64-bit floors). The first GMAX
//    groups' sums are kept in scratch.
// 5. One warp gives each entry its first slot: a channel's groups follow
//    its row's packed cells in entry order (eight warp scans a chunk).
// 6. The block writes the kept groups, centroid = sum / count (IEEE
//    division), count and valid; an entry with more than GMAX groups walks
//    again for the rest; then the origin's candidate (0, 0, 0). Groups past
//    cap_per are dropped.
// No float atomics; the per-pixel chains are kernel P's (pixel.cuh). The
// work it did (cells, pixels, entries, groups, slots scanned) is added to a
// device tally for the benchmark's roofline share.
#include "pixel.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 4;              // groups an entry keeps from its first walk
constexpr int CACHED = 2;            // pixels a lane keeps in registers (cells up to 64 px)
constexpr int MAX_BANDS = 4;
constexpr int KEY_BIAS = 1 << 20;    // packed floors: 21 bits an axis
constexpr unsigned long long NONE = ~0ull;
constexpr int N_WORK = 6;

// frames regrouped, split cells, their pixels, split channel-cells, groups
// written, row slots scanned (trackdlo_split_cells_work).
__device__ unsigned long long g_work[N_WORK];

struct XArgs {
  const uint8_t* rgb;
  const uint16_t* depth;
  const uint8_t* occ;
  int h, w, cell_px, n_cols, n_cells, tile_cells, n_strips, n_pblocks;
  const float* bands;
  int n_bands;
  TdPixelConsts k;
  const uint8_t* split_mask;  // (B, n_cells)
  const int* split_count;     // (B, n_pblocks, 2): split channel-cells, pixels without depth
  float* pts;                 // (B·8, cap_per, 3)
  float* cnt;                 // (B·8, cap_per)
  uint8_t* valid;             // (B·8, cap_per)
  int cap_per, list_cap;
  int* scratch_i;             // (B, n_pblocks + 3·list_cap)
  float* scratch_f;           // (B, list_cap·GMAX·4)
};

__device__ __forceinline__ int warp_incl_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(TD_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(TD_FULL_MASK, v, o);
    v = u < v ? u : v;
  }
  return v;
}

// Pixel (row, col) of stream b's frame for channel c: its packed voxel
// floors, or NONE where it is not one of the channel's masked pixels with
// depth; its depth in millimetres in df.
__device__ __forceinline__ unsigned long long pixel_key(const XArgs& a, size_t frame0, int row,
                                                        int col, int c, float& df) {
  const size_t i = frame0 + (size_t)row * a.w + col;
  const uint16_t dmm = a.depth[i];  // every load issued before any test
  const uint8_t m = a.occ[i];
  const uint8_t px3[3] = {a.rgb[3 * i], a.rgb[3 * i + 1], a.rgb[3 * i + 2]};
  if (dmm == 0 || m == 0 || !td_in_bands(px3, a.bands, a.n_bands)) return NONE;
  df = (float)dmm;
  float fk[3];
  td_voxel_floors(a.k, df, (float)col, (float)row, fk);
  if (td_parity_channel(fk) != c) return NONE;
  return ((unsigned long long)((int)fk[0] + KEY_BIAS) << 42) |
         ((unsigned long long)((int)fk[1] + KEY_BIAS) << 21) |
         (unsigned long long)((int)fk[2] + KEY_BIAS);
}

// Walk entry (cell, c) of stream b: emit(r, sx, sy, sz, n) on lane 0 for
// its r-th voxel in ascending packed-floor order. Returns the groups. A
// lane keeps its pixels' keys and depths in registers where the cell has
// at most 32·CACHED pixels, and reads them again each pass otherwise.
template <class Emit>
__device__ int walk_groups(const XArgs& a, int b, int cell, int c, int lane, Emit emit) {
  const int cp = a.cell_px;
  const int row0 = (cell / a.n_cols) * cp, col0 = (cell % a.n_cols) * cp;
  const int th = min(cp, a.h - row0), tw = min(cp, a.w - col0), npx = th * tw;
  const size_t frame0 = (size_t)b * a.h * a.w;
  const bool cached = npx <= 32 * CACHED;
  unsigned long long keys[CACHED];
  float depths[CACHED];
#pragma unroll
  for (int q = 0; q < CACHED; ++q) {
    const int p = lane + 32 * q, pr = p / tw;
    keys[q] = cached && p < npx
                  ? pixel_key(a, frame0, row0 + pr, col0 + (p - pr * tw), c, depths[q]) : NONE;
  }
  unsigned long long cur = NONE, lower = 0ull;
  int r = 0;
  while (true) {
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, sn = 0.0f;
    unsigned long long next = NONE;
    // One pixel p of the lane's, in raster order: add it to the current
    // voxel's sums, or bid it as the next voxel.
    auto visit = [&](int p, unsigned long long key, float df) {
      if (key == NONE) return;
      if (key == cur) {
        const int pr = p / tw;
        float xyz[3];
        td_deproject(a.k, df, (float)(col0 + (p - pr * tw)), (float)(row0 + pr), xyz);
        sx += xyz[0];
        sy += xyz[1];
        sz += xyz[2];
        sn += 1.0f;
      } else if (key > lower && key < next) {
        next = key;
      }
    };
    if (cached) {
#pragma unroll
      for (int q = 0; q < CACHED; ++q) visit(lane + 32 * q, keys[q], depths[q]);
    } else {
      for (int p = lane; p < npx; p += 32) {
        const int pr = p / tw;
        float df = 0.0f;
        const unsigned long long key = pixel_key(a, frame0, row0 + pr, col0 + (p - pr * tw), c, df);
        visit(p, key, df);
      }
    }
    if (cur != NONE) {
      sx = td_warp_sum(sx);
      sy = td_warp_sum(sy);
      sz = td_warp_sum(sz);
      sn = td_warp_sum(sn);
      if (lane == 0) emit(r, sx, sy, sz, sn);
      ++r;
    }
    next = warp_min_u64(next);
    if (next == NONE) return r;
    cur = lower = next;
  }
}

__device__ __forceinline__ void put_group(const XArgs& a, int row, int slot, float sx, float sy,
                                          float sz, float sn) {
  const size_t o = (size_t)row * a.cap_per + slot;
  a.pts[3 * o + 0] = __fdiv_rn(sx, sn);
  a.pts[3 * o + 1] = __fdiv_rn(sy, sn);
  a.pts[3 * o + 2] = __fdiv_rn(sz, sn);
  a.cnt[o] = sn;
  a.valid[o] = 1;
}

__global__ void __launch_bounds__(THREADS, 1) split_cells_kernel(const XArgs a) {
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* counts = a.split_count + (size_t)b * a.n_pblocks * 2;
  int any = 0;
  for (int j = tid; j < 2 * a.n_pblocks; j += THREADS) any |= counts[j];
  if (__syncthreads_or(any != 0) == 0) return;  // nothing to regroup: the whole cost

  __shared__ int s_warp[WARPS];
  __shared__ int s_rows[8];
  __shared__ int s_base, s_cells, s_pixels, s_groups, s_no_depth;
  int* off = a.scratch_i + (size_t)b * (a.n_pblocks + 3 * a.list_cap);
  int* ent = off + a.n_pblocks;
  int* gcnt = ent + a.list_cap;
  int* slot = gcnt + a.list_cap;
  float* gdat = a.scratch_f + (size_t)b * a.list_cap * GMAX * 4;
  if (tid == 0) {
    s_base = 0;
    s_cells = 0;
    s_pixels = 0;
    s_groups = 0;
    s_no_depth = 0;
  }
  __syncthreads();

  // Each block's first entry: an exclusive scan of the counts, a chunk of
  // THREADS blocks at a time.
  for (int j0 = 0; j0 < a.n_pblocks; j0 += THREADS) {
    const int j = j0 + tid;
    const int v = j < a.n_pblocks ? counts[2 * j] : 0;
    if (j < a.n_pblocks && counts[2 * j + 1] != 0) atomicAdd(&s_no_depth, counts[2 * j + 1]);
    const int x = warp_incl_scan(v, lane);
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int t = s_warp[lane];
      s_warp[lane] = warp_incl_scan(t, lane) - t;
    }
    __syncthreads();
    if (j < a.n_pblocks) off[j] = s_base + s_warp[warp] + x - v;
    __syncthreads();
    if (tid == THREADS - 1) s_base += s_warp[warp] + x;
    __syncthreads();
  }
  const int n_ent = min(s_base, a.list_cap);

  // The entries, (cell, channel) ascending: a warp takes 32 blocks at a
  // time, then each of them that found splits.
  for (int j0 = 32 * warp; j0 < a.n_pblocks; j0 += 32 * WARPS) {
    unsigned found = __ballot_sync(TD_FULL_MASK, j0 + lane < a.n_pblocks &&
                                                     counts[2 * (j0 + lane)] != 0);
    for (; found != 0u; found &= found - 1u) {
      const int j = j0 + __ffs(found) - 1;
      const int cr = j / a.n_strips, cc0 = (j % a.n_strips) * a.tile_cells;
      const int n_tc = min(a.tile_cells, a.n_cols - cc0);
      const int cell = cr * a.n_cols + cc0 + lane;
      const unsigned bits = lane < n_tc ? a.split_mask[(size_t)b * a.n_cells + cell] : 0u;
      const int nb = __popc(bits);
      int pos = off[j] + warp_incl_scan(nb, lane) - nb;
      for (unsigned rest = bits; rest != 0u; rest &= rest - 1u, ++pos)
        if (pos < a.list_cap) ent[pos] = cell * 8 + (__ffs(rest) - 1);
      if (bits != 0u) {
        const int cp = a.cell_px;
        const int px = min(cp, a.h - cr * cp) * min(cp, a.w - (cc0 + lane) * cp);
        atomicAdd(&s_cells, 1);
        atomicAdd(&s_pixels, px);
      }
    }
  }
  // The packed cells of the stream's rows.
  if (warp < 8) {
    const uint8_t* v = a.valid + ((size_t)b * 8 + warp) * a.cap_per;
    int n = 0;
    for (int i = lane; i < a.cap_per; i += 32) n += v[i] != 0;
    n = __reduce_add_sync(TD_FULL_MASK, n);
    if (lane == 0) s_rows[warp] = n;
  }
  __syncthreads();

  // A warp an entry: its groups, and the first GMAX groups' sums.
  for (int e = warp; e < n_ent; e += WARPS) {
    const int id = ent[e];
    float* d = gdat + (size_t)e * GMAX * 4;
    const int g = walk_groups(a, b, id >> 3, id & 7, lane,
                              [&](int r, float sx, float sy, float sz, float sn) {
                                if (r < GMAX) {
                                  d[4 * r + 0] = sx;
                                  d[4 * r + 1] = sy;
                                  d[4 * r + 2] = sz;
                                  d[4 * r + 3] = sn;
                                }
                              });
    if (lane == 0) gcnt[e] = g;
  }
  __syncthreads();

  // Each entry's first slot: its channel's row after the packed cells and
  // the groups of the channel's earlier entries.
  if (warp == 0) {
    int run[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) run[q] = s_rows[q];
    for (int e0 = 0; e0 < n_ent; e0 += 32) {
      const int e = e0 + lane;
      const int c = e < n_ent ? (ent[e] & 7) : -1;
      const int g = e < n_ent ? gcnt[e] : 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int v = c == q ? g : 0;
        const int x = warp_incl_scan(v, lane);
        if (c == q) slot[e] = run[q] + x - v;
        run[q] += __shfl_sync(TD_FULL_MASK, x, 31);
      }
    }
    // The masked pixels without depth: one candidate at the origin after
    // channel 0's groups (its centroid is the origin whatever its count).
    if (lane == 0 && s_no_depth != 0 && run[0] < a.cap_per) {
      put_group(a, b * 8, run[0], 0.0f, 0.0f, 0.0f, (float)s_no_depth);
      atomicAdd(&s_groups, 1);
    }
  }
  __syncthreads();

  // The kept groups into their rows.
  for (int i = tid; i < n_ent * GMAX; i += THREADS) {
    const int e = i / GMAX, r = i - e * GMAX;
    const int s = slot[e] + r;
    if (r < gcnt[e] && s < a.cap_per) {
      const float* d = gdat + ((size_t)e * GMAX + r) * 4;
      put_group(a, b * 8 + (ent[e] & 7), s, d[0], d[1], d[2], d[3]);
      atomicAdd(&s_groups, 1);
    }
  }
  for (int e = warp; e < n_ent; e += WARPS) {
    if (gcnt[e] <= GMAX) continue;
    const int id = ent[e], s0 = slot[e];
    walk_groups(a, b, id >> 3, id & 7, lane, [&](int r, float sx, float sy, float sz, float sn) {
      if (r >= GMAX && s0 + r < a.cap_per) {
        put_group(a, b * 8 + (id & 7), s0 + r, sx, sy, sz, sn);
        atomicAdd(&s_groups, 1);
      }
    });
  }
  __syncthreads();
  if (tid == 0) {
    atomicAdd(&g_work[0], 1ull);
    atomicAdd(&g_work[1], (unsigned long long)s_cells);
    atomicAdd(&g_work[2], (unsigned long long)s_pixels);
    atomicAdd(&g_work[3], (unsigned long long)n_ent);
    atomicAdd(&g_work[4], (unsigned long long)s_groups);
    atomicAdd(&g_work[5], 8ull * a.cap_per);
  }
}

__global__ void work_kernel(unsigned long long* out, int reset) {
  const int i = threadIdx.x;
  if (i < N_WORK) {
    out[i] = g_work[i];
    if (reset) g_work[i] = 0ull;
  }
}

}  // namespace

extern "C" {

// Kernel X over B streams after kernel C (exact route). Frames as kernel P
// took them; split_mask/split_count from kernel P's exact mode, with its
// strip of tile_cells cells (trackdlo_cell_sums_grid); pts/cnt/valid
// kernel C's (B·8, cap_per) rows, updated in place; scratch_i (B,
// n_pblocks + 3·list_cap) int32 and scratch_f (B, list_cap·4·4) float32.
int trackdlo_split_cells(const void* rgb, const void* depth, const void* occ, int n_streams,
                         int h, int w, int cell_px, const float* bands, int n_bands, float fx,
                         float fy, float cx, float cy, float kx, float ky, float k_zq, float kz,
                         int z_from_mm, int tile_cells, const void* split_mask,
                         const void* split_count, void* pts, void* cnt, void* valid, int cap_per,
                         int list_cap, void* scratch_i, void* scratch_f, void* stream) {
  if (n_streams <= 0 || h <= 0 || w <= 0 || cell_px <= 0 || n_bands <= 0 ||
      n_bands > MAX_BANDS || tile_cells <= 0 || tile_cells > 32 || cap_per <= 0 || list_cap <= 0)
    return (int)cudaErrorInvalidValue;
  XArgs a{};
  a.rgb = (const uint8_t*)rgb;
  a.depth = (const uint16_t*)depth;
  a.occ = (const uint8_t*)occ;
  a.h = h;
  a.w = w;
  a.cell_px = cell_px;
  a.n_cols = (w + cell_px - 1) / cell_px;
  a.n_cells = a.n_cols * ((h + cell_px - 1) / cell_px);
  a.tile_cells = tile_cells;
  a.n_strips = (a.n_cols + tile_cells - 1) / tile_cells;
  a.n_pblocks = a.n_strips * ((h + cell_px - 1) / cell_px);
  a.bands = bands;
  a.n_bands = n_bands;
  a.k = TdPixelConsts{fx, fy, cx, cy, kx, ky, k_zq, kz, z_from_mm};
  a.split_mask = (const uint8_t*)split_mask;
  a.split_count = (const int*)split_count;
  a.pts = (float*)pts;
  a.cnt = (float*)cnt;
  a.valid = (uint8_t*)valid;
  a.cap_per = cap_per;
  a.list_cap = list_cap;
  a.scratch_i = (int*)scratch_i;
  a.scratch_f = (float*)scratch_f;
  split_cells_kernel<<<n_streams, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The work tally's six counters into out (six u64 on the card), zeroed
// where reset.
int trackdlo_split_cells_work(void* out, int reset, void* stream) {
  work_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((unsigned long long*)out, reset);
  return (int)cudaGetLastError();
}

}  // extern "C"
