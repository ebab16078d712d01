// Host-side native preprocessing core.
//
// TPU-native counterpart of the reference's C++ per-frame preprocessing
// (trackdlo_node.cpp:155-243: HSV segmentation, pinhole deprojection, PCL
// voxel-grid downsample). On-device the jitted JAX graph does this work; this
// library serves the host paths — offline sequence scoring, data loading for
// training/eval sweeps, and environments without an accelerator — at native
// speed with zero Python-loop overhead.
//
// Plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// HSV segmentation (OpenCV conventions: H in [0,180), S/V in [0,255]).
// ---------------------------------------------------------------------------

static inline void rgb_to_hsv(uint8_t r, uint8_t g, uint8_t b, float* h,
                              float* s, float* v) {
  float rf = r, gf = g, bf = b;
  float mx = std::max(rf, std::max(gf, bf));
  float mn = std::min(rf, std::min(gf, bf));
  float delta = mx - mn;
  *v = mx;
  *s = mx > 0 ? delta * 255.0f / mx : 0.0f;
  float hue = 0.0f;
  if (delta > 0) {
    if (mx == rf)
      hue = 60.0f * (gf - bf) / delta;
    else if (mx == gf)
      hue = 120.0f + 60.0f * (bf - rf) / delta;
    else
      hue = 240.0f + 60.0f * (rf - gf) / delta;
    if (hue < 0) hue += 360.0f;
  }
  *h = hue / 2.0f;
}

static inline bool in_range(float h, float s, float v, const int* lo,
                            const int* hi) {
  return h >= lo[0] && h <= hi[0] && s >= lo[1] && s <= hi[1] && v >= lo[2] &&
         v <= hi[2];
}

// rgb: (h*w*3) u8; out_mask: (h*w) u8 {0,255}.
// multi_color != 0 uses the hardcoded blue+red+yellow bands
// (color_thresholding, trackdlo_node.cpp:88-119).
void tdlo_hsv_mask(const uint8_t* rgb, int height, int width, const int* lower,
                   const int* upper, int multi_color, uint8_t* out_mask) {
  static const int blue_lo[3] = {90, 90, 60}, blue_hi[3] = {130, 255, 255};
  static const int red1_lo[3] = {130, 60, 50}, red1_hi[3] = {255, 255, 255};
  static const int red2_lo[3] = {0, 60, 50}, red2_hi[3] = {10, 255, 255};
  static const int yel_lo[3] = {15, 100, 80}, yel_hi[3] = {40, 255, 255};

  const int n = height * width;
  for (int i = 0; i < n; i++) {
    float h, s, v;
    rgb_to_hsv(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2], &h, &s, &v);
    bool on;
    if (multi_color) {
      on = in_range(h, s, v, blue_lo, blue_hi) ||
           in_range(h, s, v, red1_lo, red1_hi) ||
           in_range(h, s, v, red2_lo, red2_hi) ||
           in_range(h, s, v, yel_lo, yel_hi);
    } else {
      on = in_range(h, s, v, lower, upper);
    }
    out_mask[i] = on ? 255 : 0;
  }
}

// ---------------------------------------------------------------------------
// Deprojection + voxel-grid downsample (exact PCL-style semantics:
// per-voxel centroid over floor(p/leaf) bins, trackdlo_node.cpp:195-241).
// ---------------------------------------------------------------------------

struct VoxelAccum {
  double x = 0, y = 0, z = 0;
  int count = 0;
};

// Returns the number of voxels written (<= max_out). Zero-depth pixels are
// skipped (the reference keeps them and prunes the origin cluster later;
// equivalent end state).
int tdlo_deproject_downsample(const uint8_t* mask, const uint16_t* depth,
                              int height, int width, double fx, double fy,
                              double cx, double cy, double leaf,
                              double* out_points, int max_out) {
  std::unordered_map<uint64_t, VoxelAccum> voxels;
  voxels.reserve(4096);
  const double inv_leaf = 1.0 / leaf;
  for (int v = 0; v < height; v++) {
    for (int u = 0; u < width; u++) {
      int i = v * width + u;
      if (!mask[i]) continue;
      uint16_t d = depth[i];
      if (d == 0) continue;
      // Quantize coordinates to f32 like PCL's float point clouds (the
      // reference's pipeline stores PointXYZRGB, trackdlo_node.cpp:212-230),
      // so voxel binning matches bit-for-bit.
      double z = (float)(d / 1000.0);
      double x = (float)((u - cx) * z / fx);
      double y = (float)((v - cy) * z / fy);
      int64_t ix = (int64_t)std::floor(x * inv_leaf);
      int64_t iy = (int64_t)std::floor(y * inv_leaf);
      // z-axis voxel key in the exact integer-mm domain when the leaf is an
      // integral number of millimetres (r4 bit-pinned spec shared with the
      // oracle and the TPU paths — ops/preprocess.voxel_parity_bits): depth
      // is u16 mm, so floor(depth_mm / leaf_mm) is exact mathematics and
      // never flips on mm-quantized knife edges.
      const double leaf_mm = leaf * 1000.0;
      const int64_t leaf_mm_i = (int64_t)std::llround(leaf_mm);
      int64_t iz;
      if (leaf_mm_i > 0 && std::abs(leaf_mm - (double)leaf_mm_i) < 1e-6) {
        iz = (int64_t)d / leaf_mm_i;
      } else {
        iz = (int64_t)std::floor(z * inv_leaf);
      }
      uint64_t key = ((uint64_t)(ix & 0x1FFFFF) << 42) |
                     ((uint64_t)(iy & 0x1FFFFF) << 21) |
                     (uint64_t)(iz & 0x1FFFFF);
      VoxelAccum& a = voxels[key];
      a.x += x;
      a.y += y;
      a.z += z;
      a.count++;
    }
  }
  int n = 0;
  for (const auto& kv : voxels) {
    if (n >= max_out) break;
    out_points[3 * n] = kv.second.x / kv.second.count;
    out_points[3 * n + 1] = kv.second.y / kv.second.count;
    out_points[3 * n + 2] = kv.second.z / kv.second.count;
    n++;
  }
  return n;
}

// Fused mask -> deproject -> downsample over one frame.
int tdlo_preprocess_frame(const uint8_t* rgb, const uint16_t* depth,
                          const uint8_t* occlusion_mask,  // may be null
                          int height, int width, const int* lower,
                          const int* upper, int multi_color, double fx,
                          double fy, double cx, double cy, double leaf,
                          double* out_points, int max_out) {
  std::vector<uint8_t> mask(height * width);
  tdlo_hsv_mask(rgb, height, width, lower, upper, multi_color, mask.data());
  if (occlusion_mask) {
    for (int i = 0; i < height * width; i++)
      if (!occlusion_mask[i]) mask[i] = 0;
  }
  return tdlo_deproject_downsample(mask.data(), depth, height, width, fx, fy,
                                   cx, cy, leaf, out_points, max_out);
}

// ---------------------------------------------------------------------------
// Threaded double-buffered frame feeder.
//
// Raw sequence format (written by trackdlo_tpu.io.raw_sequence):
//   u32 magic 'TDLO' | u32 version | u32 n_frames | u32 height | u32 width
//   then per frame: rgb u8[h*w*3], depth u16[h*w].
// A background thread prefetches frames into a ring of slots so the compute
// thread never waits on disk — the host-side twin of the reference's ROS
// message queue (queue_size=10, trackdlo_node.cpp:614).
// ---------------------------------------------------------------------------

struct Feeder {
  FILE* f = nullptr;
  uint32_t n_frames = 0, height = 0, width = 0;
  size_t frame_bytes = 0;
  size_t header_bytes = 0;
  int n_slots = 0;
  std::vector<std::vector<uint8_t>> slots;
  std::vector<int> slot_frame;  // frame index stored in each slot, -1 empty
  std::atomic<uint32_t> next_to_read{0};
  uint32_t next_to_consume = 0;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::thread worker;
  std::atomic<bool> stop{false};
  // Consumers currently inside tdlo_feeder_next; close() drains this before
  // freeing the Feeder so a released waiter never touches freed state.
  std::atomic<int> consumers{0};
};

static void feeder_loop(Feeder* fd) {
  while (!fd->stop.load()) {
    uint32_t frame = fd->next_to_read.load();
    if (frame >= fd->n_frames) break;
    int slot = frame % fd->n_slots;
    {
      std::unique_lock<std::mutex> lk(fd->mu);
      fd->cv_empty.wait(lk, [&] {
        return fd->stop.load() || fd->slot_frame[slot] == -1;
      });
      if (fd->stop.load()) break;
    }
    long off = (long)(fd->header_bytes + (size_t)frame * fd->frame_bytes);
    fseek(fd->f, off, SEEK_SET);
    size_t got = fread(fd->slots[slot].data(), 1, fd->frame_bytes, fd->f);
    (void)got;
    {
      std::lock_guard<std::mutex> lk(fd->mu);
      fd->slot_frame[slot] = (int)frame;
    }
    fd->cv_full.notify_all();
    fd->next_to_read.store(frame + 1);
  }
}

void* tdlo_feeder_open(const char* path, int n_slots, uint32_t* out_n_frames,
                       uint32_t* out_height, uint32_t* out_width) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint32_t header[5];
  if (fread(header, 4, 5, f) != 5 || header[0] != 0x4F4C4454u) {  // 'TDLO'
    fclose(f);
    return nullptr;
  }
  Feeder* fd = new Feeder();
  fd->f = f;
  fd->n_frames = header[2];
  fd->height = header[3];
  fd->width = header[4];
  fd->header_bytes = 20;
  fd->frame_bytes =
      (size_t)fd->height * fd->width * 3 + (size_t)fd->height * fd->width * 2;
  fd->n_slots = n_slots > 0 ? n_slots : 2;
  fd->slots.assign(fd->n_slots, std::vector<uint8_t>(fd->frame_bytes));
  fd->slot_frame.assign(fd->n_slots, -1);
  fd->worker = std::thread(feeder_loop, fd);
  *out_n_frames = fd->n_frames;
  *out_height = fd->height;
  *out_width = fd->width;
  return fd;
}

static int feeder_next_impl(Feeder* fd, uint8_t* out_rgb, uint16_t* out_depth) {
  if (fd->next_to_consume >= fd->n_frames) return -1;
  uint32_t frame = fd->next_to_consume;
  int slot = frame % fd->n_slots;
  {
    std::unique_lock<std::mutex> lk(fd->mu);
    // The predicate must observe stop: otherwise a consumer blocked here is
    // never released by close()'s notify_all and close() joins/deletes while
    // the consumer still waits on freed state.
    fd->cv_full.wait(lk, [&] {
      return fd->stop.load() || fd->slot_frame[slot] == (int)frame;
    });
    if (fd->stop.load()) return -1;
  }
  size_t rgb_bytes = (size_t)fd->height * fd->width * 3;
  memcpy(out_rgb, fd->slots[slot].data(), rgb_bytes);
  memcpy(out_depth, fd->slots[slot].data() + rgb_bytes,
         (size_t)fd->height * fd->width * 2);
  {
    std::lock_guard<std::mutex> lk(fd->mu);
    fd->slot_frame[slot] = -1;
  }
  fd->cv_empty.notify_all();
  fd->next_to_consume++;
  return (int)frame;
}

// Blocks until the next frame is prefetched; copies it out. Returns the frame
// index, or -1 at end of sequence / after close().
int tdlo_feeder_next(void* handle, uint8_t* out_rgb, uint16_t* out_depth) {
  Feeder* fd = (Feeder*)handle;
  fd->consumers.fetch_add(1);
  int r = feeder_next_impl(fd, out_rgb, out_depth);
  fd->consumers.fetch_sub(1);
  return r;
}

void tdlo_feeder_close(void* handle) {
  Feeder* fd = (Feeder*)handle;
  fd->stop.store(true);
  fd->cv_empty.notify_all();
  fd->cv_full.notify_all();
  // Drain concurrent consumers before freeing: a waiter released by the
  // notify above must fully leave tdlo_feeder_next first.
  while (fd->consumers.load() > 0) {
    fd->cv_full.notify_all();
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  if (fd->worker.joinable()) fd->worker.join();
  fclose(fd->f);
  delete fd;
}

}  // extern "C"
