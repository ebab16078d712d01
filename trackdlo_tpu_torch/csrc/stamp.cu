// The stamp kernel: a device time stamp, for the span recorder
// (trackdlo_tpu_torch/utils/profiling.py).
//
// Replaces no TPU kernel. The JAX package reads its device's timeline from
// jax.profiler alone; the port's CUDA graphs hold kernels that the CUDA
// profiler does not see (those inside a conditional WHILE node), so the
// recorder puts its own stamps at the step's layer boundaries.
//
// One thread reads %globaltimer (nanoseconds, the same clock on every SM)
// and appends (time, tag) to a device buffer at the slot it takes from the
// buffer's cursor. Launched on the stream the graph is captured from, a
// stamp runs after the work enqueued before it and before the work after
// it, so a pair of stamps brackets a layer; it works inside any graph node,
// conditional bodies included, and asks nothing of the host at replay. The
// buffer is read once, when the recorder drains it. A stamp past the
// buffer's end is dropped and counted (header[1]).
//
// What bounds it on an H100: launch latency (one thread, 12 bytes written).
#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(1) stamp_kernel(unsigned long long* __restrict__ header,
                                                   long long* __restrict__ times,
                                                   int* __restrict__ tags, int capacity, int tag) {
  const unsigned long long t = global_ns();
  const unsigned long long slot = atomicAdd(header, 1ull);
  if (slot < (unsigned long long)capacity) {
    times[slot] = (long long)t;
    tags[slot] = tag;
  } else {
    atomicAdd(header + 1, 1ull);
  }
}

// The timer's step: the smallest and the mean advance between two distinct
// readings, over `changes` advances.
__global__ void __launch_bounds__(1) timer_step_kernel(long long* __restrict__ out, int changes) {
  unsigned long long prev = global_ns(), first = prev, least = ~0ull;
  int seen = 0;
  for (long long spins = 0; seen < changes && spins < (1ll << 26); ++spins) {
    const unsigned long long t = global_ns();
    if (t != prev) {
      least = t - prev < least ? t - prev : least;
      prev = t;
      ++seen;
    }
  }
  out[0] = seen ? (long long)least : -1;
  out[1] = seen ? (long long)((prev - first) / seen) : -1;
}

}  // namespace

extern "C" {

// Appends (%globaltimer, tag) at the cursor of `header` (two uint64: the
// cursor, the stamps dropped) into `times` (int64) and `tags` (int32) of
// `capacity` slots.
int trackdlo_stamp(void* header, void* times, void* tags, int capacity, int tag, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)header,
                                                  (long long*)times, (int*)tags, capacity, tag);
  return (int)cudaGetLastError();
}

// Writes the timer's smallest and mean step (ns) over `changes` advances into
// `out` (two int64; -1 where the timer never advanced).
int trackdlo_timer_step(void* out, int changes, void* stream) {
  timer_step_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)out, changes);
  return (int)cudaGetLastError();
}

}  // extern "C"
