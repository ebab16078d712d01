// Kernel L: the lockstep EM loop's trip decision on the card, and the CUDA
// graph conditional WHILE node it drives.
//
// Replaces no TPU kernel. The JAX package's per-iteration EM is a
// lax.while_loop (trackdlo_tpu/ops/cpd_lle.py), whose condition XLA
// evaluates on the TPU. The port's eager loop read one flag an iteration on
// the host (ops/cpd_lle.em_loop_lockstep), which no CUDA graph can hold.
// Under stream capture the loop becomes a conditional WHILE node (CUDA 12.4
// and later): this kernel, launched once before the node and once at the end
// of every trip of its body, reads each stream's `done` and iteration count,
// and sets the node's condition to "some stream is still active" (not done
// and below max_iter), as the eager loop's `active.any()` does.
//
// What bounds it on an H100: launch latency. It reads B bytes and B int32
// (B <= a few dozen streams) and writes one condition; one warp.
//
// Design: one warp; each lane tests streams lane, lane + 32, ...; one
// __any_sync. Lane 0 sets the condition (cudaGraphSetConditional), writes the
// flag where asked (the standalone check against the plain version) and adds
// the trip it opens to a device counter (trips[0]; trips[1] counts the
// launches that opened a loop), so the host learns how many trips a replay
// ran without reading anything inside the replay.
//
// The graph side (trackdlo_while_*): the conditional handle is created on the
// graph the stream is capturing into; the WHILE node is added to that graph
// after the stream's current dependencies (the launch above), becomes the
// stream's only dependency, and the body is captured into the node's body
// graph on a second stream (cudaStreamBeginCaptureToGraph).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(32) loop_flag_kernel(const unsigned char* __restrict__ done,
                                                       const int* __restrict__ it, int n,
                                                       int max_iter,
                                                       cudaGraphConditionalHandle handle,
                                                       int set_handle, int* __restrict__ flag,
                                                       long long* __restrict__ trips,
                                                       int opening) {
  const int lane = threadIdx.x;
  bool active = false;
  for (int b = lane; b < n; b += 32) active |= done[b] == 0 && it[b] < max_iter;
  const bool go = __any_sync(TD_FULL_MASK, active) != 0;
  if (lane == 0) {
    if (set_handle) cudaGraphSetConditional(handle, go ? 1u : 0u);
    if (flag != nullptr) *flag = go ? 1 : 0;
    if (trips != nullptr) {
      trips[0] += go ? 1 : 0;
      trips[1] += opening;
    }
  }
}

}  // namespace

extern "C" {

// The flag of B streams: `done` (B,) bool, `it` (B,) int32. With set_handle,
// sets the conditional `handle`; `flag` (one int32) and `trips` (two int64)
// may be null.
int trackdlo_loop_flag(const void* done, const void* it, int n, int max_iter,
                       unsigned long long handle, int set_handle, void* flag, void* trips,
                       int opening, void* stream) {
  loop_flag_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)done, (const int*)it, n, max_iter,
      (cudaGraphConditionalHandle)handle, set_handle, (int*)flag, (long long*)trips, opening);
  return (int)cudaGetLastError();
}

// A conditional handle on the graph `stream` is capturing into (no default
// value: kernel L sets it before the node runs).
int trackdlo_while_handle(void* stream, unsigned long long* handle) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr, &graph,
                                           nullptr, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  *handle = (unsigned long long)h;
  return (int)e;
}

// Adds the WHILE node of `handle` after `stream`'s current dependencies,
// makes it the stream's only dependency, and starts capturing
// `body_stream` into the node's body graph.
int trackdlo_while_open(void* stream, unsigned long long handle, void* body_stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream,
                                            params.conditional.phGraph_out[0], nullptr, nullptr,
                                            0, cudaStreamCaptureModeThreadLocal);
}

// Ends the capture of the body (the body graph stays owned by its node).
int trackdlo_while_close(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

}  // extern "C"
