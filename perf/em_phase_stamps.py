"""Where kernel E's iteration, kernel G's solve and kernel W's walk steps
spend their cycles, from clock64() stamps in instrumented builds of the
port's CUDA sources.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python3 perf/em_phase_stamps.py [--parent DIR] [--variant NAME=DIR ...] [--only e,g,w]

The instrumented sources are generated from ``trackdlo_tpu_torch/csrc`` (and
from ``DIR/trackdlo_tpu_torch/csrc`` of an unpacked earlier tree for
``--parent``, or of any other tree for each ``--variant``) into
``build/em_phase_stamps/``; nothing instrumented is part of the package. Thread 0 of the first CTA stamps the phase boundaries,
so the cycles are those of one SM's clock.

- Kernel E: 10 iterations (tol 0) of the main pass's configuration with the
  gate on, on the live cloud of ``chip_smoke.py`` (frame 1, 2048 rows);
  cycles per iteration by phase, and the launch's time by CUDA events.
- Kernel G: one solve of the live pre-registration system saved in
  ``tests/data/gj_prereg_system.npz`` (8 copies) and of the (16, 48, 48) SPD
  systems of ``chip_smoke.py``, cycles of block 0 and CUDA events; each
  variant's solution bit for bit against the saved ones (of the design with
  a float32 refinement residual, and of the current one); the current
  sources at 512 threads and at 256.
- Kernel W: chip_smoke.py's five walk cases, per step of each case's
  longest walk (its lane 0): the look-ahead read, the segment tests, the
  warp's first acceptable segment, the broadcast and store; its steps and
  live steps, and the launch's time by CUDA events.
- Kernel P: chip_smoke.py's live frame (parity mode), per phase of the
  warps of the fullest cell and of an empty cell of its cell row: in the
  design before the strip-staged one the pixel loop, the 32 shuffle trees
  and lane 0's stores; in the current one the strip's load and pixel pass
  (block-wide), the cell pass, the transposed reduction, the store into
  shared memory and the block's store; the current sources also at 8 and
  16 cells a strip and with blocks of 256 threads. Kernel C: that frame's cell sums (8 rows, 256 slots),
  block 0 per phase: before, the chained chunks' ballots, scans and
  scatters; now the ballots, the scan, the cluster barrier, the read of
  the other CTAs' totals, the scatter and the tail; the current sources
  also with clusters of at most 1, 2 and 4 CTAs. Both also by the
  profiler's device time. ``--only`` picks the kernels (e, g, w, p, c).
- In E and G, the solve's pivot steps (``gj.cuh``), per step: each phase as
  thread 0 of block 0 sees it (the search, the factors, the update, the
  barrier; in the current solve the search is the search warp's, with its
  column k + 1, pick and publication apart), the barrier's skew (first to
  last warp arriving) and its release after the last arrival; per solve,
  the inverse and the refinement.

Writes ``chiprun_out/em_phase_stamps.json``. The text anchors below follow
the sources; a source change that moves one fails here loudly.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT_DIR = os.path.join(ROOT, "build", "em_phase_stamps")
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-fmad=false", "-Xcompiler", "-fPIC", "-shared"]

# The solve (gj.cuh), in block 0: thread 0 stamps each pivot step's phases
# into registers; lane 0 of each warp stamps its arrival at the step's
# barrier and thread 0 its release, into shared memory; at the end of each
# solve thread 0 adds the spread between the first and the last warp to
# arrive (the barrier's skew) and the time from the last arrival to its own
# release, and every sum goes to global memory (no global access inside a
# step, where its latency would land in the next phase).
GJ_STAMPS = r'''
__device__ unsigned long long gj_acc[GJ_NACC];
__device__ unsigned long long gj_sp[GJ_NSP];
#define GJ_ON (blockIdx.x == 0)
#define GJ_DECL() long long _gj_acc[GJ_NACC - 4] = {0}; long long _gj_prev = 0, _gj_sprev = 0, _gj_s = 0; \
  long long _gj_sp[GJ_NSP] = {0}; \
  __shared__ long long _gj_arr[GJ_MMAX][32]; __shared__ long long _gj_rel[GJ_MMAX]
#define GJ_T(p) do { if (GJ_ON && threadIdx.x == 0) { const long long _t = clock64(); \
  if ((p) > 0) _gj_acc[(p) - 1] += _t - _gj_prev; _gj_prev = _t; } } while (0)
#define GJ_ARRIVE(k) do { if (GJ_ON && (threadIdx.x & 31) == 0) _gj_arr[k][threadIdx.x >> 5] = clock64(); } while (0)
#define GJ_RELEASE(k) do { if (GJ_ON && threadIdx.x == 0) _gj_rel[k] = clock64(); } while (0)
#define GJ_S_START() do { if (GJ_ON && threadIdx.x == blockDim.x - 32) _gj_sprev = clock64(); } while (0)
#define GJ_SP(p) do { if (GJ_ON && threadIdx.x == blockDim.x - 32) { const long long _t = clock64(); \
  _gj_sp[(p)] += _t - _gj_sprev; _gj_s += _t - _gj_sprev; _gj_sprev = _t; } } while (0)
#define GJ_FLUSH(nw, steps) do { if (GJ_ON && threadIdx.x == 0) { long long _sk = 0, _re = 0; \
  for (int _k = 0; _k < (steps); ++_k) { long long _lo = _gj_arr[_k][0], _hi = _lo; \
    for (int _w = 1; _w < (nw); ++_w) { const long long _v = _gj_arr[_k][_w]; \
      _lo = _v < _lo ? _v : _lo; _hi = _v > _hi ? _v : _hi; } \
    _sk += _hi - _lo; _re += _gj_rel[_k] - _hi; } \
  _Pragma("unroll") for (int _i = 0; _i < GJ_NACC - 4; ++_i) \
    atomicAdd(&gj_acc[_i], (unsigned long long)_gj_acc[_i]); \
  atomicAdd(&gj_acc[GJ_NACC - 4], (unsigned long long)_sk); \
  atomicAdd(&gj_acc[GJ_NACC - 3], (unsigned long long)_re); \
  atomicAdd(&gj_acc[GJ_NACC - 2], (unsigned long long)(steps)); atomicAdd(&gj_acc[GJ_NACC - 1], 1ull); } \
  if (GJ_ON && threadIdx.x == blockDim.x - 32) { atomicAdd(&gj_acc[0], (unsigned long long)_gj_s); \
    _Pragma("unroll") for (int _i = 0; _i < GJ_NSP; ++_i) \
      atomicAdd(&gj_sp[_i], (unsigned long long)_gj_sp[_i]); } } while (0)
'''
GJ_HOST = r'''
extern "C" int gj_reset() {
  unsigned long long z[GJ_NACC] = {0}, zs[GJ_NSP] = {0};
  cudaError_t e = cudaMemcpyToSymbol(td::gj_acc, z, sizeof(z));
  return (int)(e != cudaSuccess ? e : cudaMemcpyToSymbol(td::gj_sp, zs, sizeof(zs)));
}
extern "C" int gj_read(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, td::gj_acc, sizeof(td::gj_acc));
  return (int)(e != cudaSuccess ? e : cudaMemcpyFromSymbol(out + GJ_NACC, td::gj_sp, sizeof(td::gj_sp)));
}
'''
# Per pivot step: the phases thread 0 stamps (in order), then the barrier's
# skew and release; per solve, the inverse and refinement after the loop.
GJ_PHASES = ["search", "factor", "update", "barrier", "tail"]
GJ_NACC = len(GJ_PHASES) + 4
# The current solve's search warp, per step: its update of column k + 1 (a
# division per row), the pick of step k + 1's pivot, its publication.
GJ_SEARCH_PHASES = ["column k + 1", "pick", "publish"]
GJ_NSP = len(GJ_SEARCH_PHASES)

# The previous solve: every warp searches; factors per cell.
GJ_PARENT_ANCHORS = [
    ("  const int act = m + 3;  // columns updated per step\n",
     "  const int act = m + 3;  // columns updated per step\n  GJ_DECL();\n"),
    ("  for (int k = 0; k < m; ++k) {\n    unsigned key = 0u;\n",
     "  for (int k = 0; k < m; ++k) {\n    GJ_T(0);\n    unsigned key = 0u;\n"),
    ("    const float pv_safe = pv == 0.0f ? 1.0f : pv;\n",
     "    const float pv_safe = pv == 0.0f ? 1.0f : pv;\n    GJ_T(1);\n"
     "    float fs[NC];\n#pragma unroll\n    for (int i = 0; i < NC; ++i)\n"
     "      fs[i] = cell_r[i] >= 0 ? G.aug[cell_r[i] * width + k] / pv_safe : 0.0f;\n    GJ_T(2);\n"),
    ("      const float f = G.aug[r * width + k] / pv_safe;\n", "      const float f = fs[i];\n"),
    ("    __syncthreads();\n  }\n  // inv[k] and w[k]",
     "    GJ_T(3);\n    GJ_ARRIVE(k);\n    __syncthreads();\n    GJ_T(4);\n    GJ_RELEASE(k);\n  }\n  // inv[k] and w[k]"),
    ("      w[q] = w[q] + acc;\n    }\n    __syncthreads();\n  }\n}\n",
     "      w[q] = w[q] + acc;\n    }\n    __syncthreads();\n  }\n  GJ_T(5);\n  GJ_FLUSH(NWARPS, m);\n}\n"),
]


# The current solve: the last warp searches (its lane 0 stamps its part of a
# step: column k + 1, the pick of step k + 1's pivot, its publication); thread
# 0, in an update warp, stamps dividing its row's factor, its update and the
# barrier.
GJ_ANCHORS = [
    ("  const int act = m + 3;  // slots updated per step\n",
     "  const int act = m + 3;  // slots updated per step\n  GJ_DECL();\n"),
    ("  for (int k = 0; k < m; ++k) {\n    const int p = G.piv_row[k & 1];\n",
     "  for (int k = 0; k < m; ++k) {\n    GJ_T(0);\n    GJ_S_START();\n    const int p = G.piv_row[k & 1];\n"),
    ("      col[1] = nxt[1];\n", "      col[1] = nxt[1];\n      GJ_SP(0);\n"),
    ("        const int ridx = gj_pick(m, used, col, pvn);\n",
     "        const int ridx = gj_pick(m, used, col, pvn);\n        GJ_SP(1);\n"),
    ("          G.diag[k + 1] = pvn;\n        }\n      }\n",
     "          G.diag[k + 1] = pvn;\n        }\n      }\n      GJ_SP(2);\n"),
    ("        const float f = row[k] / pv_safe;\n", "        const float f = row[k] / pv_safe;\n        GJ_T(2);\n"),
    ("    __syncthreads();\n  }\n  // inv[k] and w[k]",
     "    GJ_T(3);\n    GJ_ARRIVE(k);\n    __syncthreads();\n    GJ_T(4);\n    GJ_RELEASE(k);\n  }\n  // inv[k] and w[k]"),
    ("      w[q] = w[q] + acc;\n    }\n    __syncthreads();\n  }\n}\n",
     "      w[q] = w[q] + acc;\n    }\n    __syncthreads();\n  }\n  GJ_T(5);\n  GJ_FLUSH(NWARPS, m);\n}\n"),
]


def _stamp_gj(text: str) -> str:
    """gj.cuh with the per-step stamps; the anchors of whichever solve it holds."""
    anchors = GJ_ANCHORS if "piv_val" in text else GJ_PARENT_ANCHORS
    for old, new in anchors:
        text = _replace(text, old, new)
    return text.replace("namespace td {\n",
                        f"namespace td {{\n#define GJ_NACC {GJ_NACC}\n#define GJ_NSP {GJ_NSP}\n" + GJ_STAMPS, 1)


def _gj_record(lib) -> dict:
    acc = (ctypes.c_ulonglong * (GJ_NACC + GJ_NSP))()
    if lib.gj_read(acc) != 0:
        raise RuntimeError("gj_read failed")
    steps, solves = acc[GJ_NACC - 2], acc[GJ_NACC - 1]
    rec = {f"{p}_cycles_per_step": acc[i] / max(steps, 1) for i, p in enumerate(GJ_PHASES[:-1])}
    rec.update(barrier_skew_cycles_per_step=acc[GJ_NACC - 4] / max(steps, 1),
               barrier_release_cycles_per_step=acc[GJ_NACC - 3] / max(steps, 1),
               tail_cycles_per_solve=acc[len(GJ_PHASES) - 1] / max(solves, 1),
               steps=steps, solves=solves)
    if any(acc[GJ_NACC:]):
        rec["search_warp_cycles_per_step"] = {p: acc[GJ_NACC + i] / max(steps, 1)
                                              for i, p in enumerate(GJ_SEARCH_PHASES)}
    return rec


# E: stamps accumulate per phase over the iterations of one launch.
E_STAMPS = r'''
#pragma once
__device__ long long td_stamp_acc[8];
__device__ long long td_stamp_prev;
#define STAMP_START() do { if (threadIdx.x == 0 && blockIdx.x == 0) td_stamp_prev = clock64(); } while (0)
#define STAMP(p) do { if (threadIdx.x == 0 && blockIdx.x == 0) { long long _t = clock64(); \
  td_stamp_acc[p] += _t - td_stamp_prev; td_stamp_prev = _t; } } while (0)
'''
E_HOST = r'''
extern "C" int stamps_reset() { long long z[8] = {0}; return (int)cudaMemcpyToSymbol(td_stamp_acc, z, sizeof(z)); }
extern "C" int stamps_read(long long* out) { return (int)cudaMemcpyFromSymbol(out, td_stamp_acc, sizeof(td_stamp_acc)); }
'''
E_PHASES = ["minima and visibility weights", "E-step", "P1/PX/Np/trace sums", "M-step system",
            "solve", "T, sigma2, move", "cluster barrier and totals"]
# G: absolute stamps around the solve.
G_STAMPS = r'''
#pragma once
__device__ long long g_st[2];
#define STAMP(p) do { if (threadIdx.x == 0 && blockIdx.x == 0) g_st[p] = clock64(); } while (0)
'''
G_HOST = r'''
extern "C" int stamps_read(long long* out) { return (int)cudaMemcpyFromSymbol(out, g_st, sizeof(g_st)); }
'''

# W: per step of one walk (its lane 0), cycles by phase; the walk is chosen
# at run time (w_stamp_walk), so a walk that lives is stamped.
W_STAMPS = r'''
#pragma once
__device__ long long w_acc[8];
__device__ int w_stamp_walk;
#define W_ON(wk) ((wk) == w_stamp_walk && (threadIdx.x & 31) == 0)
#define W_DECL() long long _w_acc[4] = {0, 0, 0, 0}; long long _w_prev = 0, _w_start = clock64(); \
  int _w_steps = 0, _w_live = 0
#define W_T(wk, p) do { if (W_ON(wk)) { const long long _t = clock64(); \
  if ((p) > 0) _w_acc[(p) - 1] += _t - _w_prev; else ++_w_steps; _w_prev = _t; } } while (0)
// A stamp after v is in a register: the branch waits for v (a load's latency).
#define W_T_DEP(wk, p, v) do { if (__float_as_uint(v) == 0xffffffffu) _w_live += 1 << 20; \
  W_T(wk, p); } while (0)
#define W_LIVE(wk, eff) do { if (W_ON(wk) && (eff)) ++_w_live; } while (0)
#define W_FLUSH(wk) do { if (W_ON(wk)) { for (int _i = 0; _i < 4; ++_i) w_acc[_i] = _w_acc[_i]; \
  w_acc[4] = _w_steps; w_acc[5] = _w_live; w_acc[6] = clock64() - _w_start; } } while (0)
'''
W_HOST = r'''
extern "C" int w_stamps_set(int walk) { long long z[8] = {0};
  cudaError_t e = cudaMemcpyToSymbol(w_acc, z, sizeof(z));
  return (int)(e != cudaSuccess ? e : cudaMemcpyToSymbol(w_stamp_walk, &walk, sizeof(walk))); }
extern "C" int w_stamps_read(long long* out) { return (int)cudaMemcpyFromSymbol(out, w_acc, sizeof(w_acc)); }
'''
W_PHASES = ["look-ahead load", "segment tests", "first acceptable segment", "broadcast and store"]
# The design before the redesign: every step of m - 1 runs (the anchors of
# the current design, below, are tried first).
W_PARENT_ANCHORS = [
    ("  int last = start_guide, node_pos = start_node;\n  bool alive = true;\n", "  W_DECL();\n"),
    ("  for (int step = 0; step < m - 1; ++step) {\n", "    W_T(wk, 0);\n"),
    ("    const float look = seglens[(size_t)wk * (m - 1) + min(max(node_pos, 0), m - 2)];\n",
     "    W_T_DEP(wk, 1, look);\n"),
    ("      if (ok) first_local = (float)s;  // k descends, so the lowest s wins\n    }\n",
     "    W_T(wk, 2);\n"),
    ("    const bool eff = alive_t && found;\n", "    W_T(wk, 3);\n    W_LIVE(wk, eff);\n"),
    ("    alive = alive && found;\n", "    W_T(wk, 4);\n"),
    ("    alive = alive && found;\n    W_T(wk, 4);\n  }\n", "  W_FLUSH(wk);\n"),
]
# The current design: the loop ends when the walk can no longer move.
W_ANCHORS = [
    ("    const float look = __shfl_sync(TD_FULL_MASK, (li >> 5) ? look_at[1] : look_at[0], li & 31);\n",
     "    W_T_DEP(wk, 1, look);\n"),
    ("  int last = start_guide, node_pos = start_node;\n", "  W_DECL();\n"),
    ("  for (int step = 0; step < m - 1; ++step) {\n", "    W_T(wk, 0);\n"),
    ("      first_local = s;\n    }\n", "    W_T(wk, 2);\n"),
    ("    const int first = __reduce_min_sync(TD_FULL_MASK, first_local);\n",
     "    W_T(wk, 3);\n    W_LIVE(wk, first != INT_MAX);\n"),
    ("      V[node_pos] = 1;\n    }\n", "    W_T(wk, 4);\n"),
    ("      V[node_pos] = 1;\n    }\n    W_T(wk, 4);\n  }\n", "  W_FLUSH(wk);\n"),
]


# The current P: the strip's load and the pixel pass (block-wide), then per
# cell of the warp the cell pass over shared memory, the transposed
# reduction, the store into shared memory; the block's store of the strip.
P_PHASES = ["strip load", "pixel pass", "cell pass", "reduction", "shared store", "block store"]
P_ANCHORS = [
    ("  const int d_pitch = a.d_pitch >> 1;\n", "  P_DECL();\n  const long long _p_b0 = clock64();\n"),
    ("  if (a.vec) asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n",
     "  const long long _p_b1 = clock64();\n  int _p_mine = -1;\n"),
    ("        s_tag[si] = (int8_t)tag;\n      }\n    }\n    __syncthreads();\n  }\n",
     "  const long long _p_b15 = clock64();\n"),
    ("  for (int k = warp; k < n_tc; k += WARPS) {\n",
     "    const int cell = cr * a.n_cols + cc0 + k;\n    P_T(cell, stream, 0);\n"
     "    if (P_ON(cell, stream)) { _p_acc[0] = _p_b1 - _p_b0; _p_acc[1] = _p_b15 - _p_b1; "
     "_p_start = _p_b0; _p_mine = cell; }\n"),
    ("      any = __any_sync(TD_FULL_MASK, mine);\n    }\n", "    P_T_DEP(cell, stream, 3, acc[0]);\n"),
    ("    const float s = any ? transpose_sum<A::N>(acc, lane) : 0.0f;\n", "    P_T_DEP(cell, stream, 4, s);\n"),
    ("s_out[lane >> SHIFT][k] = s;\n", "    P_T(cell, stream, 5);\n"),
    ("    P_T(cell, stream, 5);\n  }\n  __syncthreads();\n", "  const long long _p_b2 = clock64();\n"),
    ("n_cells + cell0 + k] = s_out[j][k];\n    }\n  }\n",
     "  if (_p_mine >= 0 && P_ON(_p_mine, stream)) { _p_acc[5] = clock64() - _p_b2; P_FLUSH(_p_mine, stream); }\n"),
]
# The current C: per block, its chunks' ballots, the scans of their warp
# totals, the cluster exchange of the CTAs' totals, the scatter, and the
# tail with the exit barrier.
C_PHASES = ["ballot", "scan of the warp totals", "cluster barrier", "remote totals", "scatter",
            "tail and exit barrier"]
C_ANCHORS = [
    ("  unsigned flags = 0;  // bit ch: this thread's cell of chunk ch is flagged\n", "  C_DECL();\n", False),
    ("    flags |= (unsigned)f << ch;\n  }\n  __syncthreads();\n", "  C_T(1);\n", True),
    ("    if (lane == 31) chunk_off[warp] = incl;\n  }\n  __syncthreads();\n", "  C_T(2);\n", True),
    ("  cluster.sync();\n", "  C_T(3);\n", True),
    ("  cluster_arrive();  // this CTA's reads of the others' totals are done\n  __syncthreads();\n",
     "  C_T(4);\n", True),
    ("    V[slot] = 1;\n  }\n", "  C_T(5);\n", True),
    ("    V[s] = 0;\n  }\n  cluster_wait();\n", "  _c_chunks = n_chunks;\n  C_T(6);\n  C_FLUSH();\n", True),
]


def _walks_source(csrc: str) -> str:
    text = open(os.path.join(csrc, "walks.cu")).read()
    anchors = W_ANCHORS if W_ANCHORS and W_ANCHORS[0][0] in text else W_PARENT_ANCHORS
    for old, add in anchors:
        text = _insert(text, old, add)
    return '#include "stamps.cuh"\n' + text + W_HOST


def kernel_w(torch, variants) -> dict:
    """Kernel W on chip_smoke.py's five walk cases: per variant, the stamped
    walk's cycles per step by phase (the case's longest walk), its steps
    and live steps, and the launch's time by CUDA events."""
    import chip_smoke
    from trackdlo_tpu_torch import _build as tb

    smoke = chip_smoke.Smoke()
    smoke.check_walks()
    cases = ("all_visible", "mid_occluded", "tail_occluded", "head_occluded", "both_ends_occluded")
    out = {}
    for name, csrc in variants:
        lib = _build(f"walks_{name}", csrc, _headers(csrc), "walks.cu", _walks_source(csrc), W_STAMPS)
        fn = lib.trackdlo_walks
        fn.argtypes, fn.restype = tb.SIGNATURES["trackdlo_walks"], ctypes.c_int
        rec = {}
        for case in cases:
            g, sl, ints = (torch.from_numpy(smoke.walk_bits[f"{case}_{k}"]).to(smoke.dev)
                           for k in ("guides", "seglens", "ints"))
            n_w, m = g.shape[:2]
            pos = torch.empty((n_w, m, 3), device=smoke.dev)
            valid = torch.empty((n_w, m), dtype=torch.uint8, device=smoke.dev)
            walk = int(torch.from_numpy(smoke.walk_bits[f"{case}_valid"]).sum(1).argmax())

            def run():
                code = fn(g.data_ptr(), sl.data_ptr(), ints.data_ptr(), n_w, m, 1e-4, pos.data_ptr(),
                          valid.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise RuntimeError(f"{name}: launch failed with cudaError_t {code}")

            run()
            torch.cuda.synchronize()
            if lib.w_stamps_set(walk) != 0:
                raise RuntimeError("w_stamps_set failed")
            run()
            torch.cuda.synchronize()
            acc = (ctypes.c_longlong * 8)()
            if lib.w_stamps_read(acc) != 0:
                raise RuntimeError("w_stamps_read failed")
            steps = max(acc[4], 1)
            rec[case] = {"walk": walk, "steps": acc[4], "live_steps": acc[5] & ((1 << 20) - 1),
                         "cycles_per_step": {W_PHASES[i]: acc[i] / steps for i in range(4)},
                         "walk_cycles": acc[6], "ms": _events_ms(torch, run, 200),
                         "equals_saved": bool(np.array_equal(pos.cpu().numpy(), smoke.walk_bits[f"{case}_pos"])
                                              and np.array_equal(valid.cpu().numpy().astype(bool),
                                                                 smoke.walk_bits[f"{case}_valid"]))}
            print(f"W {name:10s} {case:20s} walk {walk}: {rec[case]['steps']} steps ({rec[case]['live_steps']} "
                  f"live), {acc[6]} cycles; per step {_rounded(rec[case]['cycles_per_step'])}; "
                  f"{rec[case]['ms']:.4f} ms; equal to the unstamped kernel's {rec[case]['equals_saved']}",
                  flush=True)
        out[name] = rec
    return out


# P: per stamped cell (its warp's lane 0), cycles by phase, chosen at run
# time (p_stamp_cells: an occupied cell and an empty one of stream 0).
P_STAMPS = r'''
#pragma once
__device__ long long p_acc[2][8];
__device__ int p_stamp_cells[2];
#define P_ON(cell, s) ((s) == 0 && (threadIdx.x & 31) == 0 && ((cell) == _p_c0 || (cell) == _p_c1))
#define P_DECL() long long _p_acc[7] = {0, 0, 0, 0, 0, 0, 0}; long long _p_prev = 0, _p_start = 0; \
  const int _p_c0 = p_stamp_cells[0], _p_c1 = p_stamp_cells[1]
#define P_T(cell, s, p) do { if (P_ON(cell, s)) { const long long _t = clock64(); \
  if ((p) > 0) _p_acc[(p) - 1] += _t - _p_prev; else _p_start = _t; _p_prev = _t; } } while (0)
// A stamp after v is in a register: the branch waits for v.
#define P_T_DEP(cell, s, p, v) do { if (__float_as_uint(v) == 0xffffffffu) _p_prev -= 1; \
  P_T(cell, s, p); } while (0)
#define P_FLUSH(cell, s) do { if (P_ON(cell, s)) { const int _k = (cell) == _p_c0 ? 0 : 1; \
  for (int _i = 0; _i < 7; ++_i) p_acc[_k][_i] = _p_acc[_i]; p_acc[_k][7] = clock64() - _p_start; } } while (0)
'''
P_HOST = r'''
extern "C" int p_stamps_set(int occupied, int empty) { long long z[16] = {0}; int c[2] = {occupied, empty};
  cudaError_t e = cudaMemcpyToSymbol(p_acc, z, sizeof(z));
  return (int)(e != cudaSuccess ? e : cudaMemcpyToSymbol(p_stamp_cells, c, sizeof(c))); }
extern "C" int p_stamps_read(long long* out) { return (int)cudaMemcpyFromSymbol(out, p_acc, sizeof(p_acc)); }
'''
# The design before the redesign: one warp per cell reading the frame in
# place, 32 shuffle trees, lane 0 storing each sum.
P_PARENT_PHASES = ["pixel loop", "reductions", "stores"]
P_PARENT_ANCHORS = [
    ("  const int cr = cell / n_cols, cc = cell % n_cols;\n", "  P_DECL();\n  P_T(cell, stream, 0);\n"),
    ("      acc[0][3] += 1.0f;\n      if constexpr (MODE == MODE_VOTES) {\n        acc[0][4] += fkx;\n"
     "        acc[0][5] += fky;\n        acc[0][6] += fkz;\n      }\n    }\n  }\n", "  P_T_DEP(cell, stream, 1, acc[0][0]);\n"),
    ("      const float s = td_warp_sum(acc[c][q]);\n", "      P_T_DEP(cell, stream, 2, s);\n"),
    ("n_cells + cell] = s;\n", "      P_T(cell, stream, 3);\n"),
    ("      P_T(cell, stream, 3);\n    }\n", "  P_FLUSH(cell, stream);\n"),
]


def _edited(text: str, edits: dict) -> str:
    for old, new in edits.items():
        text = _replace(text, old, new)
    return text


# Other tilings and cluster sizes of the current P and C, measured beside it.
P_EDITS = {f"tile{t}": {"constexpr int TILE_CELLS = 32;": f"constexpr int TILE_CELLS = {t};"} for t in (8, 16)}
P_EDITS["threads256"] = {"constexpr int THREADS = 512;": "constexpr int THREADS = 256;",
                         "__launch_bounds__(THREADS, 2) cell_sums_kernel": "__launch_bounds__(THREADS) cell_sums_kernel"}
P_EDITS["threads256_tile16"] = {**P_EDITS["threads256"], **P_EDITS["tile16"]}
C_EDITS = {f"cluster{c}": {"constexpr int MAX_CLUSTER = 8;": f"constexpr int MAX_CLUSTER = {c};"}
           for c in (1, 2, 4)}


def _with_edits(variants, edits: dict) -> list:
    """The variants, then the current sources under each of ``edits``."""
    out = [(name, csrc, {}) for name, csrc in variants]
    current = dict(variants).get("current")
    return out + [(f"current_{k}", current, e) for k, e in edits.items()] if current else out


def _cell_sums_source(csrc: str, edits: dict | None = None) -> tuple[str, list]:
    text = _edited(open(os.path.join(csrc, "cell_sums.cu")).read(), edits or {})
    anchors, phases = ((P_ANCHORS, P_PHASES) if P_ANCHORS and P_ANCHORS[0][0] in text
                       else (P_PARENT_ANCHORS, P_PARENT_PHASES))
    for old, add in anchors:
        text = _insert(text, old, add)
    return '#include "stamps.cuh"\n' + text + P_HOST, phases


def _live_p_args(smoke):
    """Kernel P's arguments on the live frame of chip_smoke.py's phase 3."""
    from trackdlo_tpu_torch.ops.preprocess import default_cell_px

    p, intr = smoke.params, smoke.intr
    leaf = p.downsample_leaf_size
    cell = default_cell_px(leaf, intr.fx)
    rgb, depth, occ = smoke.frame(1 / 15.0)
    return (*smoke.to_dev(rgb, depth, occ), intr.fx, intr.fy, intr.cx, intr.cy, p.hsv_lower,
            p.hsv_upper, p.multi_color_dlo, cell, leaf)


def kernel_p(torch, variants) -> dict:
    """Kernel P (parity mode) on the live frame of chip_smoke.py's phase 3:
    per variant (and the current sources at 8 and 16 cells a strip and
    with 256 threads a block), the
    cycles by phase of the warp of the fullest cell and of an empty cell
    (its lane 0), and the launch's time by CUDA events and the profiler."""
    import chip_smoke
    from trackdlo_tpu_torch import _build as tb
    from trackdlo_tpu_torch.ops.preprocess import cell_sums_plain, floor_key_constants
    from trackdlo_tpu_torch.ops.preprocess_kernel import _bands_tensor, parity_grid_shape

    smoke = chip_smoke.Smoke()
    args = _live_p_args(smoke)
    rgb, depth, occ, fx, fy, cx, cy, lo, hi, multi, cell, leaf = args
    h, w = depth.shape
    n_rows, n_cols = parity_grid_shape(h, w, cell)
    ref = cell_sums_plain(*args)
    per_cell = ref[3].sum(0)
    occupied = int(per_cell.argmax())
    # An empty cell in the occupied cell's cell row, so that in a design
    # with a block per strip both share the strip's load.
    row = occupied // n_cols
    empty = row * n_cols + int((per_cell[row * n_cols:(row + 1) * n_cols] == 0).nonzero()[0])
    bands = _bands_tensor(lo, hi, multi, smoke.dev)
    k = floor_key_constants(fx, fy, leaf)
    out = {"occupied_cell": occupied, "occupied_pixels": int(per_cell[occupied]), "empty_cell": empty,
           "cells": n_rows * n_cols, "occupied_cells": int((per_cell > 0).sum())}
    for name, csrc, edits in _with_edits(variants, P_EDITS):
        source, phases = _cell_sums_source(csrc, edits)
        lib = _build(f"cell_sums_{name}", csrc, _headers(csrc), "cell_sums.cu", source, P_STAMPS)
        fn = lib.trackdlo_cell_sums
        fn.argtypes, fn.restype = tb.SIGNATURES["trackdlo_cell_sums"], ctypes.c_int
        res = torch.empty((4, 8, n_rows * n_cols), device=smoke.dev)

        def run():
            code = fn(rgb.data_ptr(), depth.data_ptr(), occ.data_ptr(), 1, h, w, cell, bands.data_ptr(),
                      bands.numel() // 6, fx, fy, cx, cy, k["kx"], k["ky"], k["k_zq"], k["kz"],
                      int(k["z_from_mm"]), 0, res.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"{name}: launch failed with cudaError_t {code}")

        run()
        torch.cuda.synchronize()
        if lib.p_stamps_set(occupied, empty) != 0:
            raise RuntimeError("p_stamps_set failed")
        run()
        torch.cuda.synchronize()
        acc = (ctypes.c_longlong * 16)()
        if lib.p_stamps_read(acc) != 0:
            raise RuntimeError("p_stamps_read failed")
        rec = {"ms": _events_ms(torch, run, 200), "device_ms": _device_ms(torch, run, 100, "cell_sums"),
               "counts_equal_plain": bool(torch.equal(res[3], ref[3]))}
        for i, kind in enumerate(("occupied", "empty")):
            rec[kind] = {**{ph: acc[8 * i + j] for j, ph in enumerate(phases)}, "total": acc[8 * i + 7]}
        out[name] = rec
        print(f"P {name:10s} occupied cell {occupied} ({out['occupied_pixels']} px) {rec['occupied']}; "
              f"empty cell {empty} {rec['empty']}; {rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms; "
              f"counts equal the plain version's "
              f"{rec['counts_equal_plain']}", flush=True)
    return out


# C: thread 0 of one block (c_stamp_block) stamps each chunk's phases.
C_STAMPS = r'''
#pragma once
__device__ long long c_acc[8];
__device__ int c_stamp_block;
#define C_ON() (blockIdx.x == c_stamp_block && threadIdx.x == 0)
#define C_DECL() long long _c_acc[6] = {0, 0, 0, 0, 0, 0}; long long _c_prev = clock64(), _c_start = _c_prev; \
  int _c_chunks = 0
#define C_T(p) do { if (C_ON()) { const long long _t = clock64(); \
  if ((p) > 0) _c_acc[(p) - 1] += _t - _c_prev; else ++_c_chunks; _c_prev = _t; } } while (0)
#define C_FLUSH() do { if (C_ON()) { for (int _i = 0; _i < 6; ++_i) c_acc[_i] = _c_acc[_i]; \
  c_acc[6] = _c_chunks; c_acc[7] = clock64() - _c_start; } } while (0)
'''
C_HOST = r'''
extern "C" int c_stamps_set(int block) { long long z[8] = {0};
  cudaError_t e = cudaMemcpyToSymbol(c_acc, z, sizeof(z));
  return (int)(e != cudaSuccess ? e : cudaMemcpyToSymbol(c_stamp_block, &block, sizeof(block))); }
extern "C" int c_stamps_read(long long* out) { return (int)cudaMemcpyFromSymbol(out, c_acc, sizeof(c_acc)); }
'''
# The design before the redesign: one block per row, chained chunks of 1024
# cells, each a ballot, a scan of the 32 warp totals and the scatter.
C_PARENT_PHASES = ["ballot", "scan of the warp totals", "scatter", "tail"]
C_PARENT_ANCHORS = [
    ("  int base = 0;  // kept cells in earlier chunks; the same in every thread\n", "  C_DECL();\n", False),
    ("start += THREADS) {\n", "    C_T(0);\n", True),
    ("    __syncthreads();\n    if (warp == 0) {\n", "    C_T(1);\n", False),
    ("    __syncthreads();\n    if (k) {\n", "    C_T(2);\n", False),
    ("    __syncthreads();  // the next chunk rewrites warp_off and chunk_total\n", "    C_T(3);\n", True),
    ("    V[r] = 0;\n  }\n", "  C_T(4);\n  C_FLUSH();\n", True),
]


def _compact_source(csrc: str, edits: dict | None = None) -> tuple[str, list, bool]:
    text = _edited(open(os.path.join(csrc, "compact.cu")).read(), edits or {})
    parent = not (C_ANCHORS and C_ANCHORS[0][0] in text)
    anchors, phases = (C_PARENT_ANCHORS, C_PARENT_PHASES) if parent else (C_ANCHORS, C_PHASES)
    for old, add, after in anchors:
        if after:
            text = _insert(text, old, add)
        else:
            # Before the anchor's last line: the stamp follows its barrier.
            head, last = old[:old.rstrip("\n").rfind("\n") + 1], old[old.rstrip("\n").rfind("\n") + 1:]
            text = _replace(text, old, head + add + last)
    return '#include "stamps.cuh"\n' + text + C_HOST, phases, parent


def kernel_c(torch, variants) -> dict:
    """Kernel C on the live frame's cell sums (8 channel rows, 256 slots
    each): per variant (and the current sources with clusters of at most
    1, 2 and 4 CTAs), the cycles by phase of one block (its thread 0),
    summed over its chunks, and the launch's time by CUDA events and the
    profiler. The
    parent takes the kept cells from kept_cells; the current design derives
    them and divides the centroids in its launch."""
    import chip_smoke
    from trackdlo_tpu_torch.ops.preprocess import (
        cell_sums_plain, compact_channels_plain, kept_cells,
    )

    smoke = chip_smoke.Smoke()
    args = _live_p_args(smoke)
    sums = tuple(s.contiguous() for s in cell_sums_plain(*args))
    rows, n_per = sums[3].shape
    cap = smoke.params.candidate_cap() // 8
    kept = kept_cells(sums[3], cap)
    ref = compact_channels_plain(*sums, kept, cap)
    ref_div = (ref[0] / torch.clamp_min(ref[1], 1.0)[..., None], ref[1], ref[2])
    out = {"rows": rows, "n_per": n_per, "cap_per": cap, "occupied": int((sums[3] > 0).sum()),
           "kept": int(kept.sum())}
    for name, csrc, edits in _with_edits(variants, C_EDITS):
        source, phases, parent = _compact_source(csrc, edits)
        lib = _build(f"compact_{name}", csrc, _headers(csrc), "compact.cu", source, C_STAMPS)
        fn = lib.trackdlo_compact
        fn.restype = ctypes.c_int
        pts = torch.empty((rows, cap, 3), device=smoke.dev)
        cnt = torch.empty((rows, cap), device=smoke.dev)
        valid = torch.empty((rows, cap), dtype=torch.bool, device=smoke.dev)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [s.data_ptr() for s in sums]
        outs = [pts.data_ptr(), cnt.data_ptr(), valid.data_ptr()]
        if parent:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
            call = lambda: fn(*ptrs, kept.data_ptr(), rows, n_per, cap, *outs, stream)
            want = ref
        else:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
            call = lambda: fn(*ptrs, None, rows, n_per, cap, 1, *outs, stream)
            want = ref_div

        def run():
            code = call()
            if code != 0:
                raise RuntimeError(f"{name}: launch failed with cudaError_t {code}")

        run()
        torch.cuda.synchronize()
        if lib.c_stamps_set(0) != 0:
            raise RuntimeError("c_stamps_set failed")
        run()
        torch.cuda.synchronize()
        acc = (ctypes.c_longlong * 8)()
        if lib.c_stamps_read(acc) != 0:
            raise RuntimeError("c_stamps_read failed")
        rec = {"ms": _events_ms(torch, run, 200), "device_ms": _device_ms(torch, run, 100, "compact"),
               "chunks": acc[6], "block_cycles": acc[7],
               "cycles": {ph: acc[i] for i, ph in enumerate(phases)},
               "equals_plain": all(bool(torch.equal(a, b)) for a, b in zip((pts, cnt, valid), want))}
        out[name] = rec
        print(f"C {name:10s} block 0: {rec['chunks']} chunks, {rec['block_cycles']} cycles, by phase "
              f"{rec['cycles']}; {rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms; equal to the plain "
              f"version's {rec['equals_plain']}",
              flush=True)
    return out


# F and N: thread 0 of block 0 stamps its phases into registers (R_T) and
# counts chunks and steps (R_COUNT); in F's current design lane 0 of the
# search warp stamps its part of each solve step too (S_T). Everything goes
# to global memory once, at the end.
R_STAMPS = r'''
#pragma once
__device__ long long r_acc[40];
#define R_ON() (blockIdx.x == 0 && threadIdx.x == 0)
#define R_DECL() long long _r_acc[24] = {0}; int _r_cnt[4] = {0, 0, 0, 0}; \
  long long _r_prev = clock64(), _r_start = _r_prev
#define R_T(p) do { if (R_ON()) { const long long _t = clock64(); _r_acc[p] += _t - _r_prev; _r_prev = _t; } } while (0)
#define R_COUNT(i) do { if (R_ON()) ++_r_cnt[i]; } while (0)
#define R_FLUSH() do { if (R_ON()) { _Pragma("unroll") for (int _i = 0; _i < 24; ++_i) r_acc[_i] = _r_acc[_i]; \
  _Pragma("unroll") for (int _i = 0; _i < 4; ++_i) r_acc[24 + _i] = _r_cnt[_i]; \
  r_acc[28] = clock64() - _r_start; } } while (0)
#define S_ON() (blockIdx.x == 0 && threadIdx.x == blockDim.x - 32)
#define S_DECL() long long _s_acc[4] = {0, 0, 0, 0}; long long _s_prev = 0
#define S_START() do { if (S_ON()) _s_prev = clock64(); } while (0)
#define S_T(p) do { if (S_ON()) { const long long _t = clock64(); _s_acc[p] += _t - _s_prev; _s_prev = _t; } } while (0)
#define S_FLUSH() do { if (S_ON()) { _Pragma("unroll") for (int _i = 0; _i < 4; ++_i) r_acc[30 + _i] = _s_acc[_i]; } } while (0)
#define STAMP(p) do {} while (0)
'''
R_HOST = r'''
extern "C" int r_reset() { long long z[40] = {0}; return (int)cudaMemcpyToSymbol(r_acc, z, sizeof(z)); }
extern "C" int r_read(long long* out) { return (int)cudaMemcpyFromSymbol(out, r_acc, sizeof(r_acc)); }
'''
R_COUNTS = 24

# Kernel F before its redesign: one block of 512 threads per stream.
F_PARENT_PHASES = ["load", "minima: point loop", "minima: warp trees and merge", "visibility weights",
                   "E-step chunks", "chunk sums", "Np and trace tree", "system build", "solve: search",
                   "solve: factors", "solve: update", "solve: barriers", "W", "T", "sigma2 and move"]
F_PARENT_COUNTS = ["chunks", "solve steps"]
F_PARENT_ANCHORS = [
    ("  Smem& S = *reinterpret_cast<Smem*>(smem_raw);\n",
     "  Smem& S = *reinterpret_cast<Smem*>(smem_raw);\n  R_DECL();\n"),
    ("  // Phase 0: per-node nearest valid point (only read through the gate).\n",
     "  R_T(0);\n  // Phase 0: per-node nearest valid point (only read through the gate).\n"),
    ("        if (j < m && S.nm[j] > 0.0f) mn[j] = fminf(mn[j], sq_dist(S.y, j, x0, x1, x2));\n    }\n",
     "        if (j < m && S.nm[j] > 0.0f) mn[j] = fminf(mn[j], sq_dist(S.y, j, x0, x1, x2));\n    }\n"
     "    R_T(1);\n"),
    ("  if (tid == 0) {\n    // The visibility prior", "  R_T(2);\n  if (tid == 0) {\n    // The visibility prior"),
    ("  // Phase 1: the E-step, one chunk of points at a time.\n",
     "  R_T(3);\n  // Phase 1: the E-step, one chunk of points at a time.\n"),
    ("    __syncthreads();\n    for (int o = warp; o < m * 4; o += NWARPS) {\n",
     "    __syncthreads();\n    R_T(4);\n    for (int o = warp; o < m * 4; o += NWARPS) {\n"),
    ("    __syncthreads();\n  }\n  S.red[tid] = np_loc;\n",
     "    __syncthreads();\n    R_T(5);\n    R_COUNT(0);\n  }\n  S.red[tid] = np_loc;\n"),
    ("  const float np_total = S.red[0], tr_x = S.red2[0];\n",
     "  const float np_total = S.red[0], tr_x = S.red2[0];\n  R_T(6);\n"),
    ("  for (int k = tid; k < m; k += THREADS) S.used[k] = 0.0f;\n  __syncthreads();\n",
     "  for (int k = tid; k < m; k += THREADS) S.used[k] = 0.0f;\n  __syncthreads();\n  R_T(7);\n"),
    ("    __syncthreads();\n    const int ridx = S.ridx;\n",
     "    R_T(8);\n    __syncthreads();\n    R_T(11);\n    const int ridx = S.ridx;\n"),
    ("S.aug[tid * width + k] / pv_safe;\n    __syncthreads();\n",
     "S.aug[tid * width + k] / pv_safe;\n    R_T(9);\n    __syncthreads();\n    R_T(11);\n"),
    ("      S.diag[k] = pv;\n    }\n    __syncthreads();\n  }\n",
     "      S.diag[k] = pv;\n    }\n    R_T(10);\n    __syncthreads();\n    R_T(11);\n    R_COUNT(1);\n  }\n"),
    ("    S.w[q] = S.aug[S.perm[k] * width + m + d] / dg;\n  }\n  __syncthreads();\n",
     "    S.w[q] = S.aug[S.perm[k] * width + m + d] / dg;\n  }\n  __syncthreads();\n  R_T(12);\n"),
    ("    A.t[m3 + q] = tv;\n  }\n  __syncthreads();\n",
     "    A.t[m3 + q] = tv;\n  }\n  __syncthreads();\n  R_T(13);\n"),
    ("    A.stats[(size_t)s * 2 + 1] = move / fmaxf(v_count_f, 1.0f);\n  }\n",
     "    A.stats[(size_t)s * 2 + 1] = move / fmaxf(v_count_f, 1.0f);\n  }\n  R_T(14);\n  R_FLUSH();\n"),
]

# Kernel F now: one cluster per stream, CTA 0 alone solving; thread 0 is
# row 0's first update thread in the solve, lane 0 of the last warp the
# search warp's.
F_PHASES = ["load and compaction", "minima and visibility weights", "E-step and sums",
            "push and cluster barrier", "totals and the M-step inputs' wait", "system build",
            "solve: first pivot", "solve: factor", "solve: update", "solve: barrier", "W", "T",
            "sigma2 and move"]
F_COUNTS = ["solve steps"]
F_SEARCH_PHASES = ["column k + 1", "pick", "publish"]
F_ANCHORS = [
    ("  td::EstepSmem<THREADS>& E = S.es;\n", "  td::EstepSmem<THREADS>& E = S.es;\n  R_DECL();\n  S_DECL();\n"),
    ("                                  min(n, r0 + rows), E);  // ends in a barrier\n",
     "                                  min(n, r0 + rows), E);  // ends in a barrier\n  R_T(0);\n"),
    ("    td::ec_visibility_weights(m, A.k_vis, A.tau_vis, E);\n  }\n",
     "    td::ec_visibility_weights(m, A.k_vis, A.tau_vis, E);\n  }\n  R_T(1);\n"),
    ("  td::ec_estep_partials<false, true>(sc, npts, 1, E);\n",
     "  td::ec_estep_partials<false, true>(sc, npts, 1, E);\n  R_T(2);\n"),
    ("  if (rank != 0) return;\n", "  if (rank != 0) return;\n  R_T(3);\n"),
    ("  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n",
     "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n  R_T(4);\n"),
    ("    S.aug[r * width + col] = v;\n  }\n  __syncthreads();\n",
     "    S.aug[r * width + col] = v;\n  }\n  __syncthreads();\n  R_T(5);\n"),
    ("      S.diag[0] = pv;\n    }\n  }\n  __syncthreads();\n",
     "      S.diag[0] = pv;\n    }\n  }\n  __syncthreads();\n  R_T(6);\n"),
    ("  for (int k = 0; k < m; ++k) {\n    const int p = S.piv_row[k & 1];\n",
     "  for (int k = 0; k < m; ++k) {\n    S_START();\n    const int p = S.piv_row[k & 1];\n"),
    ("      col[1] = nxt[1];\n", "      col[1] = nxt[1];\n      S_T(0);\n"),
    ("        const int ridx = f_pick(m, used, col, pvn);\n",
     "        const int ridx = f_pick(m, used, col, pvn);\n        S_T(1);\n"),
    ("          S.diag[k + 1] = pvn;\n        }\n      }\n",
     "          S.diag[k + 1] = pvn;\n        }\n      }\n      S_T(2);\n"),
    ("      const float f = row[k] / pv_safe;\n", "      const float f = row[k] / pv_safe;\n      R_T(7);\n"),
    ("cc += per_row) row[cc] = row[cc] - f * prow[cc];\n    }\n    __syncthreads();\n  }\n",
     "cc += per_row) row[cc] = row[cc] - f * prow[cc];\n      R_T(8);\n    }\n    __syncthreads();\n"
     "    R_T(9);\n    R_COUNT(0);\n  }\n"),
    ("    S.w[q] = S.aug[S.perm[k] * width + m + d] / dg;\n  }\n  __syncthreads();\n",
     "    S.w[q] = S.aug[S.perm[k] * width + m + d] / dg;\n  }\n  __syncthreads();\n  R_T(10);\n"),
    ("    A.t[m3 + q] = tv;\n  }\n  __syncthreads();\n", "    A.t[m3 + q] = tv;\n  }\n  __syncthreads();\n  R_T(11);\n"),
    ("      A.stats[(size_t)s * 2 + 1] = move / fmaxf(v_count_f, 1.0f);\n    }\n  }\n",
     "      A.stats[(size_t)s * 2 + 1] = move / fmaxf(v_count_f, 1.0f);\n    }\n  }\n  R_T(12);\n"
     "  R_FLUSH();\n  S_FLUSH();\n"),
]

# Kernel N before its redesign: per-thread minima of every node, 48 warp trees.
N_PARENT_PHASES = ["load", "point loop", "warp trees", "merge and store"]
N_PARENT_ANCHORS = [
    ("  __shared__ float ys[MMAX * 3], nms[MMAX], wmin[NWARPS * MMAX];\n",
     "  __shared__ float ys[MMAX * 3], nms[MMAX], wmin[NWARPS * MMAX];\n  R_DECL();\n"),
    ("  __syncthreads();\n\n  const float* xs", "  __syncthreads();\n  R_T(0);\n\n  const float* xs"),
    ("        mn[j] = fminf(mn[j], d0 * d0 + d1 * d1 + d2 * d2);\n      }\n    }\n  }\n",
     "        mn[j] = fminf(mn[j], d0 * d0 + d1 * d1 + d2 * d2);\n      }\n    }\n  }\n  R_T(1);\n"),
    ("      if (lane == 0) wmin[warp * MMAX + j] = v;\n    }\n  }\n",
     "      if (lane == 0) wmin[warp * MMAX + j] = v;\n    }\n  }\n  R_T(2);\n"),
    ("    out[(size_t)s * m + tid] = v;\n  }\n", "    out[(size_t)s * m + tid] = v;\n  }\n  R_T(3);\n  R_FLUSH();\n"),
]

# Kernel N now: the valid rows compacted, one thread per (node, slice).
N_PHASES = ["load", "compaction", "slices", "barrier", "merge and store"]
N_ANCHORS = [
    ("  const float* xs_g = x + (size_t)s * n * 3;\n",
     "  R_DECL();\n  const float* xs_g = x + (size_t)s * n * 3;\n  R_T(0);\n"),
    ("      count += seg_total;\n      __syncthreads();\n    }\n",
     "      count += seg_total;\n      __syncthreads();\n    }\n    R_T(1);\n"),
    ("        best = fminf(best, d0 * d0 + d1 * d1 + d2 * d2);\n      }\n    }\n",
     "        best = fminf(best, d0 * d0 + d1 * d1 + d2 * d2);\n      }\n    }\n    R_T(2);\n"),
    ("    __syncthreads();  // the next tile rewrites xs\n  }\n",
     "    __syncthreads();  // the next tile rewrites xs\n    R_T(3);\n  }\n"),
    ("    out[(size_t)s * m + tid] = v;\n  }\n", "    out[(size_t)s * m + tid] = v;\n  }\n  R_T(4);\n  R_FLUSH();\n"),
]


def _r_source(csrc: str, name: str, designs: list) -> tuple[str, str]:
    """``name`` from ``csrc`` with the anchors of whichever design it holds
    (the first of ``designs`` whose first anchor it contains): the stamped
    source and the design's key."""
    text = open(os.path.join(csrc, name)).read()
    key, anchors = next((k, a) for k, a in designs if a and a[0][0] in text)
    for old, new in anchors:
        text = _replace(text, old, new)
    return '#include "stamps.cuh"\n' + text + R_HOST, key


def _raw_headers(csrc: str) -> dict:
    return {h: open(os.path.join(csrc, h)).read() for h in os.listdir(csrc) if h.endswith(".cuh")}


def _r_read(lib) -> list:
    acc = (ctypes.c_longlong * 40)()
    if lib.r_read(acc) != 0:
        raise RuntimeError("r_read failed")
    return list(acc)


def _f_inputs(torch, smoke):
    """One iteration of kernel F at chip_smoke.py's main-pass configuration
    (max_iter 10, tol 0, the gate on) on its phase-3 cloud, from the EM
    origin: (staging, params)."""
    from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, em_staging

    smoke.check_preprocess()
    p, m, dev = smoke.params, smoke.params.M, smoke.dev
    nodes = torch.as_tensor(smoke.rope.nodes(0.0, m), dtype=torch.float32, device=dev)
    one = lambda a: a[None]
    params = CpdParams(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=10, tol=0.0,
                       include_lle=False, k_vis=p.k_vis, visibility_threshold=p.visibility_threshold,
                       use_visibility=True, use_fused_mstep=True)
    st = em_staging(one(smoke.cloud.points), one(smoke.cloud.mask), one(nodes),
                    one(torch.ones(m, dtype=torch.bool, device=dev)), one(torch.tensor(0.001, device=dev)),
                    params, visible_count=one(torch.tensor(30, device=dev)))
    return st, params


def kernel_f(torch, variants) -> dict:
    """Kernel F, one iteration of the main-pass configuration with the gate
    on (chip_smoke.py's phase-3 cloud, one stream): per variant the cycles
    by phase of thread 0 of block 0 (and of the search warp's lane 0 where
    the solve searches a step ahead), the launch's time by CUDA events and
    the profiler, and its outputs' distance from the plain version's."""
    import chip_smoke
    from trackdlo_tpu_torch import _build as tb
    from trackdlo_tpu_torch.ops.cpd_lle import fused_iteration
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_iteration_plain

    smoke = chip_smoke.Smoke()
    st, params = _f_inputs(torch, smoke)
    dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm = st.args
    s2 = dyn[:, 0].contiguous()
    kw = st.kwargs
    m, n = y0.shape[1], x.shape[1]
    ref = fused_iteration(st, y0, s2, params, fused_em_iteration_plain)
    out = {"points": int(st.n_count[0]), "rows": n, "gate": float(dyn[0, 3])}
    designs = [("current", F_ANCHORS), ("parent", F_PARENT_ANCHORS)]
    for name, csrc in variants:
        source, design = _r_source(csrc, "em_iter.cu", designs)
        lib = _build(f"em_iter_{name}", csrc, _raw_headers(csrc), "em_iter.cu", source, R_STAMPS)
        fn = lib.trackdlo_em_iter
        fn.restype = ctypes.c_int
        t = torch.empty((1, m, 3), device=smoke.dev)
        stats = torch.empty((1, 2), device=smoke.dev)
        stream = torch.cuda.current_stream().cuda_stream
        fl = [kw["k_vis"], kw["tau_vis"], kw["lam"], kw["coef_lle"], kw["alpha"]]
        if design == "parent":
            c_base = (2 * np.pi * s2) ** 1.5 * params.mu / (1 - params.mu)  # as fused_iteration
            scal = torch.stack([s2, c_base * dyn[:, 1] / dyn[:, 2], c_base / dyn[:, 2], dyn[:, 3],
                                dyn[:, 1]], dim=1).contiguous()
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 3
            ptrs = [scal.data_ptr()] + [a.data_ptr() for a in (y0, y0, coord, nm, g, hg, hy0, jg, pd, x, xm)]
            call = lambda: fn(*ptrs, 1, m, n, *fl, t.data_ptr(), stats.data_ptr(), stream)
        else:
            fn.argtypes = tb.SIGNATURES["trackdlo_em_iter"]
            ptrs = [a.data_ptr() for a in (y0, y0, coord, nm, g, hg, hy0, jg, pd, x, xm)]
            call = lambda: fn(s2.data_ptr(), 1, dyn.data_ptr(), None, *ptrs, 1, m, n, kw["muf"], *fl,
                              t.data_ptr(), stats.data_ptr(), stream)

        def run():
            code = call()
            if code != 0:
                raise RuntimeError(f"{name}: launch failed with cudaError_t {code}")

        run()
        torch.cuda.synchronize()
        if lib.r_reset() != 0:
            raise RuntimeError("r_reset failed")
        run()
        torch.cuda.synchronize()
        acc = _r_read(lib)
        phases, counts = ((F_PARENT_PHASES, F_PARENT_COUNTS) if design == "parent" else (F_PHASES, F_COUNTS))
        rec = {"design": design, "ms": _events_ms(torch, run, 200),
               "device_ms": _device_ms(torch, run, 100, "em_iter"), "block0_cycles": acc[28],
               "cycles": {ph: acc[i] for i, ph in enumerate(phases)},
               "counts": {c: acc[R_COUNTS + i] for i, c in enumerate(counts)},
               "t_max_abs_vs_plain_m": float((t - ref[0]).abs().max()),
               "sigma2_vs_plain": float((stats[:, 0] - ref[1]).abs().max()),
               "delta_vs_plain": float((stats[:, 1] - ref[2]).abs().max())}
        if design != "parent":
            rec["search_warp_cycles"] = {ph: acc[30 + i] for i, ph in enumerate(F_SEARCH_PHASES)}
        out[name] = rec
        print(f"F {name:10s} ({design}) {rec['block0_cycles']} cycles: {rec['cycles']} {rec['counts']} "
              f"{rec.get('search_warp_cycles', '')}; {rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms; "
              f"t {rec['t_max_abs_vs_plain_m']!r} m from the plain version's", flush=True)
    return out


def kernel_n(torch, variants) -> dict:
    """Kernel N on the route's inputs: the live nodes against the first
    1024 rows of chip_smoke.py's phase-3 cloud (a rank's shard of two), the
    masks float32 as em_staging gives them: per variant the cycles by phase
    of thread 0 of block 0, the launch's time by CUDA events and the
    profiler, and bit-equality with the plain version."""
    import chip_smoke
    from trackdlo_tpu_torch import _build as tb
    from trackdlo_tpu_torch.ops.hopper_kernels import nearest_point_sq_plain

    smoke = chip_smoke.Smoke()
    smoke.check_preprocess()
    m, dev = smoke.params.M, smoke.dev
    y = torch.as_tensor(smoke.rope.nodes(0.0, m), dtype=torch.float32, device=dev)[None].contiguous()
    half = smoke.cloud.points.shape[0] // 2
    x = smoke.cloud.points[None, :half].contiguous()
    xm = smoke.cloud.mask[None, :half].to(torch.float32).contiguous()
    nm = torch.ones((1, m), device=dev)
    ref = nearest_point_sq_plain(y, nm, x, xm)
    out = {"rows": half, "points": int(xm.sum()), "nodes": m}
    designs = [("current", N_ANCHORS), ("parent", N_PARENT_ANCHORS)]
    for name, csrc in variants:
        source, design = _r_source(csrc, "nearest.cu", designs)
        lib = _build(f"nearest_{name}", csrc, _raw_headers(csrc), "nearest.cu", source, R_STAMPS)
        fn = lib.trackdlo_nearest
        fn.restype = ctypes.c_int
        res = torch.empty((1, m), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() for a in (y, nm, x, xm)]
        if design == "parent":
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
            call = lambda: fn(*ptrs, 1, m, half, res.data_ptr(), stream)
        else:
            fn.argtypes = tb.SIGNATURES["trackdlo_nearest"]
            call = lambda: fn(*ptrs, 1, m, half, 0, 0, res.data_ptr(), stream)

        def run():
            code = call()
            if code != 0:
                raise RuntimeError(f"{name}: launch failed with cudaError_t {code}")

        run()
        torch.cuda.synchronize()
        if lib.r_reset() != 0:
            raise RuntimeError("r_reset failed")
        run()
        torch.cuda.synchronize()
        acc = _r_read(lib)
        phases = N_PARENT_PHASES if design == "parent" else N_PHASES
        rec = {"design": design, "ms": _events_ms(torch, run, 200),
               "device_ms": _device_ms(torch, run, 100, "nearest"), "block0_cycles": acc[28],
               "cycles": {ph: acc[i] for i, ph in enumerate(phases)},
               "equals_plain": bool(torch.equal(res, ref))}
        out[name] = rec
        print(f"N {name:10s} ({design}) {rec['block0_cycles']} cycles: {rec['cycles']}; {rec['ms']:.4f} ms, "
              f"device {rec['device_ms']:.4f} ms; equal to the plain version's {rec['equals_plain']}",
              flush=True)
    return out


def _insert(text: str, anchor: str, add: str, after: bool = True) -> str:
    return _replace(text, anchor, anchor + add if after else add + anchor)


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"anchor not found in the sources: {old!r}")
    return text.replace(old, new, 1)


def _headers(csrc: str) -> dict:
    """The headers, with the cluster E-step's pass boundaries and the solve's
    pivot steps stamped."""
    out = {}
    for name in os.listdir(csrc):
        if not name.endswith(".cuh"):
            continue
        text = open(os.path.join(csrc, name)).read()
        if name == "estep_cluster.cuh":
            text = _replace(text, "    __syncthreads();\n    const int cnt = min(PASS, npts - base);\n",
                            "    __syncthreads();\n    STAMP(1);\n    const int cnt = min(PASS, npts - base);\n")
            text = _replace(text, "    __syncthreads();\n  }\n  if (tid < 4 * m + 2) E.part[buf][tid] = acc;",
                            "    __syncthreads();\n    STAMP(2);\n  }\n  if (tid < 4 * m + 2) E.part[buf][tid] = acc;")
        if name == "gj.cuh":
            text = _stamp_gj(text)
        out[name] = text
    return out


def _em_loop_source(csrc: str) -> str:
    text = '#include "stamps.cuh"\n' + open(os.path.join(csrc, "em_loop.cu")).read()
    text = _insert(text, "  while (!S.done && S.it < A.max_iter) {\n", "    STAMP_START();\n")
    text = _insert(text, "      td::ec_visibility_weights(m, A.k_vis, A.tau_vis, E);\n    }\n", "    STAMP(0);\n")
    text = _insert(text, "    td::ec_cluster_totals(m, buf, E, cluster);\n", "    STAMP(6);\n")
    text = _insert(text, "    for (int q = tid; q < m * 3; q += THREADS) E.y[q] = S.t[q];\n    __syncthreads();\n",
                   "    STAMP(5);\n")
    text = _insert(text, "    td::gj_solve<", "    STAMP(3);\n", after=False)
    call = text.index("    td::gj_solve<")
    end = text.index(");\n", call) + 3
    text = text[:end] + "    STAMP(4);\n" + text[end:]
    return text + E_HOST + GJ_HOST


def _gj_source(csrc: str, threads: int | None) -> str:
    text = open(os.path.join(csrc, "gj_solve.cu")).read()
    if threads is not None:
        old = next(f"constexpr int THREADS = {t};" for t in (256, 512) if f"constexpr int THREADS = {t};" in text)
        text = text.replace(old, f"constexpr int THREADS = {threads};")
    call = next(line for line in text.splitlines(True) if "td::gj_solve<THREADS" in line)
    text = _insert(text, call, "  STAMP(1);\n")
    text = _insert(text, call, "  STAMP(0);\n", after=False)
    return '#include "stamps.cuh"\n' + text + G_HOST + GJ_HOST


def _build(name: str, csrc: str, headers: dict, source_name: str, source: str, stamps: str) -> ctypes.CDLL:
    d = os.path.join(OUT_DIR, name)
    os.makedirs(d, exist_ok=True)
    for h, text in {**headers, "stamps.cuh": stamps}.items():
        with open(os.path.join(d, h), "w") as f:
            f.write(text)
    with open(os.path.join(d, source_name), "w") as f:
        f.write(source)
    so = os.path.join(d, "lib.so")
    r = subprocess.run([*NVCC, f"-I{d}", "-o", so, os.path.join(d, source_name)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(so)


def _events_ms(torch, fn, n):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _device_ms(torch, fn, n, name):
    """The device time of one call of ``fn``: its kernels whose names hold
    ``name``, from a torch.profiler trace of ``n`` calls after one warm-up
    call (ctypes calls are host-bound, so events read the host)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / n if ev else None


def kernel_e(torch, variants) -> dict:
    import chip_smoke
    from trackdlo_tpu_torch import _build as tb
    from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, em_staging

    smoke = chip_smoke.Smoke()
    smoke.check_preprocess()
    p, m, dev = smoke.params, smoke.params.M, smoke.dev
    nodes = torch.as_tensor(smoke.rope.nodes(0.0, m), dtype=torch.float32, device=dev)
    st = em_staging(smoke.cloud.points, smoke.cloud.mask, nodes, torch.ones(m, dtype=torch.bool, device=dev),
                    torch.tensor(p.sigma2_init, device=dev),
                    CpdParams(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=10, tol=0.0,
                              include_lle=False, k_vis=p.k_vis, visibility_threshold=p.visibility_threshold,
                              use_visibility=True), visible_count=torch.tensor(30, device=dev))
    kw = st.kwargs
    out, ys = {}, {}
    for name, csrc in variants:
        lib = _build(f"em_loop_{name}", csrc, _headers(csrc), "em_loop.cu", _em_loop_source(csrc),
                     E_STAMPS)
        fn = lib.trackdlo_em_loop
        fn.argtypes, fn.restype = tb.SIGNATURES["trackdlo_em_loop"], ctypes.c_int
        y_out, stats = torch.empty((m, 3), device=dev), torch.empty(4, device=dev)

        def run():
            code = fn(*(t.data_ptr() for t in st.args), m, st.args[9].shape[0], kw["muf"], kw["k_vis"],
                      kw["tau_vis"], kw["lam"], kw["coef_lle"], kw["alpha"], kw["tol"], kw["max_iter"],
                      y_out.data_ptr(), stats.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"{name}: launch failed with cudaError_t {code}")

        run()
        torch.cuda.synchronize()
        if lib.stamps_reset() != 0 or lib.gj_reset() != 0:
            raise RuntimeError("stamps_reset failed")
        run()
        torch.cuda.synchronize()
        acc = (ctypes.c_longlong * 8)()
        if lib.stamps_read(acc) != 0:
            raise RuntimeError("stamps_read failed")
        iters = int(stats[1])
        ys[name] = y_out.clone()
        solve = _gj_record(lib)
        out[name] = {"ms_10_iterations": _events_ms(torch, run, 20), "iterations": iters,
                     "cycles_per_iteration": {E_PHASES[i]: acc[i] / iters for i in range(7)},
                     "solve_steps": solve,
                     "max_abs_vs_first_variant_m": float((ys[name] - next(iter(ys.values()))).abs().max())}
        print(f"E {name:14s} {out[name]['ms_10_iterations']:.4f} ms per 10 iterations; cycles per iteration "
              f"{ {k: round(v) for k, v in out[name]['cycles_per_iteration'].items()} }; solve "
              f"{_rounded(out[name]['solve_steps'])}", flush=True)
    return out


def _rounded(rec: dict) -> dict:
    return {k: _rounded(v) if isinstance(v, dict) else round(v) for k, v in rec.items()}


def kernel_g(torch, variants) -> dict:
    dev = torch.device("cuda")
    saved = np.load(os.path.join(ROOT, "tests", "data", "gj_prereg_system.npz"))
    pins = np.load(os.path.join(ROOT, "tests", "data", "exact_products_bits.npz"))
    systems = {"live_prereg_8x45": (np.broadcast_to(saved["a"], (8, 45, 45)), np.broadcast_to(saved["b"], (8, 45, 3)))}
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 48, 48)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + 48 * np.eye(48, dtype=np.float32)
    b = rng.standard_normal((8, 48, 3)).astype(np.float32)
    systems["spd_16x48"] = (np.concatenate([a, a]), np.concatenate([b, b]))
    out = {}
    for name, csrc, threads in variants:
        lib = _build(f"gj_{name}", csrc, _headers(csrc), "gj_solve.cu", _gj_source(csrc, threads), G_STAMPS)
        lib.trackdlo_gj_solve.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        lib.trackdlo_gj_solve.restype = ctypes.c_int
        rec = {}
        for key, (a_np, b_np) in systems.items():
            at = torch.from_numpy(np.ascontiguousarray(a_np)).to(dev)
            bt = torch.from_numpy(np.ascontiguousarray(b_np)).to(dev)
            w = torch.empty((at.shape[0], at.shape[1], 3), device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            call = lambda: lib.trackdlo_gj_solve(at.data_ptr(), bt.data_ptr(), at.shape[0], at.shape[1],
                                                 w.data_ptr(), stream)
            ms = _events_ms(torch, call, 200)
            if lib.gj_reset() != 0 or call() != 0:
                raise RuntimeError("gj_reset or the stamped launch failed")
            torch.cuda.synchronize()
            st = (ctypes.c_longlong * 2)()
            if lib.stamps_read(st) != 0:
                raise RuntimeError("stamps_read failed")
            rec[key] = {"solve_cycles": st[1] - st[0], "cycles_per_pivot_step": (st[1] - st[0]) / at.shape[1],
                        "ms": ms, "steps": _gj_record(lib)}
            if key.startswith("live"):
                got = w[0].cpu().numpy()
                rec[key]["equals_saved_solution"] = {
                    "float32 residual (gj_prereg_system.npz)": bool(np.array_equal(got, saved["w_kernel"])),
                    "exact residual (exact_products_bits.npz)": bool(np.array_equal(got, pins["gj_saved_live"]))}
        out[name] = rec
        print(f"G {name:14s} {rec}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to stamp beside the current sources")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                    help="another tree to stamp beside them (repeatable)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "em_phase_stamps.json"))
    ap.add_argument("--only", default="e,g,w,p,c,f,n",
                    help="comma list of the kernels to stamp: e, g, w, p, c, f, n")
    args = ap.parse_args()
    only = set(args.only.split(","))
    import torch

    if not torch.cuda.is_available():
        print("em_phase_stamps: CUDA is not available", file=sys.stderr)
        return 2
    csrc = os.path.join(ROOT, "trackdlo_tpu_torch", "csrc")
    parent = os.path.join(args.parent, "trackdlo_tpu_torch", "csrc") if args.parent else None
    extra = [(name, os.path.join(d, "trackdlo_tpu_torch", "csrc"))
             for name, d in (v.split("=", 1) for v in args.variant)]
    e_variants = ([("parent", parent)] if parent else []) + [("current", csrc)] + extra
    g_variants = ([("parent", parent, None)] if parent else []) + [
        ("current", csrc, None), ("current_256", csrc, 256)] + [(n, d, None) for n, d in extra]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    record = {"card": card}
    if "e" in only:
        record["kernel_e"] = kernel_e(torch, e_variants)
    if "g" in only:
        record["kernel_g"] = kernel_g(torch, g_variants)
    if "w" in only:
        record["kernel_w"] = kernel_w(torch, e_variants)
    if "p" in only:
        record["kernel_p"] = kernel_p(torch, e_variants)
    if "c" in only:
        record["kernel_c"] = kernel_c(torch, e_variants)
    if "f" in only:
        record["kernel_f"] = kernel_f(torch, e_variants)
    if "n" in only:
        record["kernel_n"] = kernel_n(torch, e_variants)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
