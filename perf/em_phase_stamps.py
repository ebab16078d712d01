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
  live steps, and the launch's time by CUDA events. ``--only`` picks the
  kernels (e, g, w).
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
    ap.add_argument("--only", default="e,g,w", help="comma list of the kernels to stamp: e, g, w")
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
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
