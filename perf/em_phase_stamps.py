"""Where kernel E's iteration and kernel G's solve spend their cycles, from
clock64() stamps in instrumented builds of the port's CUDA sources.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python3 perf/em_phase_stamps.py [--parent DIR]

The instrumented sources are generated from ``trackdlo_tpu_torch/csrc`` (and
from ``DIR/trackdlo_tpu_torch/csrc``, an unpacked earlier tree, for the
``parent`` variants) into ``build/em_phase_stamps/``; nothing instrumented is
part of the package. Thread 0 of the first CTA stamps the phase boundaries,
so the cycles are those of one SM's clock.

- Kernel E: 10 iterations (tol 0) of the main pass's configuration with the
  gate on, on the live cloud of ``chip_smoke.py`` (frame 1, 2048 rows);
  cycles per iteration by phase, and the launch's time by CUDA events.
  Variants: the current sources, four lanes per point raised to eight, and
  the pivot search as a shuffle tree instead of two warp reductions.
- Kernel G: one solve of the live pre-registration system saved in
  ``tests/data/gj_prereg_system.npz`` (8 copies) and of the (16, 48, 48) SPD
  systems of ``chip_smoke.py``, cycles of block 0 and CUDA events; each
  variant's solution bit for bit against the saved one.

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT_DIR = os.path.join(ROOT, "build", "em_phase_stamps")
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-fmad=false", "-Xcompiler", "-fPIC", "-shared"]

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

REDUX_PIVOT = '''    unsigned key = 0u;
    int row = m;
    for (int r = lane; r < m; r += 32) {
      const unsigned kr = gj_pivot_key(G.aug[r * width + k], (used >> r) & 1ull);
      if (kr > key) {
        key = kr;
        row = r;
      }
    }
    const unsigned best = __reduce_max_sync(TD_FULL_MASK, key);
    const int ridx =
        best == 0u ? m : (int)__reduce_min_sync(TD_FULL_MASK, key == best ? (unsigned)row : ~0u);
'''
SHUFFLE_PIVOT = '''    float bv = -2.0f;
    int br = m;
    for (int r = lane; r < m; r += 32) {
      const float cand = ((used >> r) & 1ull) ? -1.0f : fabsf(G.aug[r * width + k]);
      if (cand > bv) {
        bv = cand;
        br = r;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(TD_FULL_MASK, bv, off);
      const int orow = __shfl_xor_sync(TD_FULL_MASK, br, off);
      if (ov > bv || (ov == bv && orow < br)) {
        bv = ov;
        br = orow;
      }
    }
    const int ridx = br;
'''


def _insert(text: str, anchor: str, add: str, after: bool = True) -> str:
    return _replace(text, anchor, anchor + add if after else add + anchor)


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"anchor not found in the sources: {old!r}")
    return text.replace(old, new, 1)


def _headers(csrc: str, variant: str) -> dict:
    """The variant's headers, with the cluster E-step's pass boundaries stamped."""
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
            if variant == "lanes8":
                text = _replace(text, "constexpr int EC_LANES = 4;", "constexpr int EC_LANES = 8;")
        if name == "gj.cuh" and variant == "pivot_shuffle":
            text = _replace(text, REDUX_PIVOT, SHUFFLE_PIVOT)
        out[name] = text
    return out


def _em_loop_source(csrc: str, parent: bool) -> str:
    text = '#include "stamps.cuh"\n' + open(os.path.join(csrc, "em_loop.cu")).read()
    text = _insert(text, "  while (!S.done && S.it < A.max_iter) {\n", "    STAMP_START();\n")
    if parent:  # one CTA, points in chunks of 512
        text = _insert(text, "    float np_loc = 0.0f, trx_loc = 0.0f;\n    __syncthreads();\n", "    STAMP(0);\n")
        text = _insert(text, "      __syncthreads();\n      // P1 and PX over the chunk: one warp per (node, quantity).\n",
                       "      STAMP(1);\n")
        text = _insert(text, "        if (lane == 0) S.acc[o] += s;\n      }\n      __syncthreads();\n", "      STAMP(2);\n")
        text = _insert(text, "    block_sum2(S.red, S.red2);\n", "    STAMP(2);\n")
        text = _insert(text, "    for (int q = tid; q < m * 3; q += THREADS) S.y[q] = S.t[q];\n    __syncthreads();\n",
                       "    STAMP(5);\n")
    else:
        text = _insert(text, "      td::ec_visibility_weights(m, A.k_vis, A.tau_vis, E);\n    }\n", "    STAMP(0);\n")
        text = _insert(text, "    td::ec_cluster_totals(m, buf, E, cluster);\n", "    STAMP(6);\n")
        text = _insert(text, "    for (int q = tid; q < m * 3; q += THREADS) E.y[q] = S.t[q];\n    __syncthreads();\n",
                       "    STAMP(5);\n")
    text = _insert(text, "    td::gj_solve<", "    STAMP(3);\n", after=False)
    text = _insert(text, "(m, S.a, S.b, S.w, S.gj);\n", "    STAMP(4);\n")
    return text + E_HOST


def _gj_source(csrc: str, threads: int | None) -> str:
    text = open(os.path.join(csrc, "gj_solve.cu")).read()
    if threads is not None:
        old = next(f"constexpr int THREADS = {t};" for t in (256, 512) if f"constexpr int THREADS = {t};" in text)
        text = text.replace(old, f"constexpr int THREADS = {threads};")
    call = next(line for line in text.splitlines(True) if "td::gj_solve<THREADS" in line)
    text = _insert(text, call, "  STAMP(1);\n")
    text = _insert(text, call, "  STAMP(0);\n", after=False)
    return '#include "stamps.cuh"\n' + text + G_HOST


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
    for name, csrc, parent in variants:
        lib = _build(f"em_loop_{name}", csrc, _headers(csrc, name), "em_loop.cu",
                     _em_loop_source(csrc, parent), E_STAMPS)
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
        if lib.stamps_reset() != 0:
            raise RuntimeError("stamps_reset failed")
        run()
        torch.cuda.synchronize()
        acc = (ctypes.c_longlong * 8)()
        if lib.stamps_read(acc) != 0:
            raise RuntimeError("stamps_read failed")
        iters = int(stats[1])
        ys[name] = y_out.clone()
        out[name] = {"ms_10_iterations": _events_ms(torch, run, 20), "iterations": iters,
                     "cycles_per_iteration": {E_PHASES[i]: acc[i] / iters for i in range(7)},
                     "max_abs_vs_first_variant_m": float((ys[name] - next(iter(ys.values()))).abs().max())}
        print(f"E {name:14s} {out[name]['ms_10_iterations']:.4f} ms per 10 iterations; cycles per iteration "
              f"{ {k: round(v) for k, v in out[name]['cycles_per_iteration'].items()} }", flush=True)
    return out


def kernel_g(torch, variants) -> dict:
    import numpy as np

    dev = torch.device("cuda")
    saved = np.load(os.path.join(ROOT, "tests", "data", "gj_prereg_system.npz"))
    systems = {"live_prereg_8x45": (np.broadcast_to(saved["a"], (8, 45, 45)), np.broadcast_to(saved["b"], (8, 45, 3)))}
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 48, 48)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + 48 * np.eye(48, dtype=np.float32)
    b = rng.standard_normal((8, 48, 3)).astype(np.float32)
    systems["spd_16x48"] = (np.concatenate([a, a]), np.concatenate([b, b]))
    out = {}
    for name, csrc, threads in variants:
        lib = _build(f"gj_{name}", csrc, _headers(csrc, name), "gj_solve.cu", _gj_source(csrc, threads), G_STAMPS)
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
            st = (ctypes.c_longlong * 2)()
            if lib.stamps_read(st) != 0:
                raise RuntimeError("stamps_read failed")
            rec[key] = {"solve_cycles": st[1] - st[0], "cycles_per_pivot_step": (st[1] - st[0]) / at.shape[1],
                        "ms": ms}
            if key.startswith("live"):
                rec[key]["equals_saved_solution"] = bool(np.array_equal(w[0].cpu().numpy(), saved["w_kernel"]))
        out[name] = rec
        print(f"G {name:14s} {rec}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked earlier tree to stamp beside the current sources")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "em_phase_stamps.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("em_phase_stamps: CUDA is not available", file=sys.stderr)
        return 2
    csrc = os.path.join(ROOT, "trackdlo_tpu_torch", "csrc")
    parent = os.path.join(args.parent, "trackdlo_tpu_torch", "csrc") if args.parent else None
    e_variants = ([("parent", parent, True)] if parent else []) + [
        ("current", csrc, False), ("lanes8", csrc, False), ("pivot_shuffle", csrc, False)]
    g_variants = ([("parent", parent, 256)] if parent else []) + [
        ("current", csrc, None), ("current_256", csrc, 256), ("pivot_shuffle", csrc, None)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    record = {"card": card, "kernel_e": kernel_e(torch, e_variants), "kernel_g": kernel_g(torch, g_variants)}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
