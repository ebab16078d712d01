"""Two probes of the port's EM on the CPU (its plain versions), beside the
card's numbers in ``chip_smoke.py``:

- ``trips``: the EM trip counts of ``Tracker.step`` over ``chip_smoke.py``'s
  30 occluded live frames against the float64 oracle's, once in closed loop
  (each side on its own state) and once from the oracle's state every frame
  (same input, so a difference is the pass's, not the trajectory's).
- ``one-point``: kernel E's plain version on the live cloud with one valid
  point, float32 against float64 and under 1e-7 m nudges of the cloud,
  after 1, 2 and 3 iterations: how far float32 itself can be held.

- ``b1``: the pre-registration pass on frames 3, 9, 24 and 25 of that run,
  each from the float64 oracle's state, through kernel E (on the card) and
  through the JAX package's own B1 kernel (``fused_em_loop`` interpreted, on
  the CPU), on the same staged inputs, beside the oracle's trips and the
  port's plain version's. On a card (``--device cuda``) it stages each
  frame's pass on the card, runs kernel E and writes the staged inputs and
  E's trips to ``chiprun_out/b1_frames.npz``; on the CPU (the default) it
  reads that file (``--inputs``), or stages on the CPU where none is given,
  and runs B1 (this needs JAX and the JAX package) and the plain version.

Run from the repository root (no GPU needed but for ``b1 --device cuda``):

    python3 perf/port_em_probes.py trips
    python3 perf/port_em_probes.py one-point
    python3 perf/port_em_probes.py b1 --device cuda     # on the card
    python3 perf/port_em_probes.py b1 --inputs chiprun_out/b1_frames.npz

``--deltas N`` adds each route's per-iteration delta trace over N
iterations (the pass rerun with tol 0 and max_iter 1 .. N); on the card it
can start from the staged inputs of an earlier run (``--inputs``).

- ``phases``: kernel E's iterations phase by phase, on those four frames.
  On a card (``--device cuda``) it builds a probe copy of kernel E from a
  tree's sources (``--csrc``, the current ones by default; generated under
  ``build/em_phase_probe/``, nothing of it is part of the package) that
  writes, for iterations 1..16 of each pass (tol 0), the iterate y and σ²,
  the cluster totals P1, PX, Np, tr(X^T dPt1 X), the system A, B, the row
  scales e, the inverse, w before and after each refinement step, T, the
  next σ² and the delta; it runs each frame twice (the same bits, or a race)
  and once through a build whose cluster has one CTA (only the order of the
  sums changes), with the trips of each, into
  ``chiprun_out/phase_probe_TAG.npz``. On the CPU (``--inputs`` that file)
  it feeds each phase kernel E's own inputs of each iteration through
  float64 and the plain float32 route (and, for the solve and T, the JAX
  package's B1 route: ``_gj2d_with_inv`` and its refinement, ``_exact_dot``)
  and prints each route's relative error against float64, phase by phase
  (``chiprun_out/phase_table_TAG.json``); ``--save-frames`` writes the
  staged inputs with the oracle's, B1's and the plain version's trips to
  ``tests/data/prereg_frames.npz``.

    python3 perf/port_em_probes.py phases --device cuda [--csrc DIR --tag parent]
    python3 perf/port_em_probes.py phases --inputs chiprun_out/phase_probe_current.npz
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def trips() -> None:
    import chip_smoke
    from trackdlo_tpu_torch.models.trackdlo import Tracker, TrackerState
    from trackdlo_tpu_torch.oracle.pipeline import init_state, step_frame

    smoke = chip_smoke.Smoke()
    p, intr, m = smoke.params, smoke.intr, smoke.params.M
    tracker = Tracker(p, intr, device="cpu")
    start = tracker.init_from_nodes(smoke.rope.nodes(0.0, m))
    oracle = init_state(smoke.rope.nodes(0.0, m), p)
    closed = start
    rows = []  # open-loop pre/main, closed-loop pre/main, oracle pre/main
    for i in range(1, smoke.frames + 1):
        rgb, depth, occ = smoke.frame(i / 15.0, occlude=10 <= i <= 20)
        same = TrackerState(torch.as_tensor(oracle.y, dtype=torch.float32),
                            torch.tensor(float(oracle.sigma2)), start.geodesic_coord)
        _, out = tracker.step(same, rgb, depth, occ)
        closed, out_c = tracker.step(closed, rgb, depth, occ)
        with chip_smoke.oracle_trip_counts() as t:
            oracle, _, _ = step_frame(oracle, rgb, depth, p, intr, occ)
        t = t if len(t) == 2 else [0, *t]
        rows.append([int(out.guide_iterations), int(out.iterations), int(out_c.guide_iterations),
                     int(out_c.iterations), *t])
    a = np.array(rows)
    print(f"mean trips pre / main: closed loop {a[:, 2].mean():.4g} / {a[:, 3].mean():.4g}, "
          f"from the oracle's state {a[:, 0].mean():.4g} / {a[:, 1].mean():.4g}, "
          f"oracle {a[:, 4].mean():.4g} / {a[:, 5].mean():.4g}")
    print(f"frames where the pre-registration trips equal the oracle's from its state: "
          f"{int((a[:, 0] == a[:, 4]).sum())} of {len(a)}")
    print("per frame [open pre, open main, closed pre, closed main, oracle pre, oracle main]:")
    print(a.tolist())


def one_point() -> None:
    from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
    from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
    from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, em_staging
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_loop_plain
    from trackdlo_tpu_torch.ops.preprocess import (
        cell_sums_plain, compact_parity_channels, default_cell_px,
    )

    # The cloud of tests/test_torch_cuda.py's cluster layouts: frame 1/15 s,
    # rope radius 9 px, nothing occluded; its sixth valid point alone.
    p, intr = live_params(), CameraIntrinsics()
    rgb, depth = render_frame(SyntheticRope(), 1 / 15.0, intr, rope_pixel_radius=9)
    occ = torch.ones((intr.height, intr.width), dtype=torch.bool)
    sums = cell_sums_plain(torch.from_numpy(rgb), torch.from_numpy(depth.view(np.int16)), occ,
                           intr.fx, intr.fy, intr.cx, intr.cy, p.hsv_lower, p.hsv_upper,
                           p.multi_color_dlo, default_cell_px(p.downsample_leaf_size, intr.fx),
                           p.downsample_leaf_size)
    pc = compact_parity_channels(*sums, p.max_points, p.downsample_leaf_size, p.candidate_cap(),
                                 inputs_are_sums=True)
    xm = torch.zeros_like(pc.mask)
    xm[torch.nonzero(pc.mask).flatten()[5]] = True
    nodes = torch.from_numpy(SyntheticRope().nodes(0.0, p.M).astype(np.float32))
    nm = torch.ones(p.M, dtype=torch.bool)
    for iters in (1, 2, 3):
        params = CpdParams(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=iters,
                           tol=0.0, include_lle=False, k_vis=p.k_vis,
                           visibility_threshold=p.visibility_threshold, use_visibility=True)

        def run(x, dt):
            st = em_staging(x.to(dt), xm, nodes.to(dt), nm, torch.tensor(p.sigma2_init, dtype=dt),
                            params, visible_count=torch.tensor(30))
            return fused_em_loop_plain(*st.args, **st.kwargs)

        y32, s32 = run(pc.points, torch.float32)
        y64, _ = run(pc.points, torch.float64)
        g = torch.Generator().manual_seed(0)
        nudged = max(float((run(pc.points + torch.randn(pc.points.shape, generator=g) * 1e-7,
                                torch.float32)[0] - y32).abs().max()) for _ in range(4))
        print(f"{iters} iterations: sigma2 {float(s32[0]):.3g}; float32 vs float64 "
              f"{float((y32.double() - y64).abs().max()):.3g} m; largest move under four 1e-7 m "
              f"nudges {nudged:.3g} m")


B1_FRAMES = (3, 9, 24, 25)
B1_ARGS = ("dyn", "y0", "coord", "nm", "g", "hg", "hy0", "jg", "pd", "x", "xm")


def _stage_prereg(device: str) -> dict:
    """The pre-registration pass's staged inputs of ``Tracker.step`` from the
    float64 oracle's state on each of B1_FRAMES, and the trips of kernel E
    (on a card) or of the plain version (on the CPU) and of the oracle."""
    import chip_smoke
    from trackdlo_tpu_torch.models.trackdlo import Tracker, TrackerState
    from trackdlo_tpu_torch.ops import cpd_lle
    from trackdlo_tpu_torch.oracle.pipeline import init_state, step_frame

    smoke = chip_smoke.Smoke()
    p, intr, m = smoke.params, smoke.intr, smoke.params.M
    tracker = Tracker(p, intr, device=device)
    start = tracker.init_from_nodes(smoke.rope.nodes(0.0, m))
    oracle = init_state(smoke.rope.nodes(0.0, m), p)
    calls, real = [], cpd_lle.fused_em_loop

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(([a.cpu().numpy() for a in args], kwargs, int(out[1][1])))
        return out

    rec = {"frames": np.array(B1_FRAMES)}
    cpd_lle.fused_em_loop = recording
    try:
        for i in range(1, max(B1_FRAMES) + 1):
            rgb, depth, occ = smoke.frame(i / 15.0, occlude=10 <= i <= 20)
            if i in B1_FRAMES:
                same = TrackerState(torch.as_tensor(oracle.y, dtype=torch.float32, device=device),
                                    torch.tensor(float(oracle.sigma2), device=device),
                                    start.geodesic_coord)
                calls.clear()
                tracker.step(same, rgb, depth, occ)
                args, kwargs, trips = calls[0]  # the pre-registration pass
                for name, a in zip(B1_ARGS, args):
                    rec[f"f{i}_{name}"] = a
                rec[f"f{i}_kwargs"] = np.array([kwargs[k] for k in sorted(kwargs)], np.float64)
                rec[f"f{i}_trips"] = trips
            with chip_smoke.oracle_trip_counts() as t:
                oracle, _, _ = step_frame(oracle, rgb, depth, p, intr, occ)
            if i in B1_FRAMES:
                rec[f"f{i}_oracle_trips"] = (t if len(t) == 2 else [0, *t])[0]
    finally:
        cpd_lle.fused_em_loop = real
    rec["kwarg_names"] = np.array(sorted(kwargs))
    return rec


def _b1_interpreted(rec: dict, i: int, kw: dict) -> tuple[float, int]:
    """The JAX package's fused_em_loop, interpreted, on frame i's staged
    inputs (padded as its own staging pads them) with the loop constants
    ``kw``; returns its last delta and its trips."""
    import jax
    import jax.numpy as jnp

    from trackdlo_tpu.ops.pallas_kernels import fused_em_loop, pack_points

    a = {k: rec[f"f{i}_{k}"] for k in B1_ARGS}
    m, m_pad = a["y0"].shape[0], (a["y0"].shape[0] + 7) // 8 * 8
    f32 = jnp.float32
    pad_m3 = lambda v: jnp.zeros((m_pad, 3), f32).at[:m].set(jnp.asarray(v))
    pad_mm = lambda v: jnp.zeros((m_pad, m_pad), f32).at[:m, :m].set(jnp.asarray(v))
    pad_col = lambda v: jnp.zeros((m_pad, 1), f32).at[:m, 0].set(jnp.asarray(v))
    sigma2, v_count, n_safe, gate = (jnp.asarray(v, f32) for v in a["dyn"])
    muf = jnp.asarray(kw["muf"], f32)
    zero = jnp.zeros((), f32)
    scal = jnp.broadcast_to(jnp.stack([sigma2, muf * v_count / n_safe, muf / n_safe, gate, v_count,
                                       zero, zero, zero])[:, None], (8, 128))
    xt, xmp = pack_points(jnp.asarray(a["x"]), jnp.asarray(a["xm"]) > 0)
    with jax.default_device(jax.devices("cpu")[0]):
        _, stats = fused_em_loop(
            scal, pad_m3(a["y0"]), pad_col(a["coord"]), pad_col(a["nm"]), pad_mm(a["g"]),
            pad_mm(a["hg"]), pad_m3(a["hy0"]), pad_mm(a["jg"]), pad_m3(a["pd"]), xt, xmp,
            k_vis=kw["k_vis"], tau_vis=kw["tau_vis"], lam=kw["lam"], coef_lle=kw["coef_lle"],
            alpha=kw["alpha"], tol=kw["tol"], max_iter=int(kw["max_iter"]), interpret=True)
    stats = np.asarray(stats)
    return float(stats[0, 3]), int(stats[0, 1])


def _frame_kwargs(rec: dict, i: int) -> dict:
    kw = dict(zip([str(k) for k in rec["kwarg_names"]], rec[f"f{i}_kwargs"].tolist()))
    kw["max_iter"] = int(kw["max_iter"])
    return kw


def _delta_trace(run, kw: dict, n: int) -> list[float]:
    """Each iteration's mean node move over the first n iterations: the
    pass run with tol 0 and max_iter 1 .. n, the last iteration's delta."""
    return [run(dict(kw, tol=0.0, max_iter=t)) for t in range(1, n + 1)]


def b1(device: str, inputs: str | None, deltas: int) -> None:
    """Trips (and, with ``deltas``, the per-iteration delta traces) of the
    pre-registration pass on B1_FRAMES; see the module docstring."""
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_loop, fused_em_loop_plain

    if device != "cpu":
        rec = dict(np.load(inputs)) if inputs else _stage_prereg(device)
        if deltas:
            for i in B1_FRAMES:
                args = [torch.from_numpy(rec[f"f{i}_{k}"]).to(device) for k in B1_ARGS]
                rec[f"f{i}_kernel_deltas"] = np.array(_delta_trace(
                    lambda kw: float(fused_em_loop(*args, **kw)[1][3]), _frame_kwargs(rec, i), deltas))
        out = os.path.join(ROOT, "chiprun_out", "b1_frames.npz")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.savez(out, **rec)
        print(f"kernel E trips {[int(rec[f'f{i}_trips']) for i in B1_FRAMES]}, oracle "
              f"{[int(rec[f'f{i}_oracle_trips']) for i in B1_FRAMES]} on frames {list(B1_FRAMES)}; "
              f"staged inputs in {out}")
        return
    rec = dict(np.load(inputs)) if inputs else _stage_prereg("cpu")
    who = "kernel E (card)" if inputs else "plain (CPU)"
    for i in B1_FRAMES:
        kw = _frame_kwargs(rec, i)
        args = [torch.from_numpy(rec[f"f{i}_{k}"]) for k in B1_ARGS]
        plain = int(fused_em_loop_plain(*args, **kw)[1][1])
        print(f"frame {i}: oracle {int(rec[f'f{i}_oracle_trips'])}, {who} {int(rec[f'f{i}_trips'])}, "
              f"plain on these inputs {plain}, B1 interpreted {_b1_interpreted(rec, i, kw)[1]}",
              flush=True)
        if deltas:
            traces = {"B1": _delta_trace(lambda k: _b1_interpreted(rec, i, k)[0], kw, deltas),
                      "plain": _delta_trace(lambda k: float(fused_em_loop_plain(*args, **k)[1][3]),
                                            kw, deltas)}
            if f"f{i}_kernel_deltas" in rec:
                traces["kernel E"] = rec[f"f{i}_kernel_deltas"].tolist()
            for name, tr in traces.items():
                print(f"  deltas, {name:8s}: {[float(f'{v:.6g}') for v in tr]}")
            if "kernel E" in traces:
                first = next((t + 1 for t, (a, b) in enumerate(zip(traces["B1"], traces["kernel E"]))
                              if a != b), None)
                print(f"  first iteration whose delta differs between B1 and kernel E: {first}")


# ---------------------------------------------------------------------------
# phases: kernel E's iterations phase by phase.
# ---------------------------------------------------------------------------

PROBE_ITERS = 16
_MMAX = 48
# What the probe build writes per iteration, each field at a fixed offset
# with room for m = 48 (px as kernel E holds it: PX[d][r] at d * m + r).
PROBE_FIELDS = (("y", 3 * _MMAX), ("s2", 1), ("p1", _MMAX), ("px", 3 * _MMAX), ("np", 1),
                ("trx", 1), ("a", _MMAX * _MMAX), ("b", 3 * _MMAX), ("e", _MMAX),
                ("inv", _MMAX * _MMAX), ("w0", 3 * _MMAX), ("w1", 3 * _MMAX), ("w2", 3 * _MMAX),
                ("w3", 3 * _MMAX), ("t", 3 * _MMAX), ("s2n", 1), ("delta", 1))
PROBE_OFFSET = {}
_off = 0
for _name, _size in PROBE_FIELDS:
    PROBE_OFFSET[_name] = _off
    _off += _size
PROBE_STRIDE = _off

_PROBE_HEADER = r"""#pragma once
#define PROBE_ITERS %(iters)d
#define PROBE_STRIDE %(stride)d
%(offsets)s
__device__ float* td_probe_buf;
__device__ volatile int td_probe_iter;
// Block 0 (cluster rank 0) writes; every CTA holds the same values.
#define PROBE_AT(it, off, src, cnt) do { const int _it = (it); \
  if (blockIdx.x == 0 && _it < PROBE_ITERS) \
    for (int _q = threadIdx.x; _q < (cnt); _q += blockDim.x) \
      td_probe_buf[(size_t)_it * PROBE_STRIDE + (off) + _q] = (src)[_q]; } while (0)
#define PROBE1_AT(it, off, v) do { const int _it = (it); \
  if (blockIdx.x == 0 && threadIdx.x == 0 && _it < PROBE_ITERS) \
    td_probe_buf[(size_t)_it * PROBE_STRIDE + (off)] = (v); } while (0)
#define PROBE(off, src, cnt) PROBE_AT(td_probe_iter, off, src, cnt)
"""
_PROBE_HOST = r"""
extern "C" int probe_set(float* p) { return (int)cudaMemcpyToSymbol(td_probe_buf, &p, sizeof(p)); }
"""


def _swap(text: str, old: str, new: str) -> str:
    """The first ``old`` of ``text`` replaced by ``new``."""
    if old not in text:
        raise SystemExit(f"anchor not found in the sources: {old!r}")
    return text.replace(old, new, 1)


def _put(text: str, anchor: str, add: str, before: bool = False) -> str:
    """``add`` after (or before) the first ``anchor`` of ``text``."""
    return _swap(text, anchor, add + anchor if before else anchor + add)


def _line_with(text: str, part: str) -> str:
    return next(line for line in text.splitlines(True) if part in line)


def _probe_sources(csrc: str, one_cta: bool) -> dict:
    """The probe build's sources, generated from the tree ``csrc``: kernel
    E's source with its phase outputs written out (the anchors hold for this
    tree's sources and those of the tree before fault 1's repair)."""
    files = {n: open(os.path.join(csrc, n)).read() for n in os.listdir(csrc) if n.endswith(".cuh")}
    em = open(os.path.join(csrc, "em_loop.cu")).read()
    em = _put(em, "    const int buf = S.it & 1;\n    const float s2 = S.s2;\n",
              "    if (blockIdx.x == 0 && tid == 0) td_probe_iter = S.it;\n"
              "    PROBE_AT(S.it, PR_Y, E.y, m * 3);\n    PROBE1_AT(S.it, PR_S2, s2);\n")
    em = _put(em, "    td::ec_cluster_totals(m, buf, E, cluster);\n",
              "    PROBE_AT(S.it, PR_P1, E.tot, m);\n    PROBE_AT(S.it, PR_PX, E.tot + m, 3 * m);\n"
              "    PROBE1_AT(S.it, PR_NP, E.tot[4 * m]);\n    PROBE1_AT(S.it, PR_TRX, E.tot[4 * m + 1]);\n")
    em = _put(em, _line_with(em, "td::gj_solve<"),
              "    PROBE_AT(S.it, PR_A, S.a, m * m);\n    PROBE_AT(S.it, PR_B, S.b, m * 3);\n", before=True)
    em = _put(em, "    // sigma^2 and the mean node move", "    PROBE_AT(S.it, PR_T, S.t, m * 3);\n",
              before=True)
    # After the sigma^2 update S.it already counts this iteration.
    em = _put(em, "    for (int q = tid; q < m * 3; q += THREADS) E.y[q] = S.t[q];\n",
              "    PROBE1_AT(S.it - 1, PR_S2N, S.s2);\n    PROBE1_AT(S.it - 1, PR_DELTA, S.delta);\n",
              before=True)
    gj = files["gj.cuh"]
    gj = _put(gj, "      G.pos[r] = 0;  // stays in bounds for a row never pivoted (an all-NaN column)\n"
                  "    }\n  }\n  __syncthreads();\n", "  PROBE(PR_E, G.e, m);\n")
    gj = _put(gj, _line_with(gj, "  // Refinement"),
              "  PROBE(PR_INV, G.inv, m * m);\n  PROBE(PR_W0, w, m * 3);\n", before=True)
    gj = _put(gj, "      w[q] = w[q] + acc;\n    }\n    __syncthreads();\n",
              f"    PROBE(PR_W0 + (step + 1) * 3 * {_MMAX}, w, m * 3);\n")
    files["gj.cuh"] = gj
    if one_cta:
        body = ("  const int c = (n + EC_ROWS - 1) / EC_ROWS;\n"
                "  return c < 1 ? 1 : (c > EC_MAX_CLUSTER ? EC_MAX_CLUSTER : c);\n")
        files["estep_cluster.cuh"] = _swap(files["estep_cluster.cuh"], body, "  (void)n;\n  return 1;\n")
    offsets = "\n".join(f"#define PR_{k.upper()} {v}" for k, v in PROBE_OFFSET.items())
    files["probe.cuh"] = _PROBE_HEADER % {"iters": PROBE_ITERS, "stride": PROBE_STRIDE,
                                          "offsets": offsets}
    files["em_loop.cu"] = '#include "probe.cuh"\n' + em + _PROBE_HOST
    return files


def build_probe(csrc: str, name: str, one_cta: bool = False):
    """nvcc the probe copy of kernel E from ``csrc`` (a ctypes handle)."""
    import ctypes
    import subprocess

    from trackdlo_tpu_torch import _build as tb
    from trackdlo_tpu_torch.device import nvcc_path

    d = os.path.join(ROOT, "build", "em_phase_probe", name)
    os.makedirs(d, exist_ok=True)
    for fname, text in _probe_sources(csrc, one_cta).items():
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    so = os.path.join(d, "lib.so")
    r = subprocess.run([nvcc_path(), *tb.NVCC_FLAGS, "-shared", f"-I{d}", "-o", so,
                        os.path.join(d, "em_loop.cu")], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for the probe build {name}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.trackdlo_em_loop.argtypes = tb.SIGNATURES["trackdlo_em_loop"]
    lib.trackdlo_em_loop.restype = ctypes.c_int
    lib.probe_set.argtypes, lib.probe_set.restype = [ctypes.c_void_p], ctypes.c_int
    return lib


def run_probe(lib, args: list, kw: dict):
    """One launch of a probe build on ``args`` (CUDA tensors, B1_ARGS order):
    (the per-iteration dump (PROBE_ITERS, PROBE_STRIDE), stats)."""
    buf = torch.full((PROBE_ITERS, PROBE_STRIDE), float("nan"), device=args[0].device)
    y_out = torch.empty((args[1].shape[0], 3), device=args[0].device)
    stats = torch.empty(4, device=args[0].device)
    if lib.probe_set(buf.data_ptr()) != 0:
        raise RuntimeError("probe_set failed")
    code = lib.trackdlo_em_loop(
        *(t.data_ptr() for t in args), args[1].shape[0], args[9].shape[0], kw["muf"], kw["k_vis"],
        kw["tau_vis"], kw["lam"], kw["coef_lle"], kw["alpha"], kw["tol"], int(kw["max_iter"]),
        y_out.data_ptr(), stats.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"probe launch failed with cudaError_t {code}")
    torch.cuda.synchronize()
    return buf.cpu().numpy(), stats.cpu().numpy()


def probe_frames(rec: dict, csrc: str, tag: str, frames=B1_FRAMES) -> dict:
    """On the card: each frame of ``rec`` through the probe build of
    ``csrc`` (twice, tol 0 and 16 iterations), its one-CTA build, and both
    at the pass's own tol for their trips."""
    libs = {"probe": build_probe(csrc, tag), "one_cta": build_probe(csrc, tag + "_one_cta", True)}
    out = {}
    for i in frames:
        kw = _frame_kwargs(rec, i)
        args = [torch.from_numpy(rec[f"f{i}_{k}"]).cuda() for k in B1_ARGS]
        deep = dict(kw, tol=0.0, max_iter=PROBE_ITERS)
        for key, lib in libs.items():
            dump, _ = run_probe(lib, args, deep)
            out[f"f{i}_{key}_dump"] = dump
            out[f"f{i}_{key}_trips"] = int(run_probe(lib, args, kw)[1][1])
        again, _ = run_probe(libs["probe"], args, deep)
        out[f"f{i}_rerun_equal"] = bool(np.array_equal(again, out[f"f{i}_probe_dump"], equal_nan=True))
    return out


def _fields(dump_row: np.ndarray, m: int) -> dict:
    """One iteration's dump row as arrays of the loop's shapes."""
    get = lambda k, n: dump_row[PROBE_OFFSET[k]:PROBE_OFFSET[k] + n]
    f = {k: get(k, 3 * m).reshape(m, 3) for k in ("y", "b", "w0", "w1", "w2", "w3", "t")}
    f.update(s2=get("s2", 1)[0], p1=get("p1", m), px=get("px", 3 * m).reshape(3, m).T,
             np=get("np", 1)[0], trx=get("trx", 1)[0], a=get("a", m * m).reshape(m, m),
             e=get("e", m), inv=get("inv", m * m).reshape(m, m), s2n=get("s2n", 1)[0],
             delta=get("delta", 1)[0])
    return f


def _rel(v, ref) -> float:
    v, ref = np.asarray(v, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(v - ref).max() / max(np.abs(ref).max(), 1e-300))


def _b1_solve(a: np.ndarray, b: np.ndarray):
    """The JAX package's B1 M-step solve on (A, B): the exponent-bits row
    scale, _gj2d_with_inv on the padded system and the three refinement
    steps with _exact_dot's residual (pallas_kernels.py:1349-1368);
    returns (w before refinement, w after, the inverse)."""
    import jax
    import jax.numpy as jnp

    from trackdlo_tpu.ops.pallas_kernels import _exact_dot, _gj2d_with_inv

    m = a.shape[0]
    ap = np.eye(_MMAX, dtype=np.float32)
    ap[:m, :m] = a
    bp = np.zeros((_MMAX, 4), np.float32)
    bp[:m, :3] = b

    @jax.jit
    def solve(a, bp):
        d_row = jnp.max(jnp.abs(a), axis=1, keepdims=True)
        d_safe = jnp.where(d_row > 0, d_row, 1.0)
        ebits = (jax.lax.bitcast_convert_type(d_safe, jnp.int32) >> 23) & 255
        e = jax.lax.bitcast_convert_type((ebits + 1) << 23, jnp.float32)
        w, inv = _gj2d_with_inv(a / e, bp / e, _MMAX, 4)
        w0 = w
        for _ in range(3):
            r = (bp - _exact_dot(a, w)) / e
            w = w + jax.lax.dot_general(inv, r, (((1,), (0,)), ((), ())),
                                        preferred_element_type=jnp.float32)
        return w0, w, inv

    with jax.default_device(jax.devices("cpu")[0]):
        w0, w, inv = (np.asarray(v) for v in solve(ap, bp))
    return w0[:m, :3], w[:m, :3], inv[:m, :m]


def _b1_gw(g: np.ndarray, w: np.ndarray) -> np.ndarray:
    import jax

    from trackdlo_tpu.ops.pallas_kernels import _exact_dot

    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(jax.jit(_exact_dot)(g, w))


PHASES = ("E-step", "M-step system", "solve", "solve, as G W", "T", "sigma2 and delta")


def phase_errors(rec: dict, i: int, dump: np.ndarray, with_b1: bool = True) -> list[dict]:
    """Per iteration of frame i's probe dump: each phase fed kernel E's own
    inputs of that iteration; the relative error against float64 of kernel
    E's output, of the plain float32 route's and (solve and T) of B1's."""
    from trackdlo_tpu_torch.ops.hopper_kernels import EmPhasesPlain

    kw = _frame_kwargs(rec, i)
    consts = {k: kw[k] for k in ("muf", "k_vis", "tau_vis", "lam", "coef_lle", "alpha")}
    base = [torch.from_numpy(rec[f"f{i}_{k}"]) for k in B1_ARGS]
    ph = {dt: EmPhasesPlain(*[t.to(dt) for t in base], **consts) for dt in (torch.float32, torch.float64)}
    m = base[1].shape[0]
    y0, g, node = rec[f"f{i}_y0"].astype(np.float64), rec[f"f{i}_g"], rec[f"f{i}_nm"] > 0
    t32 = lambda *v: [torch.as_tensor(np.asarray(x), dtype=torch.float32) for x in v]
    t64 = lambda *v: [torch.as_tensor(np.asarray(x), dtype=torch.float64) for x in v]
    rows = []
    for k in range(PROBE_ITERS):
        f = _fields(dump[k], m)
        if not np.isfinite(f["s2"]):
            break
        row = {"iteration": k + 1}
        ref = [v.numpy() for v in ph[torch.float64].estep(*t64(f["y"], f["s2"]))]
        plain = [v.numpy() for v in ph[torch.float32].estep(*t32(f["y"], f["s2"]))]
        kern = [f["p1"], f["px"], f["np"], f["trx"]]
        row["E-step"] = {"kernel E": max(map(_rel, kern, ref)), "plain": max(map(_rel, plain, ref))}
        ref = [v.numpy() for v in ph[torch.float64].mstep(*t64(f["p1"], f["px"], f["s2"]))]
        plain = [v.numpy() for v in ph[torch.float32].mstep(*t32(f["p1"], f["px"], f["s2"]))]
        row["M-step system"] = {"kernel E": max(_rel(f["a"], ref[0]), _rel(f["b"], ref[1])),
                                "plain": max(map(_rel, plain, ref))}
        a64, b64 = f["a"].astype(np.float64), f["b"].astype(np.float64)
        w64 = np.linalg.solve(a64, b64)
        plain_w = torch.linalg.solve(*t32(f["a"], f["b"])).numpy()
        scaled = a64 / f["e"].astype(np.float64)[:, None]
        row["solve"] = {"kernel E": _rel(f["w3"], w64), "plain": _rel(plain_w, w64),
                        "kernel E before refinement": _rel(f["w0"], w64),
                        "kernel E after each refinement step": [_rel(f[w], w64) for w in ("w1", "w2", "w3")],
                        "kernel E |I - inv A/e|": float(np.abs(np.eye(m) - f["inv"] @ scaled).max()),
                        "cond": float(np.linalg.cond(a64))}
        # The same solutions as node moves G W: what the iteration passes on.
        g64 = g.astype(np.float64)
        gw = lambda v: g64 @ np.asarray(v, np.float64)
        row["solve, as G W"] = {"kernel E": _rel(gw(f["w3"]), gw(w64)), "plain": _rel(gw(plain_w), gw(w64))}
        if with_b1:
            bw0, bw, binv = _b1_solve(f["a"], f["b"])
            row["solve"].update({"B1": _rel(bw, w64), "B1 before refinement": _rel(bw0, w64),
                                 "B1 |I - inv A/e|": float(np.abs(np.eye(m) - binv @ scaled).max())})
            row["solve, as G W"]["B1"] = _rel(gw(bw), gw(w64))
        w = f["w3"]
        t_ref = np.where(node[:, None], y0 + g.astype(np.float64) @ w.astype(np.float64), y0)
        row["T"] = {"kernel E": _rel(f["t"] - y0, t_ref - y0),
                    "plain": _rel(ph[torch.float32].update(*t32(w)).numpy() - y0, t_ref - y0)}
        if with_b1:
            t_b1 = np.where(node[:, None], (rec[f"f{i}_y0"] + _b1_gw(g, w)).astype(np.float32), y0)
            row["T"]["B1"] = _rel(t_b1 - y0, t_ref - y0)
        args = (f["t"], f["y"], f["p1"], f["px"], f["np"], f["trx"])
        ref = [float(v) for v in ph[torch.float64].sigma2(*t64(*args))]
        plain = [float(v) for v in ph[torch.float32].sigma2(*t32(*args))]
        row["sigma2 and delta"] = {"kernel E": max(_rel(f["s2n"], ref[0]), _rel(f["delta"], ref[1])),
                                   "plain": max(_rel(plain[0], ref[0]), _rel(plain[1], ref[1]))}
        row["delta"] = float(f["delta"])
        rows.append(row)
    return rows


def phase_summary(rows: list[dict]) -> dict:
    """Per phase, the median over the iterations of each route's relative
    error, and kernel E's over the plain route's and over B1's (>= 10: the
    phase at fault)."""
    out = {}
    for ph in PHASES:
        routes = {r: float(np.median([row[ph][r] for row in rows]))
                  for r in rows[0][ph] if not isinstance(rows[0][ph][r], list)}
        for other in ("plain", "B1"):
            if other in routes:
                routes[f"kernel E / {other}"] = routes["kernel E"] / max(routes[other], 1e-300)
        out[ph] = routes
    return out


def at_fault(summary: dict) -> list[str]:
    """The phases whose kernel-E output lies 10x or more further from float64
    than the plain route's or B1's on the same inputs."""
    return [ph for ph, r in summary.items()
            if max(r.get("kernel E / plain", 0.0), r.get("kernel E / B1", 0.0)) >= 10]


def phases(device: str, inputs: str | None, csrc: str | None, tag: str, save_frames: bool) -> None:
    import json

    if device != "cpu":
        rec = dict(np.load(inputs)) if inputs else _stage_prereg(device)
        rec.update(probe_frames(rec, csrc or os.path.join(ROOT, "trackdlo_tpu_torch", "csrc"), tag))
        out = os.path.join(ROOT, "chiprun_out", f"phase_probe_{tag}.npz")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.savez(out, **rec)
        for i in B1_FRAMES:
            print(f"frame {i}: trips of the probe build {rec[f'f{i}_probe_trips']}, of its one-CTA "
                  f"build {rec[f'f{i}_one_cta_trips']}, of this checkout's kernel E "
                  f"{int(rec[f'f{i}_trips'])}, oracle {int(rec[f'f{i}_oracle_trips'])}; rerun "
                  f"bit-equal {bool(rec[f'f{i}_rerun_equal'])}")
        print(f"dumps in {out}")
        return
    if not inputs:
        raise SystemExit("phases on the CPU reads the card's dumps: --inputs chiprun_out/phase_probe_TAG.npz")
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_loop_plain

    rec = dict(np.load(inputs))
    table = {}
    for i in B1_FRAMES:
        kw = _frame_kwargs(rec, i)
        args = [torch.from_numpy(rec[f"f{i}_{k}"]) for k in B1_ARGS]
        trips = {"kernel E": int(rec[f"f{i}_probe_trips"]), "one CTA": int(rec[f"f{i}_one_cta_trips"]),
                 "plain": int(fused_em_loop_plain(*args, **kw)[1][1]),
                 "B1 interpreted": _b1_interpreted(rec, i, kw)[1],
                 "oracle": int(rec[f"f{i}_oracle_trips"])}
        rows = phase_errors(rec, i, rec[f"f{i}_probe_dump"])
        one = phase_errors(rec, i, rec[f"f{i}_one_cta_dump"], with_b1=False)
        table[i] = {"trips": trips, "rerun_bit_equal": bool(rec[f"f{i}_rerun_equal"]),
                    "summary": phase_summary(rows), "one_cta_summary": phase_summary(one),
                    "iterations": rows}
        rec[f"f{i}_b1_trips"], rec[f"f{i}_plain_trips"] = trips["B1 interpreted"], trips["plain"]
        print(f"frame {i}: trips {trips}; rerun bit-equal {table[i]['rerun_bit_equal']}")
        for ph, routes in table[i]["summary"].items():
            flag = "  <- 10x or more" if ph in at_fault({ph: routes}) else ""
            print(f"  {ph:18s} " + ", ".join(f"{r} {v:.3g}" for r, v in routes.items()) + flag)
        s1 = table[i]["one_cta_summary"]
        print("  one CTA:           " + ", ".join(f"{ph} {s1[ph]['kernel E']:.3g}" for ph in PHASES), flush=True)
    out = os.path.join(ROOT, "chiprun_out", os.path.basename(inputs).replace("probe", "table")
                       .replace(".npz", ".json"))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({str(k): v for k, v in table.items()}, f, indent=1)
    print(f"table in {out}")
    if save_frames:
        # The probed tree's trips under its tag, beside those already saved.
        path = os.path.join(ROOT, "tests", "data", "prereg_frames.npz")
        keep = dict(np.load(path)) if os.path.exists(path) else {}
        keep.update(frames=np.array(B1_FRAMES), kwarg_names=rec["kwarg_names"])
        tag = os.path.basename(inputs)[len("phase_probe_"):-len(".npz")]
        for i in B1_FRAMES:
            for k in (*B1_ARGS, "kwargs", "oracle_trips", "b1_trips", "plain_trips"):
                keep[f"f{i}_{k}"] = rec[f"f{i}_{k}"]
            keep[f"f{i}_kernel_e_trips_{tag}"] = rec[f"f{i}_probe_trips"]
        np.savez_compressed(path, **keep)
        print(f"staged inputs and trips in {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=["trips", "one-point", "b1", "phases"])
    ap.add_argument("--device", default="cpu", help="b1, phases: cuda to stage and run kernel E on the card")
    ap.add_argument("--inputs", help="b1, phases: the staged inputs (or dumps) written on the card")
    ap.add_argument("--deltas", type=int, default=0,
                    help="b1: also each route's delta trace over this many iterations (tol 0)")
    ap.add_argument("--csrc", help="phases: the kernel sources to probe (default: this tree's)")
    ap.add_argument("--tag", default="current", help="phases: names the output files")
    ap.add_argument("--save-frames", action="store_true",
                    help="phases: write tests/data/prereg_frames.npz from the card's staged inputs")
    args = ap.parse_args()
    if args.probe == "b1":
        b1(args.device, args.inputs, args.deltas)
    elif args.probe == "phases":
        phases(args.device, args.inputs, args.csrc, args.tag, args.save_frames)
    else:
        {"trips": trips, "one-point": one_point}[args.probe]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
