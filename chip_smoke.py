#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero and prints no result line):

1. toolchain: the card's name and power limit, torch's CUDA version, nvcc;
2. build: compile the five CUDA kernels from ``trackdlo_tpu_torch/csrc``;
3. check: each kernel against its plain PyTorch version on the card, at the
   shapes of the main path (720p frame, M=45, the live cloud capacity);
4. closed loop: ``Tracker.step`` over 30 occluded frames against the float64
   oracle, with the kernels' launch counts;
5. timing: the per-frame step (CUDA events, median of 100 frames) and each
   kernel beside its plain version.

The last two lines of standard output are the card line and a JSON object
``{"ok": true, "device": {...}}``; the line before them holds the kernels'
JSON record. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

BOUNDS = {
    "preprocess_parity_count_delta": 0,
    "preprocess_parity_p95_m": 1e-6,
    "parity_z_mismatch": 0,
    "parity_xy_mismatch": 0,
    "compact_mismatch": 0,
    "visibility_idx_mismatch": 0,
    "visibility_dist_max_m": 1e-6,
    "visibility_pointmin_max": 1e-6,
    "priors_mask_mismatch": 0,
    "priors_pos_max_m": 5e-6,
    "em3_plain_max_m": 1e-6,
    "em3_lle_max_m": 1e-6,
    "em3_priors_gate_max_m": 1e-6,
    "closed_loop_mean_mm": 1.0,
}
EXPECTED_LAUNCHES = {"cell_sums": 30, "compact": 30, "visibility": 30, "walks": 30, "em_loop": 60}
KERNELS = {
    "cell_sums": ("trackdlo_tpu_torch/csrc/cell_sums.cu", "trackdlo_tpu/ops/preprocess_kernel.py:470"),
    "compact": ("trackdlo_tpu_torch/csrc/compact.cu", "trackdlo_tpu/ops/preprocess_kernel.py:617"),
    "visibility": ("trackdlo_tpu_torch/csrc/visibility.cu", "trackdlo_tpu/ops/visibility_kernel.py:292"),
    "walks": ("trackdlo_tpu_torch/csrc/walks.cu", "trackdlo_tpu/ops/pallas_kernels.py:1685"),
    "em_loop": ("trackdlo_tpu_torch/csrc/em_loop.cu", "trackdlo_tpu/ops/pallas_kernels.py:1441"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "nvidia-smi: no output"


class Smoke:
    def __init__(self, frames: int = 30, timing_frames: int = 100):
        import numpy as np
        import torch

        from trackdlo_tpu.config import CameraIntrinsics, live_params
        from trackdlo_tpu.io.sequence import SyntheticRope, render_frame

        self.np, self.torch = np, torch
        self.params = live_params()
        self.intr = CameraIntrinsics()
        self.rope = SyntheticRope()
        self.render = render_frame
        self.frames = frames
        self.timing_frames = timing_frames
        self.dev = torch.device("cuda")
        self.metrics: dict = {}
        self.kernel_err: dict = {}
        self.launches: dict = {}
        self.times: dict = {}
        self.failures: list[str] = []

    # -- helpers -----------------------------------------------------------
    def bound(self, key: str, value: float) -> None:
        self.metrics[key] = value
        ok = abs(value) <= BOUNDS[key]
        log(f"  {key:34s} {value!r:>24}  bound {BOUNDS[key]!r}  {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(key)

    def frame(self, t: float, occlude: bool = False):
        np, torch = self.np, self.torch
        rgb, depth = self.render(self.rope, t, self.intr)
        occ = np.ones((self.intr.height, self.intr.width), np.uint8) * 255
        if occlude:
            occ[:, 500:800] = 0
        return rgb, depth, occ

    def to_dev(self, rgb, depth, occ):
        torch = self.torch
        return (
            torch.from_numpy(rgb).to(self.dev),
            torch.from_numpy(depth.view(self.np.int16)).to(self.dev),
            torch.from_numpy(occ != 0).to(self.dev),
        )

    def time_pair(self, name, kernel_fn, plain_fn, n_kernel=50, n_plain=5):
        """ms per call of the kernel and of its plain version, measured in
        turns (plain, kernel, kernel, plain) with CUDA events."""
        torch = self.torch

        def run(fn, n):
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n

        p1 = run(plain_fn, n_plain)
        k1 = run(kernel_fn, n_kernel)
        k2 = run(kernel_fn, n_kernel)
        p2 = run(plain_fn, n_plain)
        self.times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}
        log(f"  {name:12s} kernel {self.times[name]['ms']:.4f} ms   plain {self.times[name]['plain_ms']:.4f} ms")

    # -- phase 3: kernels against their plain versions ----------------------
    def check_preprocess(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.preprocess import (
            cell_sums_plain, compact_channels, compact_channels_plain, compact_parity_channels,
            default_cell_px, kept_cells,
        )
        from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums

        p, intr = self.params, self.intr
        leaf = p.downsample_leaf_size
        cell = default_cell_px(leaf, intr.fx)
        rgb, depth, occ = self.frame(1 / 15.0)
        args = (*self.to_dev(rgb, depth, occ), intr.fx, intr.fy, intr.cx, intr.cy,
                p.hsv_lower, p.hsv_upper, p.multi_color_dlo, cell, leaf)
        k_out = cell_sums(*args)
        p_out = cell_sums_plain(*args)
        self.kernel_err["cell_sums"] = max(float((a - b).abs().max()) for a, b in zip(k_out, p_out))
        pcs = [compact_parity_channels(*o, p.max_points, leaf, p.candidate_cap(), inputs_are_sums=True)
               for o in (k_out, p_out)]
        kp = pcs[0].points[pcs[0].mask].cpu().numpy()
        pp = pcs[1].points[pcs[1].mask].cpu().numpy()
        log(f"  cell grid {tuple(k_out[3].shape)}, cloud {len(kp)} points (plain {len(pp)})")
        self.bound("preprocess_parity_count_delta", int(pcs[0].count) - int(pcs[1].count))
        d = np.linalg.norm(kp[:, None] - pp[None], axis=2).min(1)
        self.bound("preprocess_parity_p95_m", float(np.percentile(d, 95)))
        self.cloud = pcs[1]
        self.p_args = args

        # Kernel C on the same cell sums: the live slots, then 16 slots per
        # channel so that kept cells overflow them. Every output bit-equal.
        mismatch, c_err = 0, 0.0
        for cap_per in (p.candidate_cap() // 8, 16):
            kept = kept_cells(k_out[3], cap_per)
            ck = compact_channels(*k_out, kept, cap_per)
            cp = compact_channels_plain(*k_out, kept, cap_per)
            mismatch += sum(int((a != b).sum()) for a, b in zip(ck, cp))
            c_err = max(c_err, *(float((a.float() - b.float()).abs().max()) for a, b in zip(ck, cp)))
            log(f"  compaction: {cap_per} slots per channel, {int(cp[2].sum())} filled")
        self.bound("compact_mismatch", mismatch)
        self.kernel_err["compact"] = c_err
        self.c_args = (*k_out, kept_cells(k_out[3], p.candidate_cap() // 8), p.candidate_cap() // 8)

        # Parity over every u16 depth at the 8 mm leaf: one pixel per cell.
        side = 256
        dgrid = np.arange(65536, dtype=np.uint16).reshape(side, side)
        rgb1 = np.empty((side, side, 3), np.uint8)
        rgb1[:] = (30, 60, 200)
        occ1 = np.ones((side, side), np.uint8)
        a1 = (*self.to_dev(rgb1, dgrid, occ1), intr.fx, intr.fy, 128.5, 127.25,
              p.hsv_lower, p.hsv_upper, False, 1, leaf)
        cnt_k = cell_sums(*a1)[3]
        cnt_p = cell_sums_plain(*a1)[3]
        have = (cnt_k.sum(0) > 0).cpu().numpy()
        ch_k = cnt_k.argmax(0).cpu().numpy()
        ch_p = cnt_p.argmax(0).cpu().numpy()
        d_all = dgrid.reshape(-1).astype(np.int64)
        truth_z = (d_all // 8) & 1
        self.bound("parity_z_mismatch", int(((ch_k & 1) != truth_z)[have].sum() + (~have[1:]).sum()))
        self.bound("parity_xy_mismatch", int(((ch_k >> 1) != (ch_p >> 1))[have].sum()))

    def check_visibility(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.kernels import geodesic_coords
        from trackdlo_tpu_torch.ops.preprocess import compact_parity_channels
        from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums
        from trackdlo_tpu_torch.ops.visibility import compute_visibility
        from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility

        p, intr = self.params, self.intr
        y = torch.as_tensor(self.rope.nodes(0.0, p.M), dtype=torch.float32, device=self.dev)
        coord = geodesic_coords(y)
        proj = torch.as_tensor(np.array(intr.proj_matrix(), np.float32), device=self.dev)
        clouds = [self.cloud]
        rgb, depth, occ = self.frame(1 / 15.0, occlude=True)
        sums = cell_sums(*self.to_dev(rgb, depth, occ), *self.p_args[3:])
        clouds.append(compact_parity_channels(*sums, p.max_points, p.downsample_leaf_size,
                                              p.candidate_cap(), inputs_are_sums=True))
        idx_mis, dist, pmin, err = 0, 0.0, 0.0, 0.0
        for pc in clouds:
            a = (y, pc.points, pc.mask, proj, coord, intr.height, intr.width,
                 p.visibility_threshold, p.dlo_pixel_width, p.d_vis)
            vk, vp = fused_visibility(*a), compute_visibility(*a)
            for f in ("visible_mask", "extended_mask", "not_self_occluded", "vis_idx", "vis_ext_idx"):
                idx_mis += int((getattr(vk, f) != getattr(vp, f)).sum())
            idx_mis += int(vk.vis_count != vp.vis_count) + int(vk.vis_ext_count != vp.vis_ext_count)
            dist = max(dist, float((vk.shortest_node_pt_dists - vp.shortest_node_pt_dists).abs().max()))
            for f in ("point_min_sq_all", "point_min_sq_ext"):
                gk = getattr(vk, f).clamp(max=1.0)
                gp = getattr(vp, f).clamp(max=1.0)
                pmin = max(pmin, float((gk - gp).abs().max()))
            log(f"  visible {int(vp.vis_count)}, extended {int(vp.vis_ext_count)} of {p.M}")
        err = max(dist, pmin)
        self.bound("visibility_idx_mismatch", idx_mis)
        self.bound("visibility_dist_max_m", dist)
        self.bound("visibility_pointmin_max", pmin)
        self.kernel_err["visibility"] = err
        self.v_args = (y, clouds[0].points, clouds[0].mask, proj, coord, intr.height, intr.width,
                       p.visibility_threshold, p.dlo_pixel_width, p.d_vis)

    def check_walks(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.hopper_kernels import pursuit_walks, pursuit_walks_plain
        from trackdlo_tpu_torch.ops.kernels import geodesic_coords
        from trackdlo_tpu_torch.ops.priors import walk_inputs

        m = self.params.M
        y = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        coord = geodesic_coords(y)
        moved = torch.as_tensor(self.rope.nodes(1 / 15.0, m), dtype=torch.float32, device=self.dev)
        cases = {
            "all_visible": list(range(m)),
            "mid_occluded": list(range(0, 15)) + list(range(30, m)),
            "tail_occluded": list(range(0, 35)),
            "head_occluded": list(range(10, m)),
            "both_ends_occluded": list(range(10, 35)),
        }
        mask_mis, pos_max = 0, 0.0
        for name, vis in cases.items():
            idx = torch.full((m,), m - 1, dtype=torch.int64, device=self.dev)
            idx[: len(vis)] = torch.as_tensor(vis, device=self.dev)
            cnt = torch.tensor(len(vis), device=self.dev)
            guides = torch.zeros_like(y)
            guides[: len(vis)] = moved[idx[: len(vis)]]
            wi = walk_inputs(y, coord, guides, idx, cnt, idx, cnt)
            pk, vk = pursuit_walks(wi.guides, wi.seglens, wi.ints)
            pp, vp = pursuit_walks_plain(wi.guides, wi.seglens, wi.ints)
            mask_mis += int((vk != vp).sum())
            both = vk & vp
            if bool(both.any()):
                pos_max = max(pos_max, float((pk - pp).abs()[both].max()))
            log(f"  {name:20s} state {int(wi.state)}  valid nodes {int(vp.sum())}")
            self.w_args = (wi.guides, wi.seglens, wi.ints)
        self.bound("priors_mask_mismatch", mask_mis)
        self.bound("priors_pos_max_m", pos_max)
        self.kernel_err["walks"] = pos_max

    def check_em(self):
        torch = self.torch
        from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, em_staging
        from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_loop, fused_em_loop_plain

        p = self.params
        m = p.M
        nodes = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        nm = torch.ones(m, dtype=torch.bool, device=self.dev)
        s2 = torch.tensor(0.001, device=self.dev)
        vc = torch.tensor(30, device=self.dev)
        base = dict(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=3,
                    tol=0.0, include_lle=False, k_vis=p.k_vis,
                    visibility_threshold=p.visibility_threshold, use_visibility=True)
        cases = (
            ("em3_plain_max_m", {}, {}),
            ("em3_lle_max_m", {"include_lle": True}, {}),
            ("em3_priors_gate_max_m", {"use_priors": True, "alpha": p.alpha},
             {"prior_pos": nodes + 0.004,
              "prior_mask": torch.arange(m, device=self.dev) < 12}),
        )
        err = 0.0
        for key, extra, kw in cases:
            st = em_staging(self.cloud.points, self.cloud.mask, nodes, nm, s2,
                            CpdParams(**{**base, **extra}), visible_count=vc, **kw)
            yk, sk = fused_em_loop(*st.args, **st.kwargs)
            yp, sp = fused_em_loop_plain(*st.args, **st.kwargs)
            e = float((yk - yp).abs().max())
            log(f"  iterations kernel {int(sk[1])} plain {int(sp[1])}, sigma2 {float(sk[0]):.6g} vs {float(sp[0]):.6g}")
            if int(sk[1]) != int(sp[1]):
                self.failures.append(f"{key}_iterations")
            self.bound(key, e)
            err = max(err, e)
        self.kernel_err["em_loop"] = err

    # -- phase 4: closed loop against the oracle -----------------------------
    def closed_loop(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu.oracle.pipeline import init_state as oracle_init, step_frame
        from trackdlo_tpu_torch import _build
        from trackdlo_tpu_torch.models.trackdlo import Tracker

        p, intr, m = self.params, self.intr, self.params.M
        tracker = Tracker(p, intr, device=self.dev)
        state = tracker.init_from_nodes(self.rope.nodes(0.0, m))
        o_state = oracle_init(self.rope.nodes(0.0, m), p)
        frames = [self.frame(i / 15.0, occlude=10 <= i <= 20) for i in range(1, self.frames + 1)]
        ys, states, iters, npts = [], [], [], []
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        for rgb, depth, occ in frames:
            state, out = tracker.step(state, rgb, depth, occ)
            ys.append(state.y)
            states.append(out.occlusion_state)
            iters.append(out.iterations)
            npts.append(out.n_points)
        torch.cuda.synchronize()
        self.launches = dict(_build.launch_counts)
        log(f"  launches in the {self.frames}-frame run: {self.launches}")
        for k, want in EXPECTED_LAUNCHES.items():
            want = want * self.frames // 30
            if self.launches.get(k) != want:
                self.failures.append(f"launches_{k}")
                log(f"  launches {k}: {self.launches.get(k)} != {want}  FAIL")
        dev_mm, gt_mm = [], []
        for i, (rgb, depth, occ) in enumerate(frames, start=1):
            o_state, _, _ = step_frame(o_state, rgb, depth, p, intr, occ)
            y = ys[i - 1].cpu().numpy()
            if not np.isfinite(y).all() or y.shape != (m, 3):
                self.failures.append("closed_loop_finite")
            dev_mm.append(1000 * float(np.linalg.norm(y - o_state.y, axis=1).mean()))
            gt_mm.append(1000 * float(np.linalg.norm(y - self.rope.nodes(i / 15.0, m), axis=1).mean()))
        seen = sorted({int(s) for s in torch.stack(states).cpu().tolist()})
        self.metrics.update(
            closed_loop_per_frame_mm=dev_mm, closed_loop_max_mm=max(dev_mm),
            gt_mean_mm=statistics.fmean(gt_mm), occlusion_states_seen=seen,
            main_em_iterations=[int(v) for v in torch.stack(iters).cpu().tolist()],
            n_points=[int(v) for v in torch.stack(npts).cpu().tolist()],
        )
        log(f"  occlusion states seen: {seen}")
        log(f"  points per frame: {self.metrics['n_points']}")
        log(f"  main-EM iterations: {self.metrics['main_em_iterations']}")
        log(f"  per-frame deviation from the oracle (mm): {[round(v, 4) for v in dev_mm]}")
        self.bound("closed_loop_mean_mm", statistics.fmean(dev_mm))
        if len(seen) < 2:
            self.failures.append("occlusion_states")
        self.tracker, self.state, self.frames_data = tracker, state, frames

    # -- phase 5: timing --------------------------------------------------------
    def timing(self):
        np, torch = self.np, self.torch
        from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, em_staging
        from trackdlo_tpu_torch.ops.hopper_kernels import (
            fused_em_loop, fused_em_loop_plain, pursuit_walks, pursuit_walks_plain,
        )
        from trackdlo_tpu_torch.ops.preprocess import (
            cell_sums_plain, compact_channels, compact_channels_plain,
        )
        from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums
        from trackdlo_tpu_torch.ops.visibility import compute_visibility
        from trackdlo_tpu_torch.ops.visibility_kernel import fused_visibility

        tracker, state, frames = self.tracker, self.state, self.frames_data
        for i in range(10):
            rgb, depth, occ = frames[i % len(frames)]
            state, _ = tracker.step(state, rgb, depth, occ)
        torch.cuda.synchronize()
        ev_ms, wall_ms = [], []
        for i in range(self.timing_frames):
            rgb, depth, occ = frames[i % len(frames)]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, out = tracker.step(state, rgb, depth, occ)
            end.record()
            end.synchronize()
            wall_ms.append(1000 * (time.perf_counter() - t0))
            ev_ms.append(start.elapsed_time(end))
        self.times["step"] = {
            "median_ms": statistics.median(ev_ms), "p90_ms": float(np.percentile(ev_ms, 90)),
            "wall_median_ms": statistics.median(wall_ms), "frames": self.timing_frames,
        }
        log(f"  Tracker.step per frame: median {self.times['step']['median_ms']:.3f} ms "
            f"(p90 {self.times['step']['p90_ms']:.3f}, host wall median {self.times['step']['wall_median_ms']:.3f})")

        p = self.params
        self.time_pair("cell_sums", lambda: cell_sums(*self.p_args), lambda: cell_sums_plain(*self.p_args))
        self.time_pair("compact", lambda: compact_channels(*self.c_args),
                       lambda: compact_channels_plain(*self.c_args))
        self.time_pair("visibility", lambda: fused_visibility(*self.v_args),
                       lambda: compute_visibility(*self.v_args))
        self.time_pair("walks", lambda: pursuit_walks(*self.w_args), lambda: pursuit_walks_plain(*self.w_args))
        m = p.M
        nodes = torch.as_tensor(self.rope.nodes(0.0, m), dtype=torch.float32, device=self.dev)
        st = em_staging(
            self.cloud.points, self.cloud.mask, nodes, torch.ones(m, dtype=torch.bool, device=self.dev),
            torch.tensor(p.sigma2_init, device=self.dev),
            CpdParams(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=10,
                      tol=0.0, include_lle=False, k_vis=p.k_vis,
                      visibility_threshold=p.visibility_threshold, use_visibility=True),
            visible_count=torch.tensor(30, device=self.dev),
        )
        self.time_pair("em_loop", lambda: fused_em_loop(*st.args, **st.kwargs),
                       lambda: fused_em_loop_plain(*st.args, **st.kwargs), n_kernel=20, n_plain=3)
        self.times["em_loop"]["note"] = "10 iterations (tol=0), main-pass configuration with the gate on"


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="check,loop,timing",
                    help="comma list of check,loop,timing (toolchain and build always run); "
                         "anything but all three prints no result line")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import trackdlo_tpu_torch  # noqa: F401
        from trackdlo_tpu_torch import _build
        from trackdlo_tpu_torch.device import toolchain_probe
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script ({e})", file=sys.stderr)
        return 2

    card = card_line()
    log(f"[1] card: {card}")
    probe = toolchain_probe()
    log(f"    torch {probe['torch']}, torch.version.cuda {probe['torch_cuda']}, "
        f"nvcc {probe['nvcc']}, triton {probe['triton']}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.lib()
    log(f"[2] build: {lib_path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")

    smoke = Smoke()
    if "check" in phases:
        log("[3] kernels against their plain versions on the card")
        smoke.check_preprocess()
        smoke.check_visibility()
        smoke.check_walks()
        smoke.check_em()
        torch.cuda.synchronize()
    if "loop" in phases:
        log(f"[4] closed loop: {smoke.frames} frames against the float64 oracle")
        smoke.closed_loop()
    if "timing" in phases and "loop" in phases and "check" in phases:
        log(f"[5] timing on {card}")
        smoke.timing()

    if "jax" in sys.modules:
        smoke.failures.append("jax_imported")
    record = {
        "card": card, "toolchain": probe, "metrics": smoke.metrics, "bounds": BOUNDS,
        "launches": smoke.launches, "times": smoke.times, "failures": smoke.failures,
        "phases": sorted(phases),
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    if smoke.failures:
        log(f"FAILED: {smoke.failures}")
        return 1
    if phases != {"check", "loop", "timing"}:
        log("partial run: no result line")
        return 0
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": smoke.launches[name], "max_abs_err": smoke.kernel_err[name],
            "ms": smoke.times[name]["ms"], "plain_ms": smoke.times[name]["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
