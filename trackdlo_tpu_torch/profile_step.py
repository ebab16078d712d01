"""Where the time of ``Tracker.step`` goes on the card: a torch.profiler
trace of a steady window of frames at the live profile (720p, M=45).

Run on a machine with a CUDA GPU, from the repository root:

    python -m trackdlo_tpu_torch.profile_step [--frames 20]

Prints the per-frame wall time, the device's busy share of it, the kernel
launches and host-to-device copies per frame and the ops with the most
device time, and writes them to
``chiprun_out/profile_step.json``. Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.models.trackdlo import Tracker


def _busy_union_us(events) -> float:
    """Length of the union of the device kernels' intervals (overlaps once)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    params, intr, rope = live_params(), CameraIntrinsics(), SyntheticRope()
    tracker = Tracker(params, intr, device="cuda")
    state = tracker.init_from_nodes(rope.nodes(0.0, params.M))
    frames = [render_frame(rope, i / 15.0, intr) for i in range(1, 11)]
    for rgb, depth in frames:  # warm-up: build, first launches, allocator
        state, _ = tracker.step(state, rgb, depth)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.frames):
            rgb, depth = frames[i % len(frames)]
            state, _ = tracker.step(state, rgb, depth)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_union_us(kernels)
    top = sorted(prof.key_averages(), key=lambda a: a.device_time_total, reverse=True)[:15]
    rec = {
        "card": card,
        "frames": args.frames,
        "wall_ms_per_frame": wall_us / 1e3 / args.frames,
        "device_busy_ms_per_frame": busy_us / 1e3 / args.frames if kernels else None,
        "device_busy_share": busy_us / wall_us if kernels else None,
        "device_ops_per_frame": len(kernels) / args.frames,
        # A copy from pageable host memory blocks the host until it is done.
        "htod_pageable_per_frame": sum("Pageable -> Device" in e.name for e in kernels) / args.frames,
        "htod_pinned_per_frame": sum("Pinned -> Device" in e.name for e in kernels) / args.frames,
        "top_device_ops": [
            {"name": a.key, "calls_per_frame": a.count / args.frames,
             "device_ms_per_frame": a.device_time_total / 1e3 / args.frames}
            for a in top
        ],
    }
    print(f"card: {card}")
    print(f"wall {rec['wall_ms_per_frame']:.3f} ms/frame under the profiler; device busy "
          f"{rec['device_busy_ms_per_frame'] if kernels else 'not measured'} ms/frame; "
          f"{rec['device_ops_per_frame']:.0f} device ops/frame; host-to-device copies/frame "
          f"{rec['htod_pageable_per_frame']:g} pageable, {rec['htod_pinned_per_frame']:g} pinned")
    for t in rec["top_device_ops"]:
        print(f"  {t['device_ms_per_frame']:9.4f} ms  {t['calls_per_frame']:7.1f}/frame  {t['name'][:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_step.json"), "w") as f:
        json.dump(rec, f, indent=1)
    if not np.isfinite(state.y.cpu().numpy()).all():
        raise SystemExit("profile_step: non-finite nodes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
