"""Where the time of a tracking step goes on the card: a torch.profiler
trace of a steady window of frames at the live profile (720p, M=45), for
``Tracker.step`` or, with ``--batch``, the batched step of that many
streams (in cohorts of ``--cohort``); ``--profile coarse`` (``parity_split=False``)
or ``cells`` (``exact_voxels=False``) for the preprocessing options.

Run on a machine with a CUDA GPU, from the repository root:

    python -m trackdlo_tpu_torch.profile_step [--frames 20] [--batch 16 --cohort 8] [--profile coarse]

Prints the per-frame wall time, the device's busy share of it, the kernel
launches and host-to-device copies per frame and the ops with the most
device time, and writes them to ``chiprun_out/profile_step.json`` (or
``profile_step_b<batch>.json``, with ``_<profile>`` for an option). Fails
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.models.trackdlo import Tracker, TrackerState
from trackdlo_tpu_torch.parallel import build_batched_step_fn


PROFILES = {"parity": {}, "coarse": {"parity_split": False}, "cells": {"exact_voxels": False}}


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
    ap.add_argument("--batch", type=int, default=1, help="streams; above 1 the batched step")
    ap.add_argument("--cohort", type=int, default=None, help="cohort size of the batched step")
    ap.add_argument("--profile", choices=sorted(PROFILES), default="parity",
                    help="preprocessing: parity split (the default profile), coarse or cells")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    params, intr, rope = live_params(**PROFILES[args.profile]), CameraIntrinsics(), SyntheticRope()
    tracker = Tracker(params, intr, device="cuda")
    b = args.batch
    if b == 1:
        state = tracker.init_from_nodes(rope.nodes(0.0, params.M))
        frames = [render_frame(rope, i / 15.0, intr) for i in range(1, 11)]
        step = tracker.step
    else:
        # Stream s at phase offset 0.01·s, as chip_smoke.py's batched loop.
        state = TrackerState(*(torch.stack(f) for f in zip(*(
            tracker.init_from_nodes(rope.nodes(0.01 * s, params.M)) for s in range(b)))))
        frames = []
        for i in range(1, 11):
            fr = [render_frame(rope, i / 15.0 + 0.01 * s, intr) for s in range(b)]
            frames.append(tuple(np.stack(f) for f in zip(*fr)))
        step = build_batched_step_fn(params, intr, cohort_size=args.cohort, device="cuda")
    for rgb, depth in frames:  # warm-up: build, first launches, allocator
        state, _ = step(state, rgb, depth)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.frames):
            rgb, depth = frames[i % len(frames)]
            state, _ = step(state, rgb, depth)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_union_us(kernels)
    top = sorted(prof.key_averages(), key=lambda a: a.device_time_total, reverse=True)[:15]
    rec = {
        "card": card,
        "profile": args.profile,
        "streams": b,
        "cohort": args.cohort,
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
    unit = "frame" if b == 1 else f"frame set of {b} streams"
    print(f"card: {card}")
    print(f"per {unit}: wall {rec['wall_ms_per_frame']:.3f} ms under the profiler; device busy "
          f"{rec['device_busy_ms_per_frame'] if kernels else 'not measured'} ms; "
          f"{rec['device_ops_per_frame']:.0f} device ops; host-to-device copies "
          f"{rec['htod_pageable_per_frame']:g} pageable, {rec['htod_pinned_per_frame']:g} pinned")
    for t in rec["top_device_ops"]:
        print(f"  {t['device_ms_per_frame']:9.4f} ms  {t['calls_per_frame']:7.1f} calls  {t['name'][:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    name = "profile_step" + ("" if b == 1 else f"_b{b}")
    name += ("" if args.profile == "parity" else f"_{args.profile}") + ".json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(rec, f, indent=1)
    if not np.isfinite(state.y.cpu().numpy()).all():
        raise SystemExit("profile_step: non-finite nodes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
