"""Kernels P and C at the main path's shapes: CUDA events, the profiler's
device time, and P with the L2 flushed before each launch.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python3 perf/preprocess_timing.py [--root DIR] [--tag NAME]

``--root`` takes the port package from an unpacked tree (e.g. an earlier
commit from ``git archive``), so that two designs are timed by the same
code: run it for each tree in turns on one card (parent, change, change,
parent). Inputs: the live 720p frame of ``chip_smoke.py`` phase 3 (t =
1/15) and 8 frames at phase offsets 0.01·b (a cohort of the batched step).

- P: the parity mode on one frame, on the frame with a depth return at
  every pixel (as a real camera gives) and on the 8 frames, and the
  one-channel modes (votes, cells) on one frame; warm (back-to-back launches) and with
  the L2 flushed (a 64 MB buffer zeroed before each launch: the frame
  arrives from the host every step).
- C: the main path's compaction of the parity sums up to the centroids,
  for 8 rows and 64 rows: in a tree with kernel C's derived mode that mode
  (one launch), else ``kept_cells``, kernel C and the division (the torch
  ops around it); the kernel alone, and the whole call with its device
  ops.

``--variant`` times the root's sources under one of the edits that
``perf/em_phase_stamps.py`` stamps beside the current design (other
tilings and block sizes of P, cluster sizes of C). Prints one line per
measurement and writes ``chiprun_out/preprocess_timing_<tag>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace(torch, fn, n, flush=None):
    """(device ms per call of the kernels by name, device ops per call) of
    ``n`` calls of ``fn`` in a profiler trace, after one warm-up call;
    ``flush`` runs before each call and is left out of the sums."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
    return by_name


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


def measure(torch, name, fn, kernel, n=200, flush=None):
    """Events over ``n`` back-to-back calls; from a trace, the device time
    of the kernels whose names hold ``kernel`` and of all device ops, per
    call; with ``flush``, the kernel's device time with it before each
    call."""
    by_name = _trace(torch, fn, n)
    is_kernel = lambda k: kernel in k
    rec = {
        "events_ms": _events_ms(torch, fn, n),
        "kernel_device_ms": sum(ms for k, (ms, _) in by_name.items() if is_kernel(k)) / n,
        "all_device_ms": sum(ms for ms, _ in by_name.values()) / n,
        "device_ops_per_call": sum(c for _, c in by_name.values()) / n,
    }
    if flush is not None:
        cold = _trace(torch, fn, n // 4, flush)
        rec["kernel_device_ms_cold_l2"] = sum(ms for k, (ms, _) in cold.items() if is_kernel(k)) / (n // 4)
    print(f"{name:28s} events {rec['events_ms']:.4f} ms; device: kernel {rec['kernel_device_ms']:.5f} ms, "
          f"all {rec['all_device_ms']:.5f} ms in {rec['device_ops_per_call']:g} ops"
          + (f"; kernel with the L2 flushed {rec['kernel_device_ms_cold_l2']:.5f} ms" if flush else ""),
          flush=True)
    return rec


def _variant_tree(root: str, name: str) -> str:
    """A copy of ``root``'s port package with the variant's edits made to
    its kernel sources; returns the copy's root."""
    import shutil

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import em_phase_stamps as stamps

    edits = {**stamps.P_EDITS, **stamps.C_EDITS}[name]
    dst = os.path.join(ROOT, "build", "preprocess_timing", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "trackdlo_tpu_torch"), os.path.join(dst, "trackdlo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src in ("cell_sums.cu", "compact.cu"):
        path = os.path.join(dst, "trackdlo_tpu_torch", "csrc", src)
        text = open(path).read()
        mine = {old: new for old, new in edits.items() if old in text}
        with open(path, "w") as f:
            f.write(stamps._edited(text, mine))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="the tree whose port package runs")
    ap.add_argument("--tag", default="current")
    ap.add_argument("--out", default=None)
    ap.add_argument("--variant", default=None,
                    help="one of perf/em_phase_stamps.py's P_EDITS or C_EDITS, applied to a copy "
                         "of the root's port package under build/preprocess_timing/")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if args.variant:
        root = _variant_tree(root, args.variant)
        args.tag = f"{args.tag}_{args.variant}"
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("preprocess_timing: CUDA is not available", file=sys.stderr)
        return 2
    from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
    from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
    from trackdlo_tpu_torch.ops import preprocess as pre
    from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card}; port package {os.path.dirname(pre.__file__)}", flush=True)
    dev = torch.device("cuda")
    p, intr = live_params(), CameraIntrinsics()
    leaf = p.downsample_leaf_size
    cell = pre.default_cell_px(leaf, intr.fx)
    cap_per = p.candidate_cap() // 8

    def frames(n):
        fr = [render_frame(SyntheticRope(), 1 / 15.0 + 0.01 * b, intr) for b in range(n)]
        rgb = torch.from_numpy(np.stack([f[0] for f in fr])).to(dev)
        depth = torch.from_numpy(np.stack([f[1] for f in fr]).view(np.int16)).to(dev)
        occ = torch.ones(depth.shape, dtype=torch.bool, device=dev)
        return (rgb[0], depth[0], occ[0]) if n == 1 else (rgb, depth, occ)

    rest = (intr.fx, intr.fy, intr.cx, intr.cy, p.hsv_lower, p.hsv_upper, p.multi_color_dlo, cell)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    out = {"card": card, "tag": args.tag}
    one, eight = frames(1), frames(8)
    out["P_parity_1"] = measure(torch, "P parity, 1 frame", lambda: cell_sums(*one, *rest, leaf),
                                "cell_sums", flush=flush)
    out["P_parity_8"] = measure(torch, "P parity, 8 frames", lambda: cell_sums(*eight, *rest, leaf),
                                "cell_sums", flush=flush)
    # The same frame with a depth return at every pixel (1.5 m behind the
    # rope), as a real camera gives: every pixel takes the HSV test.
    dense = (one[0], torch.where(one[1] == 0, torch.full_like(one[1], 1500), one[1]), one[2])
    out["P_parity_1_dense"] = measure(torch, "P parity, 1 dense frame", lambda: cell_sums(*dense, *rest, leaf),
                                      "cell_sums", flush=flush)
    out["P_votes_1"] = measure(torch, "P votes, 1 frame",
                               lambda: cell_sums(*one, *rest, leaf, parity_split=False, with_votes=True),
                               "cell_sums", flush=flush)
    out["P_cells_1"] = measure(torch, "P cells, 1 frame",
                               lambda: cell_sums(*one, *rest, None, parity_split=False), "cell_sums",
                               flush=flush)

    derived = hasattr(pre, "compact_occupied_channels")
    out["C_design"] = "derived mode" if derived else "kept_cells, kernel C, division"
    for key, sums in (("C_8_rows", cell_sums(*one, *rest, leaf)), ("C_64_rows", cell_sums(*eight, *rest, leaf))):
        xs, ys, zs, cnt = (s.reshape(-1, s.shape[-1]) for s in sums)
        if derived:
            fn = lambda: pre.compact_occupied_channels(xs, ys, zs, cnt, cap_per, True)
        else:
            def fn():
                pts, c, v = pre.compact_channels(xs, ys, zs, cnt, pre.kept_cells(cnt, cap_per), cap_per)
                return pts / torch.clamp_min(c, 1.0)[..., None], c, v
        out[key] = measure(torch, f"C to the centroids, {cnt.shape[0]} rows", fn, "compact")
    path = args.out or os.path.join(ROOT, "chiprun_out", f"preprocess_timing_{args.tag}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
