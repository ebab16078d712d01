"""Kernel P's outputs on fixed frames, saved bit for bit.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python3 perf/preprocess_bits.py [--root DIR] [--out PATH]

``--root`` takes the port package (and so the kernel sources) from an
unpacked tree, e.g. an earlier commit from ``git archive``; the default is
this tree. The frames are rendered from ``SyntheticRope`` (no noise, so the
same on any machine): one frame and a batch of 4 streams at the live 720p
intrinsics, at a quarter of them, at an odd size (313 x 177, a width
that is no multiple of 16) and at a quarter of them with cells of 110
pixels (too large for kernel P to stage their pixels' values); each
through kernel P's three modes (parity channel grids, one channel with the
floor votes, one channel without a leaf). Writes
``chiprun_out/preprocess_bits.npz`` (compressed), one array per output,
named ``<case>_<mode>_<index>``; ``tests/data/preprocess_bits.npz`` is such
a file, and ``tests/test_torch_cuda.py`` holds kernel P to it with the
inputs from :func:`cases`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAF = 0.008
# mode: (voxel_leaf, parity_split, with_votes)
MODES = {"parity": (LEAF, True, False), "votes": (LEAF, False, True), "cells": (None, False, False)}


def _intrinsics():
    from trackdlo_tpu_torch.config import CameraIntrinsics

    live = CameraIntrinsics()
    quarter = CameraIntrinsics(fx=live.fx / 4, fy=live.fy / 4, cx=live.cx / 4, cy=live.cy / 4,
                               width=live.width // 4, height=live.height // 4)
    odd = CameraIntrinsics(fx=live.fx / 4, fy=live.fy / 4, cx=live.cx / 4 - 3, cy=live.cy / 4 - 1,
                           width=313, height=177)
    # (intrinsics, rope radius in pixels, cell_px or None for the leaf's)
    return {"live": (live, 9, None), "quarter": (quarter, 3, None), "odd": (odd, 3, None),
            "big": (quarter, 3, 110)}


def cases(torch, dev):
    """{case: (frame tensors (rgb, depth as int16, occlusion mask), the
    arguments of ``cell_sums`` after them but for the leaf)}: for each
    intrinsics a single occluded frame and a batch of 4 streams (odd
    streams occluded), at t = 1/15 (+ 0.01 per stream)."""
    from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
    from trackdlo_tpu_torch.config import live_params
    from trackdlo_tpu_torch.ops.preprocess import default_cell_px

    params = live_params()
    out = {}
    for name, (intr, radius, cell) in _intrinsics().items():
        cell = cell or default_cell_px(LEAF, intr.fx)
        rest = (intr.fx, intr.fy, intr.cx, intr.cy, params.hsv_lower, params.hsv_upper,
                params.multi_color_dlo, cell)
        band = slice(int(0.39 * intr.width), int(0.625 * intr.width))
        for n in (1, 4):
            fr = [render_frame(SyntheticRope(), 1 / 15.0 + 0.01 * b, intr, rope_pixel_radius=radius)
                  for b in range(n)]
            occ = np.ones((n, intr.height, intr.width), bool)
            occ[(0 if n == 1 else 1)::2, :, band] = False
            frame = (np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr]).view(np.int16), occ)
            if n == 1:
                frame = tuple(a[0] for a in frame)
            key = name if n == 1 else f"{name}_b4"
            out[key] = (tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in frame), rest)
    return out


def run_modes(cell_sums, frame, rest):
    """{mode: kernel P's outputs} for one case."""
    out = {}
    for mode, (leaf, parity, votes) in MODES.items():
        out[mode] = cell_sums(*frame, *rest, leaf, parity_split=parity, with_votes=votes)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="the tree whose port package runs")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "preprocess_bits.npz"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("preprocess_bits: CUDA is not available", file=sys.stderr)
        return 2
    from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums

    import trackdlo_tpu_torch

    print(f"port package: {os.path.dirname(trackdlo_tpu_torch.__file__)}", flush=True)
    arrays = {}
    for case, (frame, rest) in cases(torch, torch.device("cuda")).items():
        for mode, outs in run_modes(cell_sums, frame, rest).items():
            for i, o in enumerate(outs):
                arrays[f"{case}_{mode}_{i}"] = o.cpu().numpy()
            print(f"{case:10s} {mode:7s} {len(outs)} x {tuple(outs[0].shape)}, "
                  f"{int((outs[3] > 0).sum())} occupied", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
