"""Kernel P's exact route against its other parity build, and kernels C and
X after it, on the evaluation preset's 720p frames: where the exact
route's device time goes on a clean frame.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python3 perf/exact_route_cost.py [--root DIR] [--tag NAME]

``--root`` takes the port package from an unpacked tree (an earlier commit
from ``git archive``), so that two designs are timed by the same code; a
tree without the exact route times its parity build alone. Frames (the
taped rope of ``eval.single``, ``eval_params()``, t = 0.3):

- ``clean``: no noise, no dropout, nothing occluded (every frame of the
  existing cells): the background, with no depth return, is unoccluded,
  so the exact route band-tests every one of its pixels (fault 7);
- ``clean_boxed``: the same frame occluded outside a box around the rope,
  so that the exact route's extra work there is its split check alone;
- ``noisy``: 2 mm depth noise and 5% dropout (``eval_occlusion.tip50``).

Per frame and route: P alone; P, C, X and the snap (the step's
preprocessing); on the exact route the same without X, and X alone.

Each launch sequence is captured 50 times in a CUDA graph and timed with
CUDA events over 20 replays; the median over the replays, in ms per
sequence. Prints one line per measurement and writes
``chiprun_out/exact_route_cost_<tag>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph_ms(torch, fn, n=50, reps=20) -> float:
    """Median device ms of one call of ``fn`` over ``reps`` replays of a
    graph of ``n`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--tag", default="change")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from trackdlo_tpu_torch.config import CameraIntrinsics, eval_params
    from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
    from trackdlo_tpu_torch.ops import preprocess as pre
    from trackdlo_tpu_torch.ops.preprocess_kernel import cell_sums

    has_exact = hasattr(pre, "ExactFrame")
    intr, params = CameraIntrinsics(), eval_params()
    leaf, cap = params.downsample_leaf_size, params.candidate_cap()
    cell = pre.default_cell_px(leaf, intr.fx)
    dev = torch.device("cuda")
    frames = {}
    for name, noise, dropout, boxed in (("clean", 0.0, 0.0, False), ("clean_boxed", 0.0, 0.0, True),
                                        ("noisy", 2.0, 0.05, False)):
        rgb, depth = render_frame(SyntheticRope(), 0.3, intr, depth_noise_mm=noise, seed=7,
                                  markers=12, dropout_frac=dropout)
        occ = np.ones(depth.shape, bool)
        if boxed:
            rows, cols = np.nonzero(depth)
            occ[:] = False
            occ[rows.min():rows.max() + 1, cols.min():cols.max() + 1] = True
        frames[name] = (torch.from_numpy(rgb).to(dev), torch.from_numpy(depth.view(np.int16)).to(dev),
                        torch.from_numpy(occ).to(dev), intr.fx, intr.fy, intr.cx, intr.cy,
                        params.hsv_lower, params.hsv_upper, params.multi_color_dlo, cell, leaf)
    out = {"tag": args.tag, "gpu": torch.cuda.get_device_name(), "cell_px": cell, "ms": {}}
    for name, a in frames.items():
        routes = {"parity": {}}
        if has_exact:
            routes["exact"] = {"exact": True}
        for route, kw in routes.items():
            ms = out["ms"].setdefault(f"{name}.{route}", {})
            ms["P"] = _graph_ms(torch, lambda a=a, kw=kw: cell_sums(*a, **kw))
            sums = cell_sums(*a, **kw)

            def pc(a=a, kw=kw):
                s = cell_sums(*a, **kw)
                extra = (pre.exact_frame(a, s),) if kw else ()
                return pre.compact_sums(s, params.max_points, leaf, cap, True, *extra)

            ms["P+C+X+snap"] = _graph_ms(torch, pc)
            if kw:  # the same without kernel X: X's share of the sequence
                ms["P+C+snap"] = _graph_ms(torch, lambda a=a: pre.compact_sums(
                    cell_sums(*a, exact=True)[:4], params.max_points, leaf, cap, True))
                ex = pre.exact_frame(a, sums)
                rows = pre.compact_occupied_channels(*sums[:4], cap // 8, True)
                ms["X"] = _graph_ms(  # on fresh copies of C's rows (X appends in place)
                    torch, lambda ex=ex, rows=rows: pre.split_groups(ex, *(t.clone() for t in rows)))
                torch.cuda.synchronize()
                ms["split_cells_found"] = int(sums[4].counts[..., 0].sum())
                ms["no_depth_found"] = int(sums[4].counts[..., 1].sum())
            print(f"{args.tag} {name}.{route}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in ms.items()),
                flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"exact_route_cost_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
