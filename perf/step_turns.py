"""The 45-node parity step (one CUDA graph) of two trees, timed in turns.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python3 perf/step_turns.py --parent DIR [--frames 100] [--order pccp]

``DIR`` is an unpacked earlier tree (e.g. the parent commit from ``git
archive``). Each turn is a process of its own that imports the port package
of its tree (``p`` the parent, ``c`` this tree), builds that tree's kernels
(cached in the tree's ``build/``), steps ``Tracker.step`` (``live_params()``,
the 720p camera) over the 30 occluded frames of ``chip_smoke.py``'s closed
loop, 10 frames of warm-up, then ``--frames`` frames timed by CUDA events
around each step. The turns run one after another in ``--order`` (parent,
change, change, parent by default), so both trees share the card and its
power limit. Prints each turn's median and p90 and writes
``chiprun_out/step_turns.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch.models.trackdlo import Tracker

params, intr, rope = live_params(), CameraIntrinsics(), SyntheticRope()
frames = []
for i in range(1, 31):
    rgb, depth = render_frame(rope, i / 15.0, intr)
    occ = np.ones((intr.height, intr.width), np.uint8) * 255
    if 10 <= i <= 20:
        occ[:, 500:800] = 0
    frames.append((rgb, depth, occ))
tracker = Tracker(params, intr, device="cuda")
state = tracker.init_from_nodes(rope.nodes(0.0, params.M))
for i in range(10):
    state, _ = tracker.step(state, *frames[i % 30])
torch.cuda.synchronize()
ms = []
for i in range(int(sys.argv[2])):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, _ = tracker.step(state, *frames[i % 30])
    end.record()
    end.synchronize()
    ms.append(start.elapsed_time(end))
print(json.dumps({"median_ms": statistics.median(ms), "p90_ms": float(np.percentile(ms, 90)),
                  "calls": len(ms)}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the unpacked earlier tree")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--order", default="pccp")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    roots = {"p": os.path.abspath(args.parent), "c": ROOT}
    turns = []
    for t in args.order:
        res = subprocess.run([sys.executable, "-c", TURN, roots[t], str(args.frames)],
                             capture_output=True, text=True, cwd=roots[t])
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        rec["tree"] = "parent" if t == "p" else "change"
        turns.append(rec)
        print(f"{rec['tree']:7s} median {rec['median_ms']:.3f} ms, p90 {rec['p90_ms']:.3f} ms "
              f"({rec['calls']} steps)", flush=True)
    print(card)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "step_turns.json"), "w") as f:
        json.dump({"card": card, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
