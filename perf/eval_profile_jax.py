"""The evaluation profile on the JAX package's CPU build against the float64
oracle: the cell that chip_smoke.py runs on the port (eval_params() as
shipped: M=40, 5 mm leaf, k_vis 500, multi-colour HSV; the D435 720p
intrinsics; rendered SyntheticRope frames i/15 for i = 1..frames, no
occluder), so that the port's deviation and trips on the card stand beside
the reference's own.

Per frame: the mean node distance of the JAX tracker (jitted, CPU) from the
oracle's closed loop, the JAX step's main-pass EM iterations (its
StepOutputs carry no pre-registration count) and the oracle's trips in both
passes.

Usage: python perf/eval_profile_jax.py [--frames 30] [--json PATH]
Writes perf/eval_profile_jax_cpu.json by default.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--json", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   "eval_profile_jax_cpu.json"))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from trackdlo_tpu.config import CameraIntrinsics, eval_params
    from trackdlo_tpu.io.sequence import SyntheticRope, render_frame
    from trackdlo_tpu.models.trackdlo import Tracker
    from trackdlo_tpu.oracle import tracking
    from trackdlo_tpu.oracle.pipeline import init_state, step_frame

    params, intr, rope = eval_params(), CameraIntrinsics(), SyntheticRope()
    m = params.M
    tracker = Tracker(params, intr)
    state = tracker.init_from_nodes(rope.nodes(0.0, m))
    o_state = init_state(rope.nodes(0.0, m), params)
    real = tracking.cpd_lle
    trips: list = []

    def recording(*a, **kw):
        res = real(*a, **kw)
        trips.append(int(res.iterations))
        return res

    tracking.cpd_lle = recording
    dev_mm, jax_main, oracle_trips = [], [], []
    try:
        for i in range(1, args.frames + 1):
            rgb, depth = render_frame(rope, i / 15.0, intr)
            trips.clear()
            o_state, _, _ = step_frame(o_state, rgb, depth, params, intr)
            oracle_trips.append(list(trips) if len(trips) == 2 else [0, *trips])
            state, out = tracker.step(state, rgb, depth)
            jax_main.append(int(out.iterations))
            dev_mm.append(1000 * float(np.linalg.norm(np.asarray(state.y) - o_state.y,
                                                      axis=1).mean()))
            print(f"frame {i:3d}: {dev_mm[-1]:.4f} mm, main trips {jax_main[-1]}, oracle "
                  f"{oracle_trips[-1]}", flush=True)
    finally:
        tracking.cpd_lle = real
    ot = np.array(oracle_trips)
    out = {
        "profile": "eval_params()", "frames": args.frames, "backend": jax.default_backend(),
        "mean_mm": float(np.mean(dev_mm)), "max_mm": float(np.max(dev_mm)),
        "per_frame_mm": dev_mm, "jax_main_trips_mean": float(np.mean(jax_main)),
        "oracle_pre_trips_mean": float(ot[:, 0].mean()),
        "oracle_main_trips_mean": float(ot[:, 1].mean()),
        "jax_main_trips": jax_main, "oracle_trips": oracle_trips,
    }
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    print(f"mean {out['mean_mm']:.4f} mm, max {out['max_mm']:.4f}; main trips {out['jax_main_trips_mean']}"
          f" (oracle {out['oracle_main_trips_mean']}, pre {out['oracle_pre_trips_mean']}); wrote "
          f"{args.json}")


if __name__ == "__main__":
    main()
