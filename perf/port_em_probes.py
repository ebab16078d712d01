"""Two probes of the port's EM on the CPU (its plain versions), beside the
card's numbers in ``chip_smoke.py``:

- ``trips``: the EM trip counts of ``Tracker.step`` over ``chip_smoke.py``'s
  30 occluded live frames against the float64 oracle's, once in closed loop
  (each side on its own state) and once from the oracle's state every frame
  (same input, so a difference is the pass's, not the trajectory's).
- ``one-point``: kernel E's plain version on the live cloud with one valid
  point, float32 against float64 and under 1e-7 m nudges of the cloud,
  after 1, 2 and 3 iterations: how far float32 itself can be held.

Run from the repository root (no GPU needed):

    python3 perf/port_em_probes.py trips
    python3 perf/port_em_probes.py one-point
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=["trips", "one-point"])
    args = ap.parse_args()
    {"trips": trips, "one-point": one_point}[args.probe]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
