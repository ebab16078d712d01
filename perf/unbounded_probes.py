"""Probes of the node-unbounded builds' accuracy on the long-cable cell.

Run from the repository root:

    python3 perf/unbounded_probes.py cable          # on a machine with an NVIDIA GPU
    python3 perf/unbounded_probes.py solve          # on that machine, after ``cable``
    python3 perf/unbounded_probes.py emulate [--system PATH]   # anywhere (numpy)
    python3 perf/unbounded_probes.py oracle [--frames 15]      # anywhere (CPU)

``cable``: the long-cable cell of ``chip_smoke.py`` (256 nodes on a 1.6 m
cable 1.2 m from the 720p camera, painter 8 px) through the eager step on the
card for frames 1 and 2; every EM pass of those frames through kernel E and
its plain version (their trips and distance), and 1, 2 and 3 iterations of
each pass through kernel E, the plain version and the plain version in
float64 (each one's distance from float64, and sigma^2). Saves frame 2's
pre-registration staging and its first M-step system (from the plain
float32 E-step) to ``chiprun_out/unbounded_cable.npz``.

``solve``: that system through kernel G (w and T = Y0 + G w), through its
plain version (LU) and in float64; then its leading 128 and 129 rows and
columns (the wide build and the unbounded build on nearly the same system).

``emulate``: the equilibrated Gauss-Jordan of that system in numpy, its
elimination in float32 or in float64, with 3 or 10 refinement steps whose
residual is exact, and T's error from float64: what the elimination's
precision and the refinement count give, apart from the kernels' sums.

``oracle``: the long-cable cell's closed loop through the port's plain
versions on the CPU beside the float64 oracle: each frame's mean node
distance between them and from the rendered cable (what the float32 port
itself gives on that cell, with no kernel).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "unbounded_cable.npz")


def cable() -> None:
    import numpy as np
    import torch

    from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
    from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
    from trackdlo_tpu_torch.models.trackdlo import build_step_fn, init_state
    from trackdlo_tpu_torch.ops import cpd_lle as tc
    from trackdlo_tpu_torch.ops import hopper_kernels as hk

    m, intr = 256, CameraIntrinsics()
    rope = SyntheticRope(length=1.6, depth=1.2)
    p = live_params(num_of_nodes=m, dlo_pixel_width=8)
    occ = torch.ones((intr.height, intr.width), dtype=torch.bool, device="cuda")
    calls, real = [], tc.fused_em_loop

    def recording(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    tc.fused_em_loop = recording
    step = build_step_fn(p, intr, jit=False, device="cuda")
    state = init_state(rope.nodes(0.0, m), p, "cuda")
    for i in (1, 2):
        rgb, depth = render_frame(rope, i / 15.0, intr, rope_pixel_radius=3)
        calls.clear()
        state, out = step(state, rgb, depth, occ)
        print(f"frame {i}: trips {int(out.guide_iterations)} / {int(out.iterations)}", flush=True)
        for j, (a, k) in enumerate(calls):
            yk, sk = real(*a, **k)
            yp, sp = hk.fused_em_loop_plain(*a, **k)
            print(f"  pass {j}: kernel {int(sk[1])} trips, plain {int(sp[1])}, apart "
                  f"{float((yk - yp).abs().max()):.3g} m", flush=True)
            for it in (1, 2, 3):
                kk = dict(k, max_iter=it, tol=0.0)
                yk, sk = real(*a, **kk)
                yp, sp = hk.fused_em_loop_plain(*a, **kk)
                y64, s64 = hk.fused_em_loop_plain(*(t.double() for t in a), **kk)
                print(f"    {it} iterations: from float64 kernel "
                      f"{float((yk.double() - y64).abs().max()):.3g} m, plain "
                      f"{float((yp.double() - y64).abs().max()):.3g} m; sigma2 kernel "
                      f"{float(sk[0]):.4g}, plain {float(sp[0]):.4g}, float64 {float(s64[0]):.4g}",
                      flush=True)
            if i == 2 and j == 0:
                ph = hk.EmPhasesPlain(*a, **{n: k[n] for n in (
                    "muf", "k_vis", "tau_vis", "lam", "coef_lle", "alpha")})
                p1, px, _, _ = ph.estep(a[1], a[0][0])
                sys_a, sys_b = ph.mstep(p1, px, a[0][0])
                os.makedirs(os.path.dirname(OUT), exist_ok=True)
                np.savez(OUT, a=sys_a.cpu().numpy(), b=sys_b.cpu().numpy(),
                         g=a[4].cpu().numpy(), y0=a[1].cpu().numpy())
    tc.fused_em_loop = real


def solve() -> None:
    import numpy as np
    import torch

    from trackdlo_tpu_torch.ops import hopper_kernels as hk

    d = np.load(OUT)
    full = [torch.from_numpy(d[k]).cuda()[None] for k in ("a", "b", "g", "y0")]
    for m in (full[0].shape[1], 128, 129):
        a, b, g, y0 = (t[:, :m, :m] if t.shape[2] == t.shape[1] else t[:, :m] for t in full)
        a, b, g, y0 = (t.contiguous() for t in (a, b, g, y0))
        w64 = torch.linalg.solve(a.double(), b.double())
        t64 = y0.double() + g.double() @ w64
        for name, fn in (("kernel G", hk.gauss_jordan_solve_batched),
                         ("plain (LU)", hk.gauss_jordan_solve_batched_plain)):
            w, t = fn(a, b, g, y0)
            print(f"m={m} {name}: w {float((w.double() - w64).abs().max()):.3g} and T "
                  f"{float((t.double() - t64).abs().max()):.3g} m from float64; cond "
                  f"{float(torch.linalg.cond(a[0].double())):.3g}", flush=True)


def emulate(path: str) -> None:
    import numpy as np

    d = np.load(path)
    a, b, g, y0 = d["a"], d["b"], d["g"], d["y0"]
    m = a.shape[0]
    w64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    t64 = y0 + g.astype(np.float64) @ w64
    dmax = np.abs(a).max(1)
    e = np.exp2(np.floor(np.log2(dmax)) + 1).astype(np.float32)  # kernel E's rule
    ae, be = (a / e[:, None]).astype(np.float32), (b / e[:, None]).astype(np.float32)
    exact = lambda mat, w: (mat.astype(np.float64) @ w.astype(np.float64)).astype(np.float32)
    for dt in (np.float32, np.float64):
        aug = np.concatenate([ae, np.eye(m, dtype=np.float32), be], 1).astype(dt)
        used, perm, diag = np.zeros(m, bool), np.zeros(m, int), np.zeros(m, dt)
        for k in range(m):
            p = int(np.argmax(np.where(used, -1, np.abs(aug[:, k]))))
            pv = aug[p, k]
            f = (aug[:, k] / (pv if pv != 0 else dt(1))).astype(dt)
            f[p] = 0
            aug = (aug - f[:, None] * aug[p][None, :]).astype(dt)
            used[p], perm[k], diag[k] = True, p, pv
        inv = aug[perm, m:2 * m] / diag[:, None]
        w0 = (aug[perm, 2 * m:] / diag[:, None]).astype(np.float32)
        for steps in (3, 10):
            w = w0.copy()
            for _ in range(steps):
                res = ((b - exact(a, w)) / e[:, None]).astype(np.float32)
                w = (w.astype(np.float64) + (inv.astype(np.float64) @ res)).astype(np.float32)
            t = (y0 + exact(g, w)).astype(np.float32)
            print(f"{np.dtype(dt).name} elimination, {steps} steps: T "
                  f"{float(np.abs(t - t64).max()):.3g} m from float64", flush=True)


def oracle(n_frames: int) -> None:
    import numpy as np

    from trackdlo_tpu_torch.config import CameraIntrinsics, live_params
    from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame
    from trackdlo_tpu_torch.models.trackdlo import Tracker
    from trackdlo_tpu_torch.oracle.pipeline import init_state, step_frame

    m, intr = 256, CameraIntrinsics()
    rope = SyntheticRope(length=1.6, depth=1.2)
    p = live_params(num_of_nodes=m, dlo_pixel_width=8)
    tracker = Tracker(p, intr, device="cpu")
    state = tracker.init_from_nodes(rope.nodes(0.0, m))
    o_state = init_state(rope.nodes(0.0, m), p)
    occ = np.ones((intr.height, intr.width), np.uint8) * 255
    apart = []
    for i in range(1, n_frames + 1):
        rgb, depth = render_frame(rope, i / 15.0, intr, rope_pixel_radius=3)
        state, _ = tracker.step(state, rgb, depth, occ)
        o_state, _, _ = step_frame(o_state, rgb, depth, p, intr, occ)
        y, gt = state.y.numpy(), rope.nodes(i / 15.0, m)
        apart.append(1000 * float(np.linalg.norm(y - o_state.y, axis=1).mean()))
        print(f"frame {i}: port from the oracle {apart[-1]:.3f} mm, port from the cable "
              f"{1000 * float(np.linalg.norm(y - gt, axis=1).mean()):.3f} mm, oracle from the "
              f"cable {1000 * float(np.linalg.norm(o_state.y - gt, axis=1).mean()):.3f} mm",
              flush=True)
    print(f"mean over {n_frames} frames: {np.mean(apart):.4f} mm; over the first 10: "
          f"{np.mean(apart[:10]):.4f} mm")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("cable", "solve", "emulate", "oracle"))
    ap.add_argument("--system", default=OUT)
    ap.add_argument("--frames", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    {"cable": cable, "solve": solve, "emulate": lambda: emulate(args.system),
     "oracle": lambda: oracle(args.frames)}[args.probe]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
