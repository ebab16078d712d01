"""Two probes of the port's EM on the CPU (its plain versions), beside the
card's numbers in ``chip_smoke.py``:

- ``trips``: the EM trip counts of ``Tracker.step`` over ``chip_smoke.py``'s
  30 occluded live frames against the float64 oracle's, once in closed loop
  (each side on its own state) and once from the oracle's state every frame
  (same input, so a difference is the pass's, not the trajectory's).
- ``one-point``: kernel E's plain version on the live cloud with one valid
  point, float32 against float64 and under 1e-7 m nudges of the cloud,
  after 1, 2 and 3 iterations: how far float32 itself can be held.

- ``b1``: the pre-registration pass on frames 3, 9, 24 and 25 of that run,
  each from the float64 oracle's state, through kernel E (on the card) and
  through the JAX package's own B1 kernel (``fused_em_loop`` interpreted, on
  the CPU), on the same staged inputs, beside the oracle's trips and the
  port's plain version's. On a card (``--device cuda``) it stages each
  frame's pass on the card, runs kernel E and writes the staged inputs and
  E's trips to ``chiprun_out/b1_frames.npz``; on the CPU (the default) it
  reads that file (``--inputs``), or stages on the CPU where none is given,
  and runs B1 (this needs JAX and the JAX package) and the plain version.

Run from the repository root (no GPU needed but for ``b1 --device cuda``):

    python3 perf/port_em_probes.py trips
    python3 perf/port_em_probes.py one-point
    python3 perf/port_em_probes.py b1 --device cuda     # on the card
    python3 perf/port_em_probes.py b1 --inputs chiprun_out/b1_frames.npz

``--deltas N`` adds each route's per-iteration delta trace over N
iterations (the pass rerun with tol 0 and max_iter 1 .. N); on the card it
can start from the staged inputs of an earlier run (``--inputs``).
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


B1_FRAMES = (3, 9, 24, 25)
B1_ARGS = ("dyn", "y0", "coord", "nm", "g", "hg", "hy0", "jg", "pd", "x", "xm")


def _stage_prereg(device: str) -> dict:
    """The pre-registration pass's staged inputs of ``Tracker.step`` from the
    float64 oracle's state on each of B1_FRAMES, and the trips of kernel E
    (on a card) or of the plain version (on the CPU) and of the oracle."""
    import chip_smoke
    from trackdlo_tpu_torch.models.trackdlo import Tracker, TrackerState
    from trackdlo_tpu_torch.ops import cpd_lle
    from trackdlo_tpu_torch.oracle.pipeline import init_state, step_frame

    smoke = chip_smoke.Smoke()
    p, intr, m = smoke.params, smoke.intr, smoke.params.M
    tracker = Tracker(p, intr, device=device)
    start = tracker.init_from_nodes(smoke.rope.nodes(0.0, m))
    oracle = init_state(smoke.rope.nodes(0.0, m), p)
    calls, real = [], cpd_lle.fused_em_loop

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(([a.cpu().numpy() for a in args], kwargs, int(out[1][1])))
        return out

    rec = {"frames": np.array(B1_FRAMES)}
    cpd_lle.fused_em_loop = recording
    try:
        for i in range(1, max(B1_FRAMES) + 1):
            rgb, depth, occ = smoke.frame(i / 15.0, occlude=10 <= i <= 20)
            if i in B1_FRAMES:
                same = TrackerState(torch.as_tensor(oracle.y, dtype=torch.float32, device=device),
                                    torch.tensor(float(oracle.sigma2), device=device),
                                    start.geodesic_coord)
                calls.clear()
                tracker.step(same, rgb, depth, occ)
                args, kwargs, trips = calls[0]  # the pre-registration pass
                for name, a in zip(B1_ARGS, args):
                    rec[f"f{i}_{name}"] = a
                rec[f"f{i}_kwargs"] = np.array([kwargs[k] for k in sorted(kwargs)], np.float64)
                rec[f"f{i}_trips"] = trips
            with chip_smoke.oracle_trip_counts() as t:
                oracle, _, _ = step_frame(oracle, rgb, depth, p, intr, occ)
            if i in B1_FRAMES:
                rec[f"f{i}_oracle_trips"] = (t if len(t) == 2 else [0, *t])[0]
    finally:
        cpd_lle.fused_em_loop = real
    rec["kwarg_names"] = np.array(sorted(kwargs))
    return rec


def _b1_interpreted(rec: dict, i: int, kw: dict) -> tuple[float, int]:
    """The JAX package's fused_em_loop, interpreted, on frame i's staged
    inputs (padded as its own staging pads them) with the loop constants
    ``kw``; returns its last delta and its trips."""
    import jax
    import jax.numpy as jnp

    from trackdlo_tpu.ops.pallas_kernels import fused_em_loop, pack_points

    a = {k: rec[f"f{i}_{k}"] for k in B1_ARGS}
    m, m_pad = a["y0"].shape[0], (a["y0"].shape[0] + 7) // 8 * 8
    f32 = jnp.float32
    pad_m3 = lambda v: jnp.zeros((m_pad, 3), f32).at[:m].set(jnp.asarray(v))
    pad_mm = lambda v: jnp.zeros((m_pad, m_pad), f32).at[:m, :m].set(jnp.asarray(v))
    pad_col = lambda v: jnp.zeros((m_pad, 1), f32).at[:m, 0].set(jnp.asarray(v))
    sigma2, v_count, n_safe, gate = (jnp.asarray(v, f32) for v in a["dyn"])
    muf = jnp.asarray(kw["muf"], f32)
    zero = jnp.zeros((), f32)
    scal = jnp.broadcast_to(jnp.stack([sigma2, muf * v_count / n_safe, muf / n_safe, gate, v_count,
                                       zero, zero, zero])[:, None], (8, 128))
    xt, xmp = pack_points(jnp.asarray(a["x"]), jnp.asarray(a["xm"]) > 0)
    with jax.default_device(jax.devices("cpu")[0]):
        _, stats = fused_em_loop(
            scal, pad_m3(a["y0"]), pad_col(a["coord"]), pad_col(a["nm"]), pad_mm(a["g"]),
            pad_mm(a["hg"]), pad_m3(a["hy0"]), pad_mm(a["jg"]), pad_m3(a["pd"]), xt, xmp,
            k_vis=kw["k_vis"], tau_vis=kw["tau_vis"], lam=kw["lam"], coef_lle=kw["coef_lle"],
            alpha=kw["alpha"], tol=kw["tol"], max_iter=int(kw["max_iter"]), interpret=True)
    stats = np.asarray(stats)
    return float(stats[0, 3]), int(stats[0, 1])


def _frame_kwargs(rec: dict, i: int) -> dict:
    kw = dict(zip([str(k) for k in rec["kwarg_names"]], rec[f"f{i}_kwargs"].tolist()))
    kw["max_iter"] = int(kw["max_iter"])
    return kw


def _delta_trace(run, kw: dict, n: int) -> list[float]:
    """Each iteration's mean node move over the first n iterations: the
    pass run with tol 0 and max_iter 1 .. n, the last iteration's delta."""
    return [run(dict(kw, tol=0.0, max_iter=t)) for t in range(1, n + 1)]


def b1(device: str, inputs: str | None, deltas: int) -> None:
    """Trips (and, with ``deltas``, the per-iteration delta traces) of the
    pre-registration pass on B1_FRAMES; see the module docstring."""
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_loop, fused_em_loop_plain

    if device != "cpu":
        rec = dict(np.load(inputs)) if inputs else _stage_prereg(device)
        if deltas:
            for i in B1_FRAMES:
                args = [torch.from_numpy(rec[f"f{i}_{k}"]).to(device) for k in B1_ARGS]
                rec[f"f{i}_kernel_deltas"] = np.array(_delta_trace(
                    lambda kw: float(fused_em_loop(*args, **kw)[1][3]), _frame_kwargs(rec, i), deltas))
        out = os.path.join(ROOT, "chiprun_out", "b1_frames.npz")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.savez(out, **rec)
        print(f"kernel E trips {[int(rec[f'f{i}_trips']) for i in B1_FRAMES]}, oracle "
              f"{[int(rec[f'f{i}_oracle_trips']) for i in B1_FRAMES]} on frames {list(B1_FRAMES)}; "
              f"staged inputs in {out}")
        return
    rec = dict(np.load(inputs)) if inputs else _stage_prereg("cpu")
    who = "kernel E (card)" if inputs else "plain (CPU)"
    for i in B1_FRAMES:
        kw = _frame_kwargs(rec, i)
        args = [torch.from_numpy(rec[f"f{i}_{k}"]) for k in B1_ARGS]
        plain = int(fused_em_loop_plain(*args, **kw)[1][1])
        print(f"frame {i}: oracle {int(rec[f'f{i}_oracle_trips'])}, {who} {int(rec[f'f{i}_trips'])}, "
              f"plain on these inputs {plain}, B1 interpreted {_b1_interpreted(rec, i, kw)[1]}",
              flush=True)
        if deltas:
            traces = {"B1": _delta_trace(lambda k: _b1_interpreted(rec, i, k)[0], kw, deltas),
                      "plain": _delta_trace(lambda k: float(fused_em_loop_plain(*args, **k)[1][3]),
                                            kw, deltas)}
            if f"f{i}_kernel_deltas" in rec:
                traces["kernel E"] = rec[f"f{i}_kernel_deltas"].tolist()
            for name, tr in traces.items():
                print(f"  deltas, {name:8s}: {[float(f'{v:.6g}') for v in tr]}")
            if "kernel E" in traces:
                first = next((t + 1 for t, (a, b) in enumerate(zip(traces["B1"], traces["kernel E"]))
                              if a != b), None)
                print(f"  first iteration whose delta differs between B1 and kernel E: {first}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=["trips", "one-point", "b1"])
    ap.add_argument("--device", default="cpu", help="b1: cuda to stage and run kernel E on the card")
    ap.add_argument("--inputs", help="b1: the staged inputs written on the card")
    ap.add_argument("--deltas", type=int, default=0,
                    help="b1: also each route's delta trace over this many iterations (tol 0)")
    args = ap.parse_args()
    if args.probe == "b1":
        b1(args.device, args.inputs, args.deltas)
    else:
        {"trips": trips, "one-point": one_point}[args.probe]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
