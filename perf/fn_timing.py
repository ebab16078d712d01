"""Kernels F and N timed on their paths' inputs, for an A/B of two trees.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python3 perf/fn_timing.py [--root DIR] [--tag T]

``--root`` takes the port package and its ``chip_smoke.py`` from an unpacked
tree (e.g. an earlier commit from ``git archive``); the default is this
tree. Run it for two trees in turns in one call (A, B, B, A) to compare
them. On ``chip_smoke.py``'s phase-3 cloud (frame 1, 2048 rows):

- kernel F: one iteration of the main-pass configuration with the gate on
  through ``fused_iteration`` (one stream), beside one iteration of the
  per-iteration route (kernel S, the M-step assembly in torch, kernel G);
  a live ``cpd_lle(use_fused_mstep=True)`` call (the live tolerance);
- kernel N: the live nodes against the first 1024 rows (a rank's shard of
  two) with bool masks and with float32 masks (``em_staging``'s, the
  sharded route's).

Each by CUDA events (two runs of back-to-back calls) and by the device time
and device ops per call of a ``torch.profiler`` trace. Writes
``chiprun_out/fn_timing_<tag>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="the tree whose port package runs")
    ap.add_argument("--tag", default="current")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("fn_timing: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from trackdlo_tpu_torch.ops.cpd_lle import (
        CpdParams, _estep_one_stream, cpd_lle, em_staging, fused_iteration, iteration_route,
    )
    from trackdlo_tpu_torch.ops.hopper_kernels import nearest_point_sq

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    smoke = chip_smoke.Smoke()
    smoke.check_preprocess()
    p, m, dev = smoke.params, smoke.params.M, smoke.dev

    def timed(fn, n=50):
        runs = [smoke.event_ms(fn, n) for _ in range(2)]
        device_ms, ops = smoke.device_ms(fn, n)
        return {"ms": sum(runs) / 2, "ms_runs": runs, "device_ms": device_ms,
                "device_ops_per_call": ops}

    nodes = torch.as_tensor(smoke.rope.nodes(0.0, m), dtype=torch.float32, device=dev)
    nm = torch.ones(m, dtype=torch.bool, device=dev)
    s2 = torch.tensor(0.001, device=dev)
    vc = torch.tensor(30, device=dev)
    x, xm = smoke.cloud.points, smoke.cloud.mask
    main_p = CpdParams(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=10, tol=0.0,
                       include_lle=False, k_vis=p.k_vis, visibility_threshold=p.visibility_threshold,
                       use_visibility=True, use_fused_mstep=True)
    one = lambda a: a[None]
    st1 = em_staging(one(x), one(xm), one(nodes), one(nm), one(s2), main_p, visible_count=one(vc))
    y1, s21 = st1.args[1], st1.args[0][:, 0]
    rec = {"card": card, "root": os.path.abspath(args.root), "tag": args.tag}
    rec["f_iteration"] = timed(lambda: fused_iteration(st1, y1, s21, main_p))
    route = iteration_route(st1, dataclasses.replace(main_p, use_fused_mstep=False), _estep_one_stream)
    rec["periter_route"] = timed(lambda: route(y1, s21))
    live = dataclasses.replace(main_p, max_iter=p.max_iter, tol=p.tol)
    call = lambda: cpd_lle(x, xm, nodes, nm, s2, live, visible_count=vc)
    rec["live_call"] = {**timed(call, 20), "iterations": int(call().iterations)}
    half = x.shape[0] // 2
    n_bool = (nodes, nm, x[:half], xm[:half])
    n_float = (nodes, nm.to(torch.float32), x[:half], xm[:half].to(torch.float32))
    rec["nearest_bool_masks"] = timed(lambda: nearest_point_sq(*n_bool))
    rec["nearest_float_masks"] = timed(lambda: nearest_point_sq(*n_float))
    for k, v in rec.items():
        if isinstance(v, dict):
            print(f"{args.tag:8s} {k:20s} events {v['ms']:.4f} ms {[round(r, 4) for r in v['ms_runs']]}, "
                  f"device {v['device_ms']:.4f} ms in {v['device_ops_per_call']:g} ops", flush=True)
    out = os.path.join(ROOT, "chiprun_out", f"fn_timing_{args.tag}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
