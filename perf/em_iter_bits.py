"""Kernel F's inputs and outputs on fixed EM iterations, saved bit for bit.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python3 perf/em_iter_bits.py [--root DIR] [--out PATH]

``--root`` takes the port package (and so the kernel sources) from an
unpacked tree, e.g. an earlier commit from ``git archive``; the default is
this tree. The cases are one EM iteration of ``chip_smoke.py``'s kernel-F
configurations (the main pass with the visibility gate on, the LLE term,
the priors with the gate, the main pass with the gate off) on its phase-3
cloud, from the EM origin and from the origin nudged by a seeded 1 mm
noise, and 4 streams of its batched EM inputs; each through
``fused_em_iteration`` with the c's computed as ``fused_iteration``'s plain
route computes them. Writes ``chiprun_out/em_iter_bits.npz`` (compressed):
per case its inputs (``<case>_in_<name>``), its keyword scalars
(``<case>_kw``: k_vis, tau_vis, lam, coef_lle, alpha) and kernel F's
outputs (``<case>_out_t``, ``_out_sigma2``, ``_out_delta``).
``tests/data/em_iter_bits.npz`` is such a file from the design before the
cluster E-step; ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
current kernel F to it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The order of fused_em_iteration's positional arguments.
INPUTS = ("y", "y0", "node_mask", "node_coord", "g", "hg", "hy0", "jg", "prior_disp", "x",
          "x_mask", "sigma2", "c_plain", "c_vis", "vis_gate", "v_count")
KW = ("k_vis", "tau_vis", "lam", "coef_lle", "alpha")


def iteration_inputs(st, y, s2, params):
    """fused_em_iteration's arguments for one iteration of staging ``st``,
    the c's as ``fused_iteration``'s plain route computes them."""
    dyn, y0, coord, nm, g, hg, hy0, jg, pd, x, xm = st.args
    v_count, n_safe, gate = dyn[:, 1], dyn[:, 2], dyn[:, 3]
    c_base = (6.283185307179586 * s2) ** 1.5 * params.mu / (1 - params.mu)
    args = (y.contiguous(), y0, nm, coord, g, hg, hy0, jg, pd, x, xm, s2.contiguous(),
            c_base * v_count / n_safe, c_base / n_safe, gate, v_count)
    return args, {k: st.kwargs[k] for k in KW}


def cases(torch, smoke):
    """{case: (fused_em_iteration's arguments, its keywords)}."""
    from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, em_staging

    smoke.check_preprocess()
    p, m, dev = smoke.params, smoke.params.M, smoke.dev
    nodes = torch.as_tensor(smoke.rope.nodes(0.0, m), dtype=torch.float32, device=dev)
    nm = torch.ones(m, dtype=torch.bool, device=dev)
    s2 = torch.tensor(0.001, device=dev)
    vc = torch.tensor(30, device=dev)
    x, xm = smoke.cloud.points, smoke.cloud.mask
    base = CpdParams(beta=p.beta, lam=p.lam, lle_weight=p.lle_weight, mu=p.mu, max_iter=10, tol=0.0,
                     include_lle=False, k_vis=p.k_vis, visibility_threshold=p.visibility_threshold,
                     use_visibility=True, use_fused_mstep=True)
    one = lambda a: a[None]
    noise = torch.from_numpy(np.random.default_rng(0).normal(0, 1e-3, (1, m, 3)).astype(np.float32)).to(dev)
    out = {}
    for key, change, kw in (
        ("main_gate", {}, {"visible_count": one(vc)}),
        ("lle", {"include_lle": True}, {"visible_count": one(vc)}),
        ("priors_gate", {"use_priors": True, "alpha": p.alpha},
         {"visible_count": one(vc), "prior_pos": one(nodes + 0.004),
          "prior_mask": one(torch.arange(m, device=dev) < 12)}),
        ("main_no_gate", {}, {}),
    ):
        params = dataclasses.replace(base, **change)
        st = em_staging(one(x), one(xm), one(nodes), one(nm), one(s2), params, **kw)
        y0 = st.args[1]
        out[key] = iteration_inputs(st, y0, st.args[0][:, 0], params)
        out[f"{key}_nudged"] = iteration_inputs(st, y0 + noise, st.args[0][:, 0], params)
    pc4, y4, nm4, vc4 = smoke.batch_em_inputs(4)
    st = em_staging(pc4.points, pc4.mask, y4, nm4, torch.full((4,), 0.001, device=dev), base,
                    visible_count=vc4)
    out["b4"] = iteration_inputs(st, st.args[1], st.args[0][:, 0], base)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="the tree whose port package runs")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "em_iter_bits.npz"))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("em_iter_bits: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    import trackdlo_tpu_torch
    from trackdlo_tpu_torch.ops.hopper_kernels import fused_em_iteration

    print(f"port package: {os.path.dirname(trackdlo_tpu_torch.__file__)}; "
          f"chip_smoke: {chip_smoke.__file__}", flush=True)
    arrays = {}
    for case, (fargs, kw) in cases(torch, chip_smoke.Smoke()).items():
        t, s2, delta = fused_em_iteration(*fargs, **kw)
        for name, a in zip(INPUTS, fargs):
            arrays[f"{case}_in_{name}"] = a.cpu().numpy()
        arrays[f"{case}_kw"] = np.array([kw[k] for k in KW], np.float64)
        arrays[f"{case}_out_t"] = t.cpu().numpy()
        arrays[f"{case}_out_sigma2"] = s2.cpu().numpy()
        arrays[f"{case}_out_delta"] = delta.cpu().numpy()
        print(f"{case:18s} {tuple(t.shape)} sigma2 {s2.cpu().numpy()} delta {delta.cpu().numpy()}",
              flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}")
    return 0


def load(path):
    """{case: (fused_em_iteration's arguments as numpy arrays, its keywords,
    (t, sigma2, delta))} from a file this script wrote."""
    z = np.load(path)
    out = {}
    for case in sorted({k.split("_in_")[0] for k in z.files if "_in_" in k}):
        fargs = tuple(z[f"{case}_in_{n}"] for n in INPUTS)
        kw = dict(zip(KW, (float(v) for v in z[f"{case}_kw"])))
        out[case] = (fargs, kw, tuple(z[f"{case}_out_{n}"] for n in ("t", "sigma2", "delta")))
    return out


if __name__ == "__main__":
    sys.exit(main())
