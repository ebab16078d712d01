"""The comparison that decides ``correct``.

The window's answers are checked on a sample of stream-frames drawn from
the seed (always the first call, from the starting nodes, then calls drawn
uniformly over the window). Each sampled stream-frame is worked out again by
the float64 reference (:mod:`portbench.reference`) from the same input:
the frame and mask the program was handed and the state it was handed (the
nodes and sigma^2 the previous call put on the host; the rest arc lengths of
the starting nodes, which the reference computes itself). The reference so
follows the program step by step from the program's own state; the first
call checks the start from the starting nodes alone.

Per stream-frame numbers, each held to its frame limit (the cell file's
``check.frame_limits``):

- ``cloud_count_delta``: points in the program's cloud against the
  reference's voxel grid;
- ``cloud_far_points``: the program's points farther than a thousandth of
  the voxel leaf from every reference point;
- ``mask_mismatch``: nodes whose visible or extended-visible flag differs;
- ``occlusion_state_mismatch``: 1 where the occlusion state differs;
- ``prior_mask_mismatch``: nodes that one side's prior walk reaches and the
  other's does not;
- ``guide_m``, ``prior_m``, ``y_m``: the farthest node of the pre-registered
  guides, of the priors both sides walked to, and of the tracked nodes (m);
- ``sigma2_rel``: |sigma^2 - reference| / reference.

Every sampled stream-frame is judged. A stream-frame is off where any of
its numbers passes its frame limit; ``frames_off`` counts them over the
sample, and ``<name>_over`` counts each number's. ``<name>_max`` is a
number's worst over the sample. The cell file's ``limits`` name the numbers
compared: ``frames_off``, held to the few stream-frames that sound runs
leave off, and the worst of each distance, held to a ceiling. A rare
stream-frame departs in sound runs: the EM passes' exit iteration makes
the step sensitive to the last bits of its input (guides millimetres off,
the prior walk one node longer or shorter), and a pixel on a voxel boundary
falls on the other side in float32 than in float64 (two centroids a
fraction of a millimetre off). A fault in one stream of a batch, or in the
occluded frames alone, leaves more stream-frames off than that.

The control (:func:`reference_step` with ``control=True``) is the
reference itself with every EM matrix product in TF32, judged in the
program's place.
"""

from __future__ import annotations

import math
import os

import numpy as np

CLOUD_TOL_LEAF = 1e-3  # cloud_far_points: a thousandth of the voxel leaf
PER_FRAME = ("cloud_count_delta", "cloud_far_points", "mask_mismatch", "occlusion_state_mismatch",
             "prior_mask_mismatch", "guide_m", "prior_m", "y_m", "sigma2_rel")


def reference_step(task: dict) -> dict:
    """The reference's step on one stream-frame: ``task`` holds the input
    state (``y``, ``sigma2``), the starting nodes (``init``), the frame
    (``rgb``, ``depth``, ``keep``), the configuration's ``tracker`` and
    ``camera`` fields and ``control`` (TF32 products; None where the
    control crashes). Runs in a worker process; imports nothing of the
    program."""
    from portbench.reference import pipeline

    params = pipeline.Params(task["tracker"])
    cam = pipeline.Camera(**task["camera"])
    start = pipeline.init_state(np.asarray(task["init"], np.float64), params)
    state = pipeline.OracleState(y=np.asarray(task["y"], np.float64), sigma2=float(task["sigma2"]),
                                 geodesic_coord=start.geodesic_coord)
    if task["control"]:
        try:
            _, res, aux = pipeline.step_frame(state, task["rgb"], task["depth"], params, cam,
                                              task["keep"], mm=pipeline.tf32_matmul)
        except (ArithmeticError, IndexError, ValueError, np.linalg.LinAlgError):
            return None  # a control that crashes gives no answer: it has failed
    else:
        _, res, aux = pipeline.step_frame(state, task["rgb"], task["depth"], params, cam,
                                          task["keep"])
    m = len(state.y)
    vis = np.zeros(m, bool)
    vis[aux["visible_nodes"]] = True
    ext = np.zeros(m, bool)
    ext[aux["visible_nodes_extended"]] = True
    pri = np.asarray(res.correspondence_priors, np.float64).reshape(-1, 4)
    prior_mask = np.zeros(m, bool)
    prior_mask[pri[:, 0].astype(int)] = True
    prior_pos = np.zeros((m, 3))
    prior_pos[pri[:, 0].astype(int)] = pri[:, 1:]
    return dict(points=np.asarray(aux["points"], np.float64), visible=vis, extended=ext,
                guides=np.asarray(res.guide_nodes, np.float64).reshape(-1, 3),
                prior_mask=prior_mask, prior_pos=prior_pos,
                occlusion_state=int(res.occlusion_state), y=np.asarray(res.y, np.float64),
                sigma2=float(res.sigma2))


def _max_dist(a, b) -> float:
    if len(a) != len(b):
        return math.inf
    if len(a) == 0:
        return 0.0
    return float(np.linalg.norm(np.asarray(a, np.float64) - b, axis=1).max())


def judge(got: dict, ref: dict, leaf: float) -> dict:
    """The per-frame numbers of one stream-frame: ``got`` (the program's
    answer, or the control's) against ``ref`` (the reference's), both as
    :func:`reference_step` returns them; no answer reads infinitely bad."""
    if got is None:
        return {k: math.inf for k in PER_FRAME}
    pts, rpts = np.asarray(got["points"], np.float64), ref["points"]
    far = len(pts)
    if len(pts) and len(rpts):
        near = np.sqrt(((pts[:, None, :] - rpts[None, :, :]) ** 2).sum(-1).min(1))
        far = int((near > CLOUD_TOL_LEAF * leaf).sum())
    elif not len(pts):
        far = 0
    pm, rpm = np.asarray(got["prior_mask"], bool), ref["prior_mask"]
    both = pm & rpm
    return dict(
        cloud_count_delta=abs(len(pts) - len(rpts)),
        cloud_far_points=far,
        mask_mismatch=int((np.asarray(got["visible"], bool) != ref["visible"]).sum()
                          + (np.asarray(got["extended"], bool) != ref["extended"]).sum()),
        occlusion_state_mismatch=int(int(got["occlusion_state"]) != ref["occlusion_state"]),
        prior_mask_mismatch=int((pm != rpm).sum()),
        guide_m=_max_dist(got["guides"], ref["guides"]),
        prior_m=_max_dist(np.asarray(got["prior_pos"])[both], ref["prior_pos"][both]),
        y_m=_max_dist(got["y"], ref["y"]),
        sigma2_rel=abs(float(got["sigma2"]) - ref["sigma2"]) / ref["sigma2"],
    )


def summary(per_frame: list[dict], frame_limits: dict) -> dict:
    """Over the sample: ``frames``, ``frames_off`` (stream-frames with any
    number past its frame limit), and each number's ``<name>_over`` (the
    stream-frames where it is past its frame limit) and ``<name>_max`` (its
    worst); NaN reads as infinitely bad."""
    if sorted(frame_limits) != sorted(PER_FRAME):
        raise KeyError(f"the frame limits must name exactly {sorted(PER_FRAME)}")
    vals = {k: [math.inf if v != v else float(v) for v in (f[k] for f in per_frame)]
            for k in PER_FRAME}
    off = [any(vals[k][i] > frame_limits[k] for k in PER_FRAME) for i in range(len(per_frame))]
    out = {"frames": len(per_frame), "frames_off": sum(off) if per_frame else math.inf}
    for k in PER_FRAME:
        out[f"{k}_over"] = sum(v > frame_limits[k] for v in vals[k])
        out[f"{k}_max"] = max(vals[k]) if per_frame else math.inf
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}} of the numbers the limits name):
    correct where each of them is at most its limit."""
    unknown = sorted(set(limits) - set(numbers))
    if unknown:
        raise KeyError(f"the cell file limits {unknown}, which the check does not compute")
    rows = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), rows


def run_reference(tasks: list[dict]) -> list[dict]:
    """:func:`reference_step` of every task, spread over worker processes
    (one NumPy thread each), the results in order."""
    if not tasks:
        return []
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    workers = max(1, min(len(tasks), (os.cpu_count() or 2) - 1, 7))
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                            "MKL_NUM_THREADS")}
    os.environ.update({k: "1" for k in saved})  # inherited by the workers only
    try:
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
            return list(pool.map(reference_step, tasks))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
