"""Sequence evaluation runner.

Counterpart of trackdlo_tpu/evaluation/runner.py. ``run_evaluation`` takes
any tracker with ``step(state, rgb, depth, occlusion_mask)``: its state and
outputs are read to the host (``.cpu()`` for tensors on any device).

Reference: run_evaluation.cpp — replay a sequence, inject scheduled
occlusion, extract marker ground truth, score (E1+E2)/2 per frame, and
append "<t> <error>" lines to
``<alg>_<trial>_<pct>_<scenario>_error.txt`` (evaluator.cpp:293-328).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from trackdlo_tpu_torch.convert import to_numpy
from trackdlo_tpu_torch.evaluation.evaluator import extract_marker_ground_truth, piecewise_error
from trackdlo_tpu_torch.evaluation.occlusion import (
    SCENARIO_RECTS,
    OcclusionSchedule,
    gt_bbox_rect,
    rect_mask,
)


@dataclasses.dataclass
class EvalConfig:
    scenario: str = "stationary"
    alg: str = "trackdlo"
    trial: int = 0
    pct_occlusion: int = 25
    save_location: str | None = None
    save_errors: bool = True
    rate: float = 1.0
    dt: float = 1.0 / 15.0
    min_gt_depth: float = 0.0
    # Per-scenario GT spatial gate (evaluator.cpp:204-227): a scenario name
    # looked up in SCENARIO_GT_GATES, a callable (N,3)->mask, or None.
    # "auto" resolves from `scenario` (real-recording gates; synthetic scenes
    # keep min_gt_depth only).
    gt_gate: object = None
    # Annotated eval-image output (run_evaluation.cpp:314-388): every
    # image_interval_s of sequence time (the reference uses 0.5 s; 1.0 s for
    # the pct-occlusion scenario).
    save_images: bool = False
    image_interval_s: float = 0.5

    @property
    def error_filename(self) -> str:
        # Exact reference naming (evaluator.cpp:293-309).
        return f"{self.alg}_{self.trial}_{self.pct_occlusion}_{self.scenario}_error.txt"


@dataclasses.dataclass
class EvalResult:
    times: np.ndarray
    errors: np.ndarray
    trajectories: np.ndarray  # (F, M, 3)
    gt_sizes: np.ndarray

    @property
    def mean_error(self) -> float:
        return float(self.errors.mean()) if len(self.errors) else float("nan")


def run_evaluation(
    tracker,
    state,
    frames,
    config: EvalConfig,
    intrinsics,
    gt_nodes=None,
    schedule: OcclusionSchedule | None = None,
) -> EvalResult:
    """Run ``frames`` through ``tracker`` with scheduled occlusion and score
    each frame against ground truth.

    ``gt_nodes``: optional (F, K, 3) exact ground truth (synthetic
    sequences); otherwise ground truth is blob-extracted from tape markers
    per frame (evaluator.cpp:153-231).
    """
    schedule = schedule or OcclusionSchedule.for_scenario(config.scenario, config.rate)
    proj = intrinsics.proj_matrix()
    h, w = intrinsics.height, intrinsics.width
    gate = config.gt_gate
    if gate == "auto":
        gate = config.scenario

    head = None
    times, errors, trajs, gt_sizes = [], [], [], []
    lines = []
    next_image_t = 0.0
    for i, (rgb, depth) in enumerate(frames):
        t = (i + 1) * config.dt / config.rate
        if schedule.finished(t):
            break

        if gt_nodes is not None:
            y_true = np.asarray(gt_nodes[i])
        else:
            y_true = extract_marker_ground_truth(
                rgb, depth, intrinsics, head=head,
                min_depth=config.min_gt_depth, gate=gate,
            )
            if len(y_true) >= 2:
                head = y_true[0]

        occlusion_mask = None
        if schedule.occluding(t):
            if config.scenario in SCENARIO_RECTS:
                rect = SCENARIO_RECTS[config.scenario]
            elif len(y_true):
                rect = gt_bbox_rect(y_true, config.pct_occlusion, proj, h, w)
            else:
                rect = None
            if rect is not None:
                occlusion_mask = rect_mask(h, w, rect)

        state, out = tracker.step(state, rgb, depth, occlusion_mask)
        y_track = to_numpy(state.y)
        trajs.append(y_track)

        if schedule.recording(t) and len(y_true) >= 2:
            err = piecewise_error(y_track, y_true)
            times.append(t - schedule.start_record_at)
            errors.append(err)
            gt_sizes.append(len(y_true))
            lines.append(f"{t - schedule.start_record_at:.6f} {err:.6f}\n")

        # Annotated eval frames every image_interval_s of sequence time
        # (run_evaluation.cpp:314-388).
        if config.save_images and config.save_location and t >= next_image_t:
            from trackdlo_tpu_torch.utils.viz import draw_tracking_overlay

            os.makedirs(config.save_location, exist_ok=True)
            img = draw_tracking_overlay(
                rgb, y_track, proj,
                visible=to_numpy(out.not_self_occluded),
                occlusion_mask=occlusion_mask,
            )
            fname = (
                f"{config.alg}_{config.trial}_{config.pct_occlusion}_"
                f"{config.scenario}_{t:06.2f}.png"
            )
            try:
                import cv2

                cv2.imwrite(
                    os.path.join(config.save_location, fname), img[..., ::-1]
                )
            except ImportError:  # pragma: no cover
                import numpy as _np

                _np.save(os.path.join(config.save_location, fname + ".npy"), img)
            next_image_t = t + config.image_interval_s

    if config.save_errors and config.save_location and lines:
        os.makedirs(config.save_location, exist_ok=True)
        with open(os.path.join(config.save_location, config.error_filename), "w") as f:
            f.writelines(lines)

    return EvalResult(
        times=np.array(times),
        errors=np.array(errors),
        trajectories=np.array(trajs),
        gt_sizes=np.array(gt_sizes),
    )
