"""Evaluation harness: ground truth, error metrics, occlusion injection.

Counterpart of trackdlo_tpu/evaluation, with the same exports; the batched
metric and the occlusion sweep run on the port's device.

Reference: trackdlo/src/evaluator.cpp + run_evaluation.cpp +
utils/simulate_occlusion_eval.py — the offline integration-evaluation layer
(SURVEY.md §4.2) reproduced without ROS/rosbag: sequences come from
:mod:`trackdlo_tpu_torch.io`, occlusion is injected as masks on a deterministic
schedule, and errors stream to text files in the reference's exact format so
results are directly comparable across algorithms.
"""

from trackdlo_tpu_torch.evaluation.evaluator import (
    extract_marker_ground_truth,
    piecewise_error,
    piecewise_error_batch,
)
from trackdlo_tpu_torch.evaluation.occlusion import (
    SCENARIO_RECTS,
    OcclusionSchedule,
    gt_bbox_rect,
    rect_mask,
)
from trackdlo_tpu_torch.evaluation.runner import EvalConfig, run_evaluation

__all__ = [
    "piecewise_error",
    "piecewise_error_batch",
    "extract_marker_ground_truth",
    "OcclusionSchedule",
    "rect_mask",
    "gt_bbox_rect",
    "SCENARIO_RECTS",
    "EvalConfig",
    "run_evaluation",
]
