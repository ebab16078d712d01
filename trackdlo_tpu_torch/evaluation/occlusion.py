"""Occlusion injection: schedules and rectangle providers.

Reference: run_evaluation.cpp:112-282 (per-scenario rectangles and the
pct-occlusion bounding-box projection) + utils/simulate_occlusion_eval.py
(corners → mask). The wall-clock schedule (start_record_at,
wait_before_occlusion, exit_at at a bag_rate, run_evaluation.cpp:46-112,
launch/evaluation.launch:29-49) is reproduced in frame time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Hardcoded occlusion rectangles per scenario (run_evaluation.cpp:235-277):
# (top_left_x, top_left_y, bottom_right_x, bottom_right_y).
SCENARIO_RECTS = {
    "perpendicular_motion": (840, 408, 1191, 678),
    "parallel_motion": (780, 120, 1050, 290),
    "short_rope_folding": (543, 276, 738, 383),
    "short_rope_stationary": (300, 317, 698, 440),
}

# Per-scenario schedules (launch/evaluation.launch:29-49); seconds.
SCENARIO_SCHEDULES = {
    "stationary": (8.0, 5.0, 33.0),
    "perpendicular_motion": (5.0, 3.0, None),
    "parallel_motion": (6.0, 3.0, None),
    "self_occlusion": (3.0, 0.0, None),
    "short_rope_folding": (1.0, 0.0, 14.5),
    "short_rope_stationary": (1.0, 0.0, 31.0),
}


@dataclasses.dataclass(frozen=True)
class OcclusionSchedule:
    """When to record and when to occlude, in sequence time."""

    start_record_at: float = 0.0
    wait_before_occlusion: float = 0.0
    exit_at: float | None = None
    rate: float = 1.0

    @classmethod
    def for_scenario(cls, scenario: str, rate: float = 1.0) -> "OcclusionSchedule":
        start, wait, exit_at = SCENARIO_SCHEDULES[scenario]
        return cls(start_record_at=start, wait_before_occlusion=wait, exit_at=exit_at, rate=rate)

    def recording(self, t: float) -> bool:
        return t > self.start_record_at

    def occluding(self, t: float) -> bool:
        return t > self.start_record_at + self.wait_before_occlusion

    def finished(self, t: float) -> bool:
        return self.exit_at is not None and t > self.exit_at


def rect_mask(height: int, width: int, rect) -> np.ndarray:
    """Boolean keep-mask with the rectangle blacked out (the
    /mask_with_occlusion equivalent, simulate_occlusion_eval.py)."""
    x1, y1, x2, y2 = rect
    mask = np.ones((height, width), bool)
    x1 = max(int(x1), 0)
    y1 = max(int(y1), 0)
    x2 = min(int(x2), width - 1)
    y2 = min(int(y2), height - 1)
    if x2 >= x1 and y2 >= y1:
        mask[y1 : y2 + 1, x1 : x2 + 1] = False
    return mask


def gt_bbox_rect(
    y_true: np.ndarray,
    pct_occlusion: float,
    proj_matrix: np.ndarray,
    height: int,
    width: int,
    extra_border: int = 30,
):
    """Occlude the first pct% of ground-truth nodes: 3-D bbox of those nodes
    projected to pixels + border (run_evaluation.cpp:113-232).

    Returns the rectangle or None when pct rounds to zero nodes.
    """
    n_occ = int(len(y_true) * pct_occlusion / 100.0)
    if n_occ == 0:
        return None
    sel = y_true[:n_occ]
    corners = np.stack([sel.min(axis=0), sel.max(axis=0)])
    h = np.hstack([corners, np.ones((2, 1))])
    img = (proj_matrix @ h.T).T
    px = (img[:, 0] / img[:, 2]).astype(int)
    py = (img[:, 1] / img[:, 2]).astype(int)
    x1, x2 = sorted((px[0], px[1]))
    y1, y2 = sorted((py[0], py[1]))
    return (
        max(x1 - extra_border, 0),
        max(y1 - extra_border, 0),
        min(x2 + extra_border, width - 1),
        min(y2 + extra_border, height - 1),
    )
