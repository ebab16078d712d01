"""Failure detection and recovery.

Counterpart of trackdlo_tpu/utils/health.py with the same thresholds and
rules; a tracker's tensors are read to the host once each per frame
(``.cpu()``), so the supervisor wraps a tracker on the card or the CPU (or
one of the JAX package's).

The reference detects EM non-convergence but ignores it (the bool return of
cpd_lle is dropped at both call sites, trackdlo.cpp:927,998) and has no
recovery of any kind — "a crash loses state" (SURVEY.md §5). This module adds
the missing subsystem:

- :func:`check_state` — per-frame diagnostics: NaN/Inf state, implausible
  node jumps, chain-length blow-up/collapse, convergence streaks;
- :class:`TrackingSupervisor` — wraps any tracker; on sustained failure it
  re-initializes from the current frame (skeleton init with cold-start
  fallback), which is exactly what an operator of the reference does by
  restarting the ROS nodes.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from trackdlo_tpu_torch.convert import to_numpy

logger = logging.getLogger("trackdlo_tpu_torch")


@dataclasses.dataclass
class HealthReport:
    finite: bool
    max_node_jump: float
    length_ratio: float
    converged: bool
    healthy: bool
    reason: str = ""
    median_data_dist: float = 0.0


def check_state(
    prev_y: np.ndarray,
    state,
    outputs=None,
    max_jump: float = 0.10,
    length_tolerance: float = 0.5,
    lost_dist: float = 0.1,
) -> HealthReport:
    """Diagnose one tracker update.

    - ``max_jump``: largest per-node displacement (m) considered plausible
      between consecutive frames;
    - ``length_tolerance``: allowed relative deviation of current chain
      length from the rest length (geodesic_coord[-1]);
    - ``lost_dist``: the tracker is "lost" when the median node sits farther
      than this from the frame's point cloud (the EM's prune radius — beyond
      it no data influences the chain at all, trackdlo.cpp:177-195).
    """
    y = to_numpy(state.y)
    finite = bool(np.isfinite(y).all())
    jump = float(np.linalg.norm(y - to_numpy(prev_y), axis=1).max()) if finite else np.inf
    rest_len = float(to_numpy(state.geodesic_coord)[-1])
    cur_len = float(np.linalg.norm(np.diff(y, axis=0), axis=1).sum()) if finite else np.inf
    ratio = cur_len / rest_len if rest_len > 0 else np.inf
    converged = bool(to_numpy(outputs.converged)) if outputs is not None else True

    median_data_dist = 0.0
    if outputs is not None and finite:
        pts = to_numpy(outputs.points)
        msk = to_numpy(outputs.points_mask)
        if msk.any():
            d = np.linalg.norm(y[:, None, :] - pts[msk][None, :, :], axis=2)
            median_data_dist = float(np.median(d.min(axis=1)))
        else:
            median_data_dist = np.inf

    reason = ""
    if not finite:
        reason = "non-finite state"
    elif jump > max_jump:
        reason = f"node jump {jump:.3f} m > {max_jump} m"
    elif abs(ratio - 1.0) > length_tolerance:
        reason = f"chain length ratio {ratio:.2f} outside tolerance"
    elif median_data_dist > lost_dist:
        reason = f"lost track: median node-to-data distance {median_data_dist:.3f} m"
    healthy = reason == ""
    return HealthReport(
        finite=finite,
        max_node_jump=jump,
        length_ratio=ratio,
        converged=converged,
        healthy=healthy,
        reason=reason,
        median_data_dist=median_data_dist,
    )


class TrackingSupervisor:
    """Elastic wrapper: track, diagnose, and re-initialize on sustained
    failure. ``failure_patience`` consecutive unhealthy frames (or any
    non-finite state) trigger re-initialization from the offending frame."""

    def __init__(
        self,
        tracker,
        failure_patience: int = 3,
        max_jump: float = 0.10,
        length_tolerance: float = 0.5,
        lost_dist: float = 0.1,
    ):
        self.tracker = tracker
        self.failure_patience = failure_patience
        self.max_jump = max_jump
        self.length_tolerance = length_tolerance
        self.lost_dist = lost_dist
        self.failure_streak = 0
        self.reinit_count = 0
        self.last_report: HealthReport | None = None

    def step(self, state, rgb, depth, occlusion_mask=None):
        prev_y = to_numpy(state.y)
        new_state, out = self.tracker.step(state, rgb, depth, occlusion_mask)
        report = check_state(
            prev_y, new_state, out,
            max_jump=self.max_jump, length_tolerance=self.length_tolerance,
            lost_dist=self.lost_dist,
        )
        self.last_report = report

        if report.healthy:
            self.failure_streak = 0
            return new_state, out

        self.failure_streak += 1
        logger.warning(
            "unhealthy tracker update (%s), streak=%d", report.reason, self.failure_streak
        )
        if not report.finite or self.failure_streak >= self.failure_patience:
            logger.warning("re-initializing tracker from current frame")
            try:
                new_state = self.tracker.init_from_frame(np.asarray(rgb), np.asarray(depth))
                self.reinit_count += 1
                self.failure_streak = 0
            except Exception as e:  # re-init itself failed: keep previous state
                logger.error("re-initialization failed: %s", e)
                new_state = state
        return new_state, out
