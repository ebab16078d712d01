"""The six reference evaluation scenarios as synthetic analogs.

launch/evaluation.launch:14-19 names six recorded bags: stationary,
perpendicular_motion, parallel_motion, self_occlusion, short_rope_folding,
short_rope_stationary. The bags are external data; these generators reproduce
each scenario's *dynamics* so the full evaluation protocol (scheduled
occlusion via the per-scenario rectangles / pct-bbox, blob or exact GT,
(E1+E2)/2 scoring, error files, eval images) runs end to end on synthetic
frames over long horizons.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from trackdlo_tpu_torch.io.sequence import (
    CrossingRope,
    FoldingRope,
    MovingRope,
    SyntheticRope,
)


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    rope: object  # SyntheticRope-interface generator
    horizon_s: float  # sequence time to cover (reference schedule span)
    render_kwargs: dict


def make_scenario(name: str) -> Scenario:
    """Build the named scenario's rope generator + horizon.

    Horizons follow the reference schedules (SCENARIO_SCHEDULES): long enough
    that recording starts, occlusion engages, and (where scheduled) the run
    exits — all states exercised over 100+ frames.
    """
    if name == "stationary":
        # Bag 0: still rope, pct-occlusion bbox protocol.
        return Scenario(name, SyntheticRope(speed=0.02), 33.0, {})
    if name == "perpendicular_motion":
        # Rope sweeps across its own axis through the bag-1 rectangle.
        rope = MovingRope(
            base=SyntheticRope(speed=0.05),
            axis=(0.0, 1.0, 0.0),
            amplitude=0.10,
            period=8.0,
        )
        return Scenario(name, rope, 12.0, {})
    if name == "parallel_motion":
        # Shorter rope slides along its own axis through the bag-2 rectangle
        # (shorter base keeps the sweep inside the 1280 px FOV).
        rope = MovingRope(
            base=SyntheticRope(length=0.6, speed=0.05),
            axis=(1.0, 0.0, 0.0),
            amplitude=0.10,
            period=8.0,
            offset=(0.0, -0.10, 0.0),
        )
        return Scenario(name, rope, 12.0, {})
    if name == "self_occlusion":
        return Scenario(name, CrossingRope(), 10.0, {})
    if name == "short_rope_folding":
        rope = FoldingRope(fold_start=2.0, fold_duration=9.0)
        return Scenario(name, rope, 14.5, {})
    if name == "short_rope_stationary":
        rope = SyntheticRope(length=0.35, speed=0.0, amp_y=0.05)
        return Scenario(name, rope, 31.0, {})
    raise ValueError(f"unknown scenario {name!r}")


ALL_SCENARIOS = (
    "stationary",
    "perpendicular_motion",
    "parallel_motion",
    "self_occlusion",
    "short_rope_folding",
    "short_rope_stationary",
)


def generate(scenario: Scenario, n_frames: int, intrinsics, m_nodes: int,
             markers: int = 0, noise_kwargs: dict | None = None):
    """Render the scenario: frames + exact GT nodes + the rate that maps
    n_frames onto the scenario horizon.

    ``noise_kwargs``: degraded-input render knobs (depth_noise_mm,
    dropout_frac, clutter_blobs — io/sequence.render_frame); the per-frame
    seed varies so noise is i.i.d. across the sequence like a real sensor."""
    from trackdlo_tpu_torch.io.sequence import render_frame

    dt = 1.0 / 15.0
    rate = n_frames * dt / scenario.horizon_s
    frames, gt = [], []
    for i in range(n_frames):
        t = (i + 1) * dt / rate  # sequence time, matching the runner's clock
        kw = dict(scenario.render_kwargs)
        if markers:
            kw["markers"] = markers
        if noise_kwargs:
            kw.update(noise_kwargs)
            kw["seed"] = i + 1
        frames.append(render_frame(scenario.rope, t, intrinsics, **kw))
        gt.append(scenario.rope.nodes(t, m_nodes))
    return frames, np.asarray(gt), rate
