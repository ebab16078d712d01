"""Multi-stream tracking on one card, time-multiplexed over one Tracker.

Counterpart of trackdlo_tpu/models/multi.py: every stream keeps its own
state and steps through one shared :class:`Tracker`, one after another, so
streams join and leave freely and each keeps the single-stream latency. The
batched step (:func:`trackdlo_tpu_torch.parallel.build_batched_step_fn`)
trades that for one launch per stage for the whole frame set.
"""

from __future__ import annotations

import numpy as np

from trackdlo_tpu_torch.config import CameraIntrinsics, TrackerParams
from trackdlo_tpu_torch.models.trackdlo import Tracker, TrackerState


class MultiTracker:
    """Track many independent camera streams with one tracker.

    Usage::

        mt = MultiTracker(live_params(), CameraIntrinsics(), device="cuda")
        mt.add_stream("cam0", init_nodes=nodes0)
        mt.add_stream("cam1", init_frame=(rgb, depth))
        outs = mt.step_all({"cam0": (rgb0, depth0), "cam1": (rgb1, depth1)})
    """

    def __init__(self, params: TrackerParams, intrinsics: CameraIntrinsics, device=None):
        self.tracker = Tracker(params, intrinsics, device=device)
        self.states: dict[str, TrackerState] = {}
        self.last_outputs: dict[str, object] = {}

    def add_stream(self, name: str, init_nodes=None, init_frame=None) -> None:
        if (init_nodes is None) == (init_frame is None):
            raise ValueError("provide exactly one of init_nodes / init_frame")
        if init_nodes is not None:
            self.states[name] = self.tracker.init_from_nodes(init_nodes)
        else:
            rgb, depth = init_frame
            self.states[name] = self.tracker.init_from_frame(rgb, depth)

    def remove_stream(self, name: str) -> None:
        self.states.pop(name, None)
        self.last_outputs.pop(name, None)

    def step(self, name: str, rgb, depth, occlusion_mask=None):
        """Advance one stream; returns its StepOutputs."""
        state, out = self.tracker.step(self.states[name], rgb, depth, occlusion_mask)
        self.states[name] = state
        self.last_outputs[name] = out
        return out

    def step_all(self, frames: dict, occlusion_masks: dict | None = None) -> dict:
        """Advance every stream, one after another; ``frames[name] = (rgb,
        depth)``. Returns {name: StepOutputs}."""
        occlusion_masks = occlusion_masks or {}
        return {name: self.step(name, rgb, depth, occlusion_masks.get(name))
                for name, (rgb, depth) in frames.items()}

    def nodes(self, name: str) -> np.ndarray:
        return self.states[name].y.cpu().numpy()
