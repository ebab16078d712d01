"""Sequence recorder (reference: utils/collect_pointcloud.py, which pickled
point clouds / images / results per keypress). Here: an appending recorder
that snapshots frames + tracker outputs into one compressed npz.

Counterpart of trackdlo_tpu/tools/record.py; the port's outputs may lie on
the card, so each is brought to the host as it is recorded."""

from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class SequenceRecorder:
    def __init__(self):
        self.rgbs = []
        self.depths = []
        self.results = []
        self.points = []

    def record(self, rgb, depth, step_outputs=None):
        self.rgbs.append(_np(rgb))
        self.depths.append(_np(depth))
        if step_outputs is not None:
            self.results.append(_np(step_outputs.y))
            pts = _np(step_outputs.points)
            msk = _np(step_outputs.points_mask)
            self.points.append(pts[msk])

    def save(self, path: str):
        arrays = {
            "rgbs": np.stack(self.rgbs),
            "depths": np.stack(self.depths),
        }
        if self.results:
            arrays["results"] = np.stack(self.results)
        np.savez_compressed(path, **arrays)
        return path

    def __len__(self):
        return len(self.rgbs)
