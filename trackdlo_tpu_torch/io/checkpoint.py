"""Tracker-state checkpoint and resume.

Counterpart of trackdlo_tpu/io/checkpoint.py, in its npz layout (``y``,
``sigma2``, ``geodesic_coord``, float32), so a file saved by either package
loads in the other. A batched state (a leading stream axis on every field)
saves and loads the same way.
"""

from __future__ import annotations

import numpy as np

from trackdlo_tpu_torch.convert import state_from_numpy, state_to_numpy
from trackdlo_tpu_torch.models.trackdlo import TrackerState


def save_state(path: str, state: TrackerState) -> str:
    y, sigma2, geodesic_coord = state_to_numpy(state)
    np.savez(path, y=y, sigma2=sigma2, geodesic_coord=geodesic_coord)
    return path


def load_state(path: str, device=None) -> TrackerState:
    """The saved state on ``device`` (the CUDA card unless the caller names
    the CPU)."""
    with np.load(path) as data:
        return state_from_numpy(data["y"], data["sigma2"], data["geodesic_coord"], device=device)
