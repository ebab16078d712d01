"""State exchange between the JAX package and the port.

The tracker has no learned weights (its parameters are the shared
``TrackerParams``); what crosses between the packages is the tracker state.
Both sides see it as numpy arrays: ``trackdlo_tpu.models.trackdlo.TrackerState``
fields converted with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from trackdlo_tpu_torch.models.trackdlo import TrackerState


def state_from_numpy(y, sigma2, geodesic_coord, device="cpu") -> TrackerState:
    """The port's TrackerState from numpy arrays (float32 copies on
    ``device``; the inputs may be read-only views of JAX buffers)."""
    return TrackerState(
        y=torch.tensor(np.asarray(y, np.float32), device=device),
        sigma2=torch.tensor(np.asarray(sigma2, np.float32), device=device),
        geodesic_coord=torch.tensor(np.asarray(geodesic_coord, np.float32), device=device),
    )


def state_to_numpy(state: TrackerState) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(y, sigma2, geodesic_coord) as numpy float32 arrays."""
    return tuple(t.detach().cpu().numpy().astype(np.float32) for t in state)
