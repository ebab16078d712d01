"""State exchange between the JAX package and the port.

The tracker has no learned weights (its parameters are ``TrackerParams``,
the same fields in both packages); what crosses between the packages is the
tracker state. Both sides see it as numpy arrays:
``trackdlo_tpu.models.trackdlo.TrackerState`` fields converted with
``np.asarray``. A batched state (``replicate_state``, the batched step) has a
leading stream axis on every field and converts the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from trackdlo_tpu_torch.device import resolve_device
from trackdlo_tpu_torch.models.trackdlo import TrackerState


def state_from_numpy(y, sigma2, geodesic_coord, device=None) -> TrackerState:
    """The port's TrackerState from numpy arrays: float32 copies on
    ``device`` (the CUDA card unless the caller names the CPU). The inputs
    may be read-only views of JAX buffers, and may carry a leading stream
    axis: y (B, M, 3), sigma2 (B,), geodesic_coord (B, M)."""
    device = resolve_device(device)
    return TrackerState(
        y=torch.tensor(np.asarray(y, np.float32), device=device),
        sigma2=torch.tensor(np.asarray(sigma2, np.float32), device=device),
        geodesic_coord=torch.tensor(np.asarray(geodesic_coord, np.float32), device=device),
    )


def to_numpy(a) -> np.ndarray:
    """A tensor on any device, or any array (numpy, the JAX package's), as
    a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def state_to_numpy(state: TrackerState) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(y, sigma2, geodesic_coord) as numpy float32 arrays."""
    return tuple(t.detach().cpu().numpy().astype(np.float32) for t in state)
