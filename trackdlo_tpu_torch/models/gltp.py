"""GLTP tracker: CPD registration with LLE shape regularisation.

Counterpart of trackdlo_tpu/models/gltp.py: the flagship's front end
(preprocessing with kernels P and C), then one GLTP EM over all M nodes —
kernel E's pass with the LLE term on the card — with no visibility pass and
no correspondence priors. On the card the step is captured once as one CUDA
graph (:class:`~trackdlo_tpu_torch.models.trackdlo.CompiledStep`), as the
flagship's is.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from trackdlo_tpu_torch.config import CameraIntrinsics, TrackerParams
from trackdlo_tpu_torch.device import resolve_device, set_full_fp32
from trackdlo_tpu_torch.models.trackdlo import (
    CompiledStep,
    TrackerState,
    host_to_device,
    init_state,
    preprocess_for_step,
    step_shapes,
)
from trackdlo_tpu_torch.ops.cpd_lle import CpdParams, cpd_lle
from trackdlo_tpu_torch.ops.preprocess import default_cell_px


def _gltp_step(state: TrackerState, rgb, depth, occ, *, params: TrackerParams,
               intr: CameraIntrinsics, cell_px: int, device: torch.device):
    pc = preprocess_for_step(
        host_to_device(rgb, device), host_to_device(depth, device),
        host_to_device(occ, device).contiguous(), params=params, intr=intr, cell_px=cell_px,
    )
    m = params.num_of_nodes
    res = cpd_lle(
        pc.points, pc.mask, state.y, torch.ones((m,), dtype=torch.bool, device=device),
        state.sigma2,
        CpdParams(
            beta=params.beta_pre_proc, lam=params.lambda_pre_proc,
            lle_weight=params.lle_weight, mu=params.mu, max_iter=params.max_iter,
            tol=params.tol, include_lle=True, prune_radius=params.prune_radius,
            visibility_threshold=params.visibility_threshold,
        ),
    )
    return TrackerState(y=res.y, sigma2=res.sigma2, geodesic_coord=state.geodesic_coord), res


class GltpTracker:
    """Same API shape as :class:`~trackdlo_tpu_torch.models.trackdlo.Tracker`;
    ``step`` returns ``(state, CpdResult)``. Runs on ``device`` (the CUDA
    card unless the caller names the CPU)."""

    def __init__(self, params: TrackerParams, intrinsics: CameraIntrinsics, device=None):
        self.params = params
        self.intrinsics = intrinsics
        self.device = resolve_device(device)
        set_full_fp32()
        cell_px = params.downsample_cell_px or default_cell_px(
            params.downsample_leaf_size, intrinsics.fx
        )
        fn = functools.partial(_gltp_step, params=params, intr=intrinsics, cell_px=cell_px,
                               device=self.device)
        self._step = (CompiledStep(fn, self.device, step_shapes(params, intrinsics))
                      if self.device.type == "cuda" else fn)
        self._full_occ = None

    def init_from_nodes(self, nodes) -> TrackerState:
        return init_state(np.asarray(nodes, np.float32), self.params, self.device)

    def step(self, state: TrackerState, rgb, depth, occlusion_mask=None):
        h, w = self.intrinsics.height, self.intrinsics.width
        if occlusion_mask is None:
            if self._full_occ is None:
                self._full_occ = torch.ones((h, w), dtype=torch.bool, device=self.device)
            occ = self._full_occ
        elif isinstance(self._step, CompiledStep):
            occ = occlusion_mask  # made bool in the graph step's copy
        else:
            occ = host_to_device(occlusion_mask, self.device) != 0
            if occ.ndim == 3:
                occ = occ.any(dim=-1)
        return self._step(state, rgb, depth, occ)
