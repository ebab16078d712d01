"""Tracker model families (counterpart of trackdlo_tpu/models):

- :mod:`trackdlo_tpu_torch.models.trackdlo` — the flagship TrackDLO tracker
  (pre-registration, correspondence priors, visibility-aware EM), its step
  compiled as one CUDA graph on the card (``build_step_fn``);
- :mod:`trackdlo_tpu_torch.models.gltp` — GLTP registration (CPD with LLE
  regularisation) as a standalone model on the same front end;
- :mod:`trackdlo_tpu_torch.models.cpd` — plain CPD/GMM registration (the
  cold-start ``reg``);
- :mod:`trackdlo_tpu_torch.models.multi` — many streams over one tracker.
"""

from trackdlo_tpu_torch.models.trackdlo import Tracker, TrackerState, build_step_fn

__all__ = ["Tracker", "TrackerState", "build_step_fn"]
