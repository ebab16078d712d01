"""Tracking overlays and markers (:mod:`.viz`), the health supervisor
(:mod:`.health`) and the phase timers and profiler trace
(:mod:`.profiling`)."""

from trackdlo_tpu_torch.utils.viz import draw_tracking_overlay, geometry_markers

__all__ = ["draw_tracking_overlay", "geometry_markers"]
