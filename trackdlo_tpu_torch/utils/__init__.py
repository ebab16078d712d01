"""Tracking overlays and markers (:mod:`.viz`) and the health supervisor
(:mod:`.health`)."""

from trackdlo_tpu_torch.utils.viz import draw_tracking_overlay, geometry_markers

__all__ = ["draw_tracking_overlay", "geometry_markers"]
