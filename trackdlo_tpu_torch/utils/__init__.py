"""Tracking overlays and markers (:mod:`.viz`), the health supervisor
(:mod:`.health`) and the span recorder (:mod:`.profiling`; a benchmark
cell's per-layer breakdown: ``python -m portbench.run --workload <cell>
--seed <n> --seconds 10 --trace 1``)."""

from trackdlo_tpu_torch.utils.viz import draw_tracking_overlay, geometry_markers

__all__ = ["draw_tracking_overlay", "geometry_markers"]
