"""First-frame initialization subsystem.

Reference: trackdlo/src/initialize.py (+ utils.py skeleton machinery). Runs
once per session on the host (NumPy/SciPy) — it is deliberately outside the
jitted per-frame graph, mirroring the reference's separate one-shot init node.

Two initializers:

- :func:`skeleton_initialize` — mask → Zhang-Suen skeletonization → contour
  chains → prune/merge → B-spline fit → uniform arc-length node placement
  (initialize.py:52-143, utils.py:160-453);
- :func:`register_initialize` — GMM cold-start registration + chain ordering
  (utils.cpp:21-82 `reg` + sort_pts), used by the reference's NumPy prototype
  (tracking_test.py:523-539) and as the fallback when no clean skeleton is
  found.
"""

from trackdlo_tpu_torch.dlo_init.api import initialize_nodes, register_initialize, skeleton_initialize

__all__ = ["initialize_nodes", "skeleton_initialize", "register_initialize"]
