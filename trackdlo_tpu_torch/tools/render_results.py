"""Render an arbitrary algorithm's node trajectory onto RGB frames.

Reference: utils/tracking_result_img_from_pointcloud_topic.py — used to make
qualitative comparison images for competitor trackers (cdcpd2 etc.): any
(M, 3) node array is overlaid, not just this framework's.
"""

from __future__ import annotations

import numpy as np

from trackdlo_tpu_torch.utils.viz import draw_tracking_overlay


def render_result_images(frames, trajectories, proj_matrix, visible=None):
    """Yield overlay images for (rgb, depth) frames × (F, M, 3) trajectories."""
    for (rgb, _depth), nodes in zip(frames, trajectories):
        vis = None if visible is None else visible
        yield draw_tracking_overlay(rgb, np.asarray(nodes), proj_matrix, vis)
