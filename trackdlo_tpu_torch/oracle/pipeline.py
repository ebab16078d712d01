"""End-to-end oracle per-frame pipeline (the reference Callback's math).

Reference: trackdlo_node.cpp:121-532, minus ROS plumbing and drawing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from trackdlo_tpu_torch.oracle.preprocess import preprocess_frame
from trackdlo_tpu_torch.oracle.tracking import TrackingStepResult, tracking_step
from trackdlo_tpu_torch.oracle.visibility import compute_visibility


@dataclasses.dataclass
class OracleState:
    y: np.ndarray
    sigma2: float
    geodesic_coord: np.ndarray


def init_state(init_nodes: np.ndarray, params) -> OracleState:
    """Tracker construction from initial nodes (trackdlo_node.cpp:129-148)."""
    init_nodes = np.asarray(init_nodes, dtype=float)
    seg = np.linalg.norm(np.diff(init_nodes, axis=0), axis=1)
    coord = np.concatenate([[0.0], np.cumsum(seg)])
    return OracleState(y=init_nodes.copy(), sigma2=params.sigma2_init, geodesic_coord=coord)


def step_frame(
    state: OracleState,
    rgb: np.ndarray,
    depth: np.ndarray,
    params,
    intrinsics,
    occlusion_mask: np.ndarray | None = None,
    points: np.ndarray | None = None,
) -> tuple[OracleState, TrackingStepResult, dict]:
    """One full frame: preprocess → visibility → tracking_step.

    ``points`` overrides the preprocessing output (parity experiments:
    running the oracle's f64 math on the jitted path's point cloud isolates
    downsample detail from float-precision effects)."""
    if points is not None:
        x = np.asarray(points, dtype=float)
    else:
        x = preprocess_frame(rgb, depth, params, intrinsics, occlusion_mask)

    vis = compute_visibility(
        state.y,
        x,
        intrinsics.proj_matrix(),
        intrinsics.height,
        intrinsics.width,
        params.visibility_threshold,
        params.dlo_pixel_width,
        params.d_vis,
        state.geodesic_coord,
    )

    result = tracking_step(
        x,
        state.y,
        state.sigma2,
        state.geodesic_coord,
        vis.visible_nodes,
        vis.visible_nodes_extended,
        params,
    )

    new_state = OracleState(
        y=result.y, sigma2=result.sigma2, geodesic_coord=state.geodesic_coord
    )
    aux = {
        "points": x,
        "visible_nodes": vis.visible_nodes,
        "visible_nodes_extended": vis.visible_nodes_extended,
        "not_self_occluded": vis.not_self_occluded,
    }
    return new_state, result, aux
