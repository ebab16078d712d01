"""End-to-end oracle per-frame pipeline (the reference Callback's math).

Reference: trackdlo_node.cpp:121-532, minus ROS plumbing and drawing.
:class:`Params` and :class:`Camera` read a configuration file's tracker and
camera fields; :func:`tf32_matmul` is the control's matrix product.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.preprocess import preprocess_frame
from portbench.reference.tracking import TrackingStepResult, tracking_step
from portbench.reference.visibility import compute_visibility


class Params:
    """A configuration's tracker fields as attributes (the names of the
    launch files, ``lam`` for ``lambda``), HSV bounds as tuples."""

    def __init__(self, fields: dict):
        for key, value in fields.items():
            setattr(self, key, tuple(value) if isinstance(value, list) else value)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole intrinsics and the 3x4 projection (trackdlo_node.cpp:74-81)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def proj_matrix(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx, 0.0], [0.0, self.fy, self.cy, 0.0],
                         [0.0, 0.0, 1.0, 0.0]])


def tf32(a) -> np.ndarray:
    """``a`` rounded to TF32 (float32 with a 10-bit mantissa, ties away
    from zero), as float64."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return bits.view(np.float32).astype(np.float64)


def tf32_matmul(a, b) -> np.ndarray:
    """A matrix product as a TF32 tensor-core product gives it: both
    operands rounded to TF32, the result rounded to float32."""
    return (tf32(a) @ tf32(b)).astype(np.float32).astype(np.float64)


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
    mm=np.matmul,
) -> tuple[OracleState, TrackingStepResult, dict]:
    """One full frame: preprocess → visibility → tracking_step (its EM's
    matrix products through ``mm``).

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
        mm=mm,
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
