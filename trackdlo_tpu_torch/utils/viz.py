"""Visualization: tracking overlays and structured geometry markers.

Reference: the tracker node's image drawing (trackdlo_node.cpp:377-449: depth
-sorted edges drawn back-to-front with occlusion colouring, "occlusion" text
label) and the MarkerArray builders (utils.cpp:244-475 /
utils.py ndarray2MarkerArray). Markers here are framework-agnostic dicts —
the optional ROS adapter converts them to visualization_msgs.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# Reference colours (BGR in the reference; RGB here).
NODE_VISIBLE = (255, 150, 0)
NODE_OCCLUDED = (255, 0, 0)
EDGE_VISIBLE = (0, 255, 0)
EDGE_OCCLUDED = (255, 0, 0)


def _project(y: np.ndarray, proj: np.ndarray) -> np.ndarray:
    h = np.hstack([y, np.ones((len(y), 1))])
    img = (proj @ h.T).T
    return np.stack(
        [(img[:, 0] / img[:, 2]).astype(int), (img[:, 1] / img[:, 2]).astype(int)],
        axis=1,
    )


def draw_tracking_overlay(
    rgb: np.ndarray,
    y: np.ndarray,
    proj_matrix: np.ndarray,
    visible: np.ndarray | None = None,
    occlusion_mask: np.ndarray | None = None,
    node_radius: int = 7,
    edge_width: int = 5,
) -> np.ndarray:
    """Tracking overlay (trackdlo_node.cpp:377-449).

    Edges are drawn farthest-first (back to front); nodes/edges colour by
    visibility; with an occlusion mask, the occluded region is dimmed and
    labelled like the reference's simulated-occlusion display
    (trackdlo_node.cpp:398, 447-449).
    """
    if cv2 is None:
        raise RuntimeError("overlay drawing requires OpenCV")
    y = np.asarray(y, float)
    m = len(y)
    vis = np.ones(m, bool) if visible is None else np.asarray(visible, bool)

    img = rgb.copy()
    if occlusion_mask is not None:
        occ = np.asarray(occlusion_mask)
        if occ.ndim == 3:
            occ = occ.max(axis=-1)
        masked = img.copy()
        masked[occ == 0] = 0
        img = (0.5 * rgb + 0.5 * masked).astype(np.uint8)
        ys, xs = np.nonzero(occ == 0)
        if len(ys):
            cv2.putText(
                img, "occlusion", (int(xs.min()), max(int(ys.min()) - 10, 0)),
                cv2.FONT_HERSHEY_DUPLEX, 1.2, (240, 0, 0), 2,
            )

    pix = _project(y, proj_matrix)
    # Back-to-front edge order (trackdlo_node.cpp:378-390).
    edge_dist = np.linalg.norm((y[:-1] + y[1:]) / 2.0, axis=1)
    order = np.argsort(edge_dist)[::-1]
    for e in order:
        both_invisible = (not vis[e]) and (not vis[e + 1])
        ec = EDGE_OCCLUDED if both_invisible else EDGE_VISIBLE
        cv2.line(img, tuple(pix[e]), tuple(pix[e + 1]), ec, edge_width)
        for k in (e, e + 1):
            nc = NODE_VISIBLE if vis[k] else NODE_OCCLUDED
            cv2.circle(img, tuple(pix[k]), node_radius, nc, -1)
    return img


def geometry_markers(
    y: np.ndarray,
    frame_id: str = "camera",
    ns: str = "node_results",
    node_color=(1.0, 150 / 255.0, 0.0, 1.0),
    line_color=(0.0, 1.0, 0.0, 1.0),
    node_scale: float = 0.01,
    line_scale: float = 0.005,
    visible: np.ndarray | None = None,
    occluded_node_color=(1.0, 0.0, 0.0, 1.0),
    occluded_line_color=(1.0, 0.0, 0.0, 1.0),
) -> list[dict]:
    """Sphere-per-node + cylinder-per-edge marker list
    (MatrixXd2MarkerArray, utils.cpp:244-357), as plain dicts with
    quaternion orientations."""
    y = np.asarray(y, float)
    m = len(y)
    vis = np.ones(m, bool) if visible is None else np.asarray(visible, bool)
    markers = []
    last_visible = True
    for i in range(m):
        color = node_color if vis[i] else occluded_node_color
        markers.append(
            {
                "type": "sphere",
                "ns": f"{ns}_node_{i}",
                "id": i,
                "frame_id": frame_id,
                "position": y[i].tolist(),
                "orientation": [1.0, 0.0, 0.0, 0.0],  # w, x, y, z
                "scale": [node_scale] * 3,
                "color": list(color),
            }
        )
        if i == 0:
            last_visible = vis[i]
            continue
        mid = (y[i] + y[i - 1]) / 2.0
        d = y[i] - y[i - 1]
        length = float(np.linalg.norm(d))
        quat = _quat_from_z_to(d / length) if length > 0 else [1.0, 0, 0, 0]
        ec = line_color if (last_visible and vis[i]) else occluded_line_color
        markers.append(
            {
                "type": "cylinder",
                "ns": f"{ns}_line_{i}",
                "id": i,
                "frame_id": frame_id,
                "position": mid.tolist(),
                "orientation": quat,
                "scale": [line_scale, line_scale, length],
                "color": list(ec),
            }
        )
        last_visible = vis[i]
    return markers


def _quat_from_z_to(v: np.ndarray) -> list[float]:
    """Quaternion [w,x,y,z] rotating +z onto unit vector v
    (Eigen setFromTwoVectors semantics, utils.cpp:324-327)."""
    z = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(z, v))
    if c > 1 - 1e-12:
        return [1.0, 0.0, 0.0, 0.0]
    if c < -1 + 1e-12:
        return [0.0, 1.0, 0.0, 0.0]  # 180° about x
    axis = np.cross(z, v)
    s = np.sqrt((1 + c) * 2)
    return [s / 2.0, axis[0] / s, axis[1] / s, axis[2] / s]
