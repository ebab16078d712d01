"""Node visibility: point-cloud proximity + painter's-algorithm self-occlusion.

Reference: trackdlo_node.cpp:254-360. Edges of Y^{t-1} are projected into the
image and rasterized thick-first-closest; a node is visible when its projected
pixel is not yet covered by a nearer edge AND it lies within
visibility_threshold of the current point cloud. Small gaps (geodesic length
≤ d_vis) between visible nodes are then filled in.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VisibilityResult:
    visible_nodes: list
    visible_nodes_extended: list
    not_self_occluded: list
    shortest_node_pt_dists: np.ndarray


def project_to_pixels(y: np.ndarray, proj_matrix: np.ndarray) -> np.ndarray:
    """Homogeneous projection, integer-cast (trackdlo_node.cpp:295-311)."""
    y_h = np.hstack([y, np.ones((len(y), 1))])
    img = (proj_matrix @ y_h.T).T
    us = (img[:, 0] / img[:, 2]).astype(int)
    vs = (img[:, 1] / img[:, 2]).astype(int)
    return np.stack([us, vs], axis=1)


def compute_visibility(
    y: np.ndarray,
    x: np.ndarray,
    proj_matrix: np.ndarray,
    img_rows: int,
    img_cols: int,
    visibility_threshold: float,
    dlo_pixel_width: int,
    d_vis: float,
    geodesic_coord: np.ndarray,
) -> VisibilityResult:
    """Full visibility pass (trackdlo_node.cpp:254-360)."""
    m = len(y)

    # Nearest point-cloud distance per node (trackdlo_node.cpp:257-277).
    if len(x):
        d = np.linalg.norm(y[:, None, :] - x[None, :, :], axis=2)
        shortest = d.min(axis=1)
    else:
        shortest = np.full(m, 1e5)

    # Sort edges by averaged endpoint camera distance (trackdlo_node.cpp:280-291).
    edge_mid_dist = np.linalg.norm((y[:-1] + y[1:]) / 2.0, axis=1)
    draw_order = np.argsort(edge_mid_dist, kind="stable")

    pix = project_to_pixels(y, proj_matrix)

    projected_edges = np.zeros((img_rows, img_cols), dtype=np.uint8)
    visible_nodes: list[int] = []
    not_self_occluded: list[int] = []

    def covered(node_idx: int) -> bool:
        u, v = pix[node_idx]
        # The C++ reads the buffer unchecked (UB out of bounds); clamp instead.
        v_c = min(max(v, 0), img_rows - 1)
        u_c = min(max(u, 0), img_cols - 1)
        return projected_edges[v_c, u_c] != 0

    for idx in draw_order:
        idx = int(idx)
        for node in (idx, idx + 1):
            if not covered(node):
                if shortest[node] <= visibility_threshold and node not in visible_nodes:
                    visible_nodes.append(node)
                if node not in not_self_occluded:
                    not_self_occluded.append(node)
        # Draw the edge with the DLO's pixel width (trackdlo_node.cpp:338-342).
        p1 = (int(pix[idx][0]), int(pix[idx][1]))
        p2 = (int(pix[idx + 1][0]), int(pix[idx + 1][1]))
        _draw_thick_line(projected_edges, p1, p2, dlo_pixel_width)

    visible_nodes.sort()

    # Gap fill: geodesic gaps ≤ d_vis become visible (trackdlo_node.cpp:349-360).
    extended: list[int] = []
    for i in range(len(visible_nodes) - 1):
        extended.append(visible_nodes[i])
        if abs(geodesic_coord[visible_nodes[i + 1]] - geodesic_coord[visible_nodes[i]]) <= d_vis:
            for j in range(1, visible_nodes[i + 1] - visible_nodes[i]):
                extended.append(visible_nodes[i] + j)
    if visible_nodes:
        extended.append(visible_nodes[-1])

    return VisibilityResult(
        visible_nodes=visible_nodes,
        visible_nodes_extended=extended,
        not_self_occluded=not_self_occluded,
        shortest_node_pt_dists=shortest,
    )


def _draw_thick_line(buf: np.ndarray, p1, p2, width: int) -> None:
    """Capsule rasterization: every pixel within width/2 of the segment."""
    h, w = buf.shape
    x1, y1 = p1
    x2, y2 = p2
    r = width / 2.0
    lo_x = max(int(min(x1, x2) - r - 1), 0)
    hi_x = min(int(max(x1, x2) + r + 1), w - 1)
    lo_y = max(int(min(y1, y2) - r - 1), 0)
    hi_y = min(int(max(y1, y2) + r + 1), h - 1)
    if hi_x < lo_x or hi_y < lo_y:
        return
    ys, xs = np.mgrid[lo_y : hi_y + 1, lo_x : hi_x + 1]
    dx, dy = x2 - x1, y2 - y1
    seg_len_sq = dx * dx + dy * dy
    if seg_len_sq == 0:
        t = np.zeros_like(xs, dtype=float)
    else:
        t = np.clip(((xs - x1) * dx + (ys - y1) * dy) / seg_len_sq, 0.0, 1.0)
    px = x1 + t * dx
    py = y1 + t * dy
    dist = np.sqrt((xs - px) ** 2 + (ys - py) ** 2)
    buf[lo_y : hi_y + 1, lo_x : hi_x + 1][dist <= r] = 255
