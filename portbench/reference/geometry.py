"""Geometry helpers mirroring the reference's utils.cpp.

Reference: trackdlo/src/utils.cpp:13-19 (distances), 172-241 (segment/sphere
intersection), 95-170 (chain ordering).
"""

from __future__ import annotations

import numpy as np


def pt2pt_dis_sq(a: np.ndarray, b: np.ndarray) -> float:
    """Sum of squared distances between matched rows (utils.cpp:13-15)."""
    a = np.atleast_2d(a)
    b = np.atleast_2d(b)
    return float(np.sum(np.square(a - b)))


def pt2pt_dis(a: np.ndarray, b: np.ndarray) -> float:
    """Sum of row-wise Euclidean norms of (a - b) (utils.cpp:17-19).

    For single points this is the Euclidean distance; for matrices it is the
    *sum of per-row distances* — the reference uses this form in the EM
    convergence check (trackdlo.cpp:424).
    """
    a = np.atleast_2d(a)
    b = np.atleast_2d(b)
    return float(np.sum(np.linalg.norm(a - b, axis=1)))


def is_between(x: np.ndarray, a: np.ndarray, b: np.ndarray, eps: float = 1e-4) -> bool:
    """Componentwise bounding-box check with 1e-4 slack (utils.cpp:172-183)."""
    x, a, b = np.ravel(x), np.ravel(a), np.ravel(b)
    for i in range(3):
        lo_ab = a[i] - eps <= x[i] <= b[i] + eps
        lo_ba = b[i] - eps <= x[i] <= a[i] + eps
        if not (lo_ab or lo_ba):
            return False
    return True


def line_sphere_intersection(
    point_a: np.ndarray, point_b: np.ndarray, center: np.ndarray, radius: float
) -> list:
    """Segment ∩ sphere via the quadratic formula (utils.cpp:185-241).

    Returns 0, 1, or 2 points (each a (3,) array), filtered to lie inside the
    segment's bounding box. Mirrors the reference's branch structure: a
    negative discriminant yields no solutions, a positive one yields two
    candidates, an exactly-zero one yields the single tangent point.
    """
    a_pt = np.asarray(point_a, dtype=float).ravel()
    b_pt = np.asarray(point_b, dtype=float).ravel()
    c_pt = np.asarray(center, dtype=float).ravel()

    a = pt2pt_dis_sq(a_pt, b_pt)
    b = 2.0 * float(np.dot(b_pt - a_pt, a_pt - c_pt))
    c = pt2pt_dis_sq(a_pt, c_pt) - radius**2

    delta = b * b - 4.0 * a * c
    out = []
    if delta < 0:
        return out
    if delta > 0:
        for d in ((-b + np.sqrt(delta)) / (2 * a), (-b - np.sqrt(delta)) / (2 * a)):
            p = a_pt + d * (b_pt - a_pt)
            if is_between(p, a_pt, b_pt):
                out.append(p)
    else:
        p = a_pt + (-b / (2 * a)) * (b_pt - a_pt)
        if is_between(p, a_pt, b_pt):
            out.append(p)
    return out


def sort_pts(y0: np.ndarray, head: np.ndarray | None = None) -> np.ndarray:
    """Order an unordered node set into a chain (utils.cpp:95-170).

    Greedy minimum-edge growth over the squared-distance graph with the
    reference's reversal bookkeeping. With ``head`` given, additionally flips
    the result if its first point is farther than 0.08 m from ``head``
    (evaluator.cpp:141-143).
    """
    y0 = np.asarray(y0, dtype=float)
    n = len(y0)
    g = np.sum((y0[:, None, :] - y0[None, :, :]) ** 2, axis=2)

    selected = np.zeros(n, dtype=bool)
    selected[0] = True
    out: list[int] = []
    last_visited_b = 0
    reverse = 0
    reverse_on = 0
    insertion_counter = 0

    for counter in range(n - 1):
        minimum = np.inf
        a = b = 0
        for m in range(n):
            if not selected[m]:
                continue
            for k in range(n):
                if not selected[k] and g[m, k] != 0.0 and g[m, k] < minimum:
                    minimum = g[m, k]
                    a, b = m, k

        if counter == 0:
            out.append(a)
            out.append(b)
        else:
            if last_visited_b != a:
                reverse += 1
                reverse_on = a
                insertion_counter = 1
            if reverse % 2 == 1:
                out.insert(out.index(a), b)
            elif reverse != 0:
                out.insert(out.index(reverse_on) + insertion_counter, b)
                insertion_counter += 1
            else:
                out.append(b)

        last_visited_b = b
        selected[b] = True

    ordered = y0[np.array(out)]
    if head is not None and pt2pt_dis(ordered[0], head) > 0.08:
        ordered = ordered[::-1].copy()
    return ordered


def geodesic_coords(nodes: np.ndarray) -> np.ndarray:
    """Cumulative arc length along the chain (trackdlo_node.cpp:135-140)."""
    nodes = np.asarray(nodes, dtype=float)
    seg = np.linalg.norm(np.diff(nodes, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])
