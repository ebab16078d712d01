"""Ground-truth extraction and the bidirectional piecewise error metric.

Counterpart of trackdlo_tpu/evaluation/evaluator.py: the numpy functions as
there, and the batched metric in PyTorch on a device.

Reference: evaluator.cpp:153-231 (HSV blob detection of tape markers),
evaluator.cpp:233-291 (point-to-polyline distances, (E1+E2)/2)."""

from __future__ import annotations

import numpy as np
import torch

from trackdlo_tpu_torch.device import resolve_device
from trackdlo_tpu_torch.oracle.geometry import sort_pts
from trackdlo_tpu_torch.oracle.preprocess import hsv_from_rgb, in_range

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def marker_mask(rgb: np.ndarray) -> np.ndarray:
    """Red + yellow tape mask (evaluator.cpp:160-187)."""
    hsv = hsv_from_rgb(rgb)
    red1 = in_range(hsv, (130, 60, 50), (255, 255, 255))
    red2 = in_range(hsv, (0, 60, 50), (10, 255, 255))
    yellow = in_range(hsv, (15, 100, 80), (40, 255, 255))
    return np.maximum(np.maximum(red1, red2), yellow)


def _blob_centers(mask: np.ndarray, min_area: float = 10.0) -> np.ndarray:
    """Blob keypoint centres (cv::SimpleBlobDetector with filterByArea
    minArea=10, evaluator.cpp:190-201), with a connected-components fallback."""
    if cv2 is not None:
        params = cv2.SimpleBlobDetector_Params()
        params.filterByColor = False
        params.filterByArea = True
        params.minArea = min_area
        params.filterByCircularity = False
        params.filterByInertia = True
        params.filterByConvexity = False
        detector = cv2.SimpleBlobDetector_create(params)
        keypoints = detector.detect(mask)
        return np.array([[kp.pt[0], kp.pt[1]] for kp in keypoints]).reshape(-1, 2)
    # Fallback: centroids of 4-connected components.
    from scipy import ndimage

    labels, n = ndimage.label(mask > 0)
    centers = []
    for i in range(1, n + 1):
        ys, xs = np.nonzero(labels == i)
        if len(xs) >= min_area:
            centers.append([xs.mean(), ys.mean()])
    return np.array(centers).reshape(-1, 2)


# --- per-scenario GT spatial gates (evaluator.cpp:204-227) -----------------
# The reference hand-tunes per-bag filters that reject spurious blob
# deprojections (reflections, table clutter). Each gate maps (N, 3) points to
# a keep-mask. Bag indices per launch/evaluation.launch:14-19.


def _gate_depth(pts, min_z=0.58):
    return pts[:, 2] >= min_z


def _gate_perpendicular(pts):  # bag 1 (evaluator.cpp:216-221)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    drop = ((x < 0.0) & (y < 0.05)) | (z < 0.58) | (x < -0.2) | ((x < 0.1) & (y < -0.05))
    return ~drop


def _gate_parallel(pts):  # bag 2 (evaluator.cpp:210-214)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return ~((x < -0.15) | (y < -0.15) | (z < 0.58))


SCENARIO_GT_GATES = {
    "perpendicular_motion": _gate_perpendicular,
    "parallel_motion": _gate_parallel,
    # every other bag: plain depth gate (evaluator.cpp:223-227)
    "default": _gate_depth,
}


def extract_marker_ground_truth(
    rgb: np.ndarray,
    depth: np.ndarray,
    intrinsics,
    head: np.ndarray | None = None,
    min_depth: float = 0.0,
    gate=None,
) -> np.ndarray:
    """Ground-truth node set from tape-marker blobs, ordered into a chain.

    The reference deprojects each keypoint through the organized cloud and
    gates by per-bag spatial filters (evaluator.cpp:204-227), reproduced here
    as ``gate``: a (N, 3) → keep-mask predicate (see SCENARIO_GT_GATES), or a
    scenario name to look one up. ``min_depth`` is the synthetic-scene
    fallback gate. ``head`` anchors the chain orientation
    (evaluator.cpp:141-143, run_evaluation.cpp:96-109).
    """
    centers = _blob_centers(marker_mask(rgb))
    if len(centers) == 0:
        return np.zeros((0, 3))
    us = np.clip(centers[:, 0].astype(int), 0, depth.shape[1] - 1)
    vs = np.clip(centers[:, 1].astype(int), 0, depth.shape[0] - 1)
    z = depth[vs, us].astype(float) / 1000.0
    x = (us - intrinsics.cx) * z / intrinsics.fx
    y = (vs - intrinsics.cy) * z / intrinsics.fy
    pts = np.stack([x, y, z], axis=1)
    pts = pts[z > max(min_depth, 1e-6)]
    if isinstance(gate, str):
        gate = SCENARIO_GT_GATES.get(gate, SCENARIO_GT_GATES["default"])
    if gate is not None and len(pts):
        pts = pts[np.asarray(gate(pts), bool)]
    if len(pts) < 2:
        return pts
    return sort_pts(pts, head=head)


def _point_to_polyline(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Min distance from each point to the polyline, vectorized
    (calc_min_distance semantics, evaluator.cpp:233-256: closest point on
    each segment with endpoint clamping)."""
    a = poly[:-1][None, :, :]  # (1, S, 3)
    b = poly[1:][None, :, :]
    p = points[:, None, :]  # (P, 1, 3)
    ab = b - a
    denom = np.maximum(np.sum(ab * ab, axis=-1), 1e-18)
    t = np.clip(np.sum((p - a) * ab, axis=-1) / denom, 0.0, 1.0)
    closest = a + t[..., None] * ab
    d = np.linalg.norm(p - closest, axis=-1)  # (P, S)
    return d.min(axis=1)


def piecewise_error(y_track: np.ndarray, y_true: np.ndarray) -> float:
    """Bidirectional mean node-to-curve distance (E1+E2)/2
    (evaluator.cpp:258-291)."""
    e1 = _point_to_polyline(y_track, y_true).mean()
    e2 = _point_to_polyline(y_true, y_track).mean()
    return float((e1 + e2) / 2.0)


def _one_direction(pts: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """Per batch row, the mean over ``pts`` (B, P, 3) of the distance to the
    polyline ``poly`` (B, K, 3) (:func:`_point_to_polyline`)."""
    a = poly[:, None, :-1]  # (B, 1, S, 3)
    b = poly[:, None, 1:]
    p = pts[:, :, None, :]  # (B, P, 1, 3)
    ab = b - a
    denom = torch.clamp_min((ab * ab).sum(dim=-1), 1e-18)
    t = torch.clamp(((p - a) * ab).sum(dim=-1) / denom, 0.0, 1.0)
    closest = a + t[..., None] * ab
    d = p - closest
    return torch.sqrt((d * d).sum(dim=-1)).amin(dim=2).mean(dim=1)


def piecewise_error_batch(y_track, y_true, device=None) -> np.ndarray:
    """Batched variant: (B, M, 3) × (B, K, 3) → (B,) float32 errors in one
    pass over the batch, for batched occlusion sweeps. The inputs (tensors
    or arrays) are taken as float32 on ``device`` (the CUDA card unless the
    caller names the CPU)."""
    dev = resolve_device(device)
    track, true = (
        (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a)))
        .to(dev, torch.float32) for a in (y_track, y_true))
    err = (_one_direction(track, true) + _one_direction(true, track)) / 2.0
    return err.cpu().numpy()
