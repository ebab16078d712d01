"""Initialization entry points (host-side, once per session)."""

from __future__ import annotations

import numpy as np

from trackdlo_tpu_torch.oracle.cpd_lle import register_cold_start
from trackdlo_tpu_torch.oracle.geometry import sort_pts
from trackdlo_tpu_torch.oracle.preprocess import deproject, segment_dlo


def _resample_uniform(points: np.ndarray, m: int) -> np.ndarray:
    """Fit a smoothing B-spline and pick ``m`` nodes uniformly in arc length
    (initialize.py:112-125: splprep(s=0.0005), 300-pt pass, ≈1 pt/mm pass)."""
    from scipy import interpolate

    pts = np.asarray(points, float)
    # splprep needs strictly increasing parameterization; dedupe consecutive
    # duplicates first.
    keep = np.ones(len(pts), bool)
    keep[1:] = np.linalg.norm(np.diff(pts, axis=0), axis=1) > 1e-9
    pts = pts[keep]
    tck, _ = interpolate.splprep(pts.T, s=0.0005)
    u = np.linspace(0, 1, 300)
    spline = np.stack(interpolate.splev(u, tck), axis=1)
    n_true = int(np.sum(np.linalg.norm(np.diff(spline, axis=0), axis=1)) * 1000)
    n_true = max(n_true, m)
    u = np.linspace(0, 1, n_true)
    spline = np.stack(interpolate.splev(u, tck), axis=1)
    nodes = spline[np.linspace(0, n_true - 1, m).astype(int)]
    # Dedupe exact duplicates, preserving order (initialize.py:46-50).
    _, idx = np.unique(nodes, axis=0, return_index=True)
    nodes = nodes[np.sort(idx)]
    if len(nodes) != m:
        # Unlike the reference (which renegotiates num_of_nodes via rosparam,
        # initialize.py:49), the static graph needs exactly M nodes: re-space.
        seg = np.linalg.norm(np.diff(nodes, axis=0), axis=1)
        arc = np.concatenate([[0], np.cumsum(seg)])
        t = np.linspace(0, arc[-1], m)
        nodes = np.stack([np.interp(t, arc, nodes[:, d]) for d in range(3)], axis=1)
    return nodes


# Green tape bounds marking the DLO tip on the multi-colour evaluation rope
# (initialize.py:33-36).
TIP_HSV_LOWER = (58, 130, 50)
TIP_HSV_UPPER = (90, 255, 89)
# Depth gate for the multi-colour rope (initialize.py:42, 108-110).
MULTI_COLOR_MIN_DEPTH = 0.57


def skeleton_initialize(
    rgb: np.ndarray, depth: np.ndarray, params, intrinsics, debug_dir: str | None = None
) -> np.ndarray:
    """Skeleton-based initialization (initialize.py:52-143).

    With ``params.multi_color_dlo``: the green tape tip joins the
    segmentation mask, pixels nearer than 0.57 m are gated out, and the chain
    is oriented so the green-tip end comes FIRST (the reference reverses when
    the last pixel lands in the tip mask, initialize.py:93-97).

    ``debug_dir``: when set, saves per-stage images (mask, skeleton, chains)
    — the headless equivalent of the reference's
    visualize_initialization_process windows (launch/trackdlo.launch:13,
    utils.py:170-175).
    """
    from trackdlo_tpu_torch.dlo_init.skeleton import extract_connected_skeleton
    from trackdlo_tpu_torch.oracle.preprocess import hsv_from_rgb, in_range

    mask = segment_dlo(rgb, params.hsv_lower, params.hsv_upper, params.multi_color_dlo)
    tip_mask = None
    if params.multi_color_dlo:
        tip_mask = in_range(hsv_from_rgb(rgb), TIP_HSV_LOWER, TIP_HSV_UPPER)
        mask = np.maximum(mask, tip_mask)
        mask[depth < MULTI_COLOR_MIN_DEPTH * 1000] = 0

    chains = extract_connected_skeleton(
        mask, seg_length=8, max_curvature=25, debug_dir=debug_dir
    )
    coords = [c for chain in chains for c in chain]
    if len(coords) < 4:
        raise ValueError("skeleton extraction produced too few points")
    # Chain coords are (x=col, y=row) pixel pairs (initialize.py:83-92).
    pix = np.asarray(coords, int)
    if tip_mask is not None:
        u_last, v_last = pix[-1]
        if tip_mask[v_last, u_last]:
            pix = pix[::-1]
    us, vs = pix[:, 0], pix[:, 1]
    z = depth[vs, us].astype(float) / 1000.0
    x = (us - intrinsics.cx) * z / intrinsics.fx
    y = (vs - intrinsics.cy) * z / intrinsics.fy
    pts = np.stack([x, y, z], axis=1)
    pts = pts[np.any(pts != 0, axis=1)]  # drop no-depth pixels (initialize.py:106)
    if params.multi_color_dlo:
        pts = pts[pts[:, 2] > MULTI_COLOR_MIN_DEPTH]  # initialize.py:108-110
    if len(pts) < 4:
        raise ValueError("too few skeleton points with valid depth")
    return _resample_uniform(pts, params.num_of_nodes)


def register_initialize(
    rgb: np.ndarray, depth: np.ndarray, params, intrinsics
) -> np.ndarray:
    """GMM cold-start registration initializer (utils.cpp:21-82 +
    sort_pts + spline resample)."""
    from trackdlo_tpu_torch.oracle.preprocess import voxel_downsample

    mask = segment_dlo(rgb, params.hsv_lower, params.hsv_upper, params.multi_color_dlo)
    pts, z_mm = deproject(
        mask, depth, intrinsics.fx, intrinsics.fy, intrinsics.cx,
        intrinsics.cy, return_z_mm=True,
    )
    keep = pts[:, 2] > 0
    pts = voxel_downsample(
        pts[keep], params.downsample_leaf_size, z_mm=z_mm[keep]
    )
    if len(pts) < params.num_of_nodes:
        raise ValueError("too few points for cold-start registration")
    y, _ = register_cold_start(pts, params.num_of_nodes, mu=0.05, max_iter=100)
    y = sort_pts(y)
    return _resample_uniform(y, params.num_of_nodes)


def initialize_nodes(rgb, depth, params, intrinsics) -> np.ndarray:
    """Skeleton init with cold-start fallback (the reference aborts on init
    failure, initialize.py:141-143; here registration is the safety net)."""
    try:
        return skeleton_initialize(rgb, depth, params, intrinsics)
    except Exception:
        return register_initialize(rgb, depth, params, intrinsics)
