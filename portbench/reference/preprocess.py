"""Per-frame preprocessing oracle: mask → deproject → voxel downsample.

Reference: trackdlo_node.cpp:155-243 (HSV mask, occlusion AND, pinhole
deprojection, PCL VoxelGrid downsample).
"""

from __future__ import annotations

import numpy as np


def hsv_from_rgb(rgb: np.ndarray) -> np.ndarray:
    """OpenCV-convention HSV (H in [0,180)) from uint8 RGB, computed in
    NumPy on every machine (the reference converts its BGR frames with
    COLOR_BGR2HSV, trackdlo_node.cpp:159, the same transform modulo channel
    order).
    """
    rgbf = rgb.astype(np.float32) / 255.0
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    v = np.max(rgbf, axis=-1)
    mn = np.min(rgbf, axis=-1)
    delta = v - mn
    s = np.where(v > 0, delta / np.maximum(v, 1e-12), 0.0)
    h = np.zeros_like(v)
    nz = delta > 0
    rmax = nz & (v == r)
    gmax = nz & (v == g) & ~rmax
    bmax = nz & ~rmax & ~gmax
    h[rmax] = 60.0 * ((g[rmax] - b[rmax]) / delta[rmax])
    h[gmax] = 60.0 * ((b[gmax] - r[gmax]) / delta[gmax]) + 120.0
    h[bmax] = 60.0 * ((r[bmax] - g[bmax]) / delta[bmax]) + 240.0
    h = np.where(h < 0, h + 360.0, h)
    out = np.stack([h / 2.0, s * 255.0, v * 255.0], axis=-1)
    return np.round(out).astype(np.uint8)


def in_range(hsv: np.ndarray, lower, upper) -> np.ndarray:
    """cv2.inRange equivalent: 255 where all channels within bounds."""
    lower = np.asarray(lower)
    upper = np.asarray(upper)
    ok = np.all((hsv >= lower) & (hsv <= upper), axis=-1)
    return (ok * 255).astype(np.uint8)


def segment_dlo(
    rgb: np.ndarray,
    hsv_lower,
    hsv_upper,
    multi_color_dlo: bool = False,
) -> np.ndarray:
    """DLO segmentation mask (trackdlo_node.cpp:161-167).

    With ``multi_color_dlo``, uses the hardcoded blue + red(×2) + yellow
    bands of color_thresholding (trackdlo_node.cpp:88-119).
    """
    hsv = hsv_from_rgb(rgb)
    if not multi_color_dlo:
        return in_range(hsv, hsv_lower, hsv_upper)
    mask_blue = in_range(hsv, (90, 90, 60), (130, 255, 255))
    mask_red_1 = in_range(hsv, (130, 60, 50), (255, 255, 255))
    mask_red_2 = in_range(hsv, (0, 60, 50), (10, 255, 255))
    mask_yellow = in_range(hsv, (15, 100, 80), (40, 255, 255))
    return np.maximum.reduce([mask_blue, mask_red_1, mask_red_2, mask_yellow])


def apply_occlusion_mask(mask: np.ndarray, occlusion_mask: np.ndarray | None) -> np.ndarray:
    """AND the segmentation mask with a simulated-occlusion mask
    (trackdlo_node.cpp:172-180)."""
    if occlusion_mask is None:
        return mask
    occ = occlusion_mask
    if occ.ndim == 3:
        occ = occ.max(axis=-1)
    return np.where(occ != 0, mask, 0).astype(np.uint8)


def deproject(
    mask: np.ndarray, depth: np.ndarray, fx: float, fy: float, cx: float,
    cy: float, return_z_mm: bool = False,
):
    """Pinhole deprojection of masked pixels (trackdlo_node.cpp:195-233).

    ``depth`` is uint16 millimetres. Pixels with zero depth deproject to the
    origin and are kept, exactly like the reference (they are later removed by
    the EM's 0.1 m prune, trackdlo.cpp:177-195).

    With ``return_z_mm`` also returns the raw integer-mm depth per point, for
    the exact-mm voxel keys of :func:`voxel_downsample`.
    """
    vs, us = np.nonzero(mask)
    z_mm = depth[vs, us]
    z = z_mm.astype(np.float64) / 1000.0
    x = (us.astype(np.float64) - cx) * z / fx
    y = (vs.astype(np.float64) - cy) * z / fy
    pts = np.stack([x, y, z], axis=1)
    if return_z_mm:
        return pts, z_mm
    return pts


def voxel_downsample(
    points: np.ndarray, leaf_size: float, z_mm: np.ndarray | None = None
) -> np.ndarray:
    """Centroid-per-voxel downsampling (PCL VoxelGrid, trackdlo_node.cpp:236-241).

    Points are binned by floor(p / leaf) per axis; each occupied voxel emits
    the centroid of its points. Output order follows the voxel key sort; the
    EM is invariant to point order.

    ``z_mm``: optional per-point integer-mm depths. When given and the leaf
    is an integral number of millimetres, the z-axis voxel key is computed in
    the exact integer domain — floor(depth_mm / leaf_mm), true mathematics —
    matching the TPU pipeline's bit-pinned spec
    (ops/preprocess.voxel_parity_bits) so mm-quantized depths sitting exactly
    on voxel boundaries cannot flip between f32 and f64 paths. (PCL's own f32
    chain is rounding-chain-dependent at those knife edges; the integer spec
    is the chain-independent floor.)
    """
    if len(points) == 0:
        return points.reshape(0, 3)
    # PCL stores clouds in float32; quantize to match.
    pts = points.astype(np.float32).astype(np.float64)
    keys = np.floor(pts / leaf_size).astype(np.int64)
    if z_mm is not None:
        leaf_mm = leaf_size * 1000.0
        leaf_mm_i = int(round(leaf_mm))
        if leaf_mm_i > 0 and abs(leaf_mm - leaf_mm_i) < 1e-6:
            keys[:, 2] = np.asarray(z_mm, np.int64) // leaf_mm_i
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    keys_sorted = keys[order]
    pts_sorted = pts[order]
    boundary = np.any(np.diff(keys_sorted, axis=0) != 0, axis=1)
    group_ids = np.concatenate([[0], np.cumsum(boundary)])
    n_groups = group_ids[-1] + 1
    sums = np.zeros((n_groups, 3))
    np.add.at(sums, group_ids, pts_sorted)
    counts = np.bincount(group_ids, minlength=n_groups).astype(np.float64)
    return sums / counts[:, None]


def preprocess_frame(
    rgb: np.ndarray,
    depth: np.ndarray,
    params,
    intrinsics,
    occlusion_mask: np.ndarray | None = None,
) -> np.ndarray:
    """Full per-frame preprocessing chain → X (N×3) (trackdlo_node.cpp:155-243)."""
    mask = segment_dlo(rgb, params.hsv_lower, params.hsv_upper, params.multi_color_dlo)
    mask = apply_occlusion_mask(mask, occlusion_mask)
    pts, z_mm = deproject(
        mask, depth, intrinsics.fx, intrinsics.fy, intrinsics.cx,
        intrinsics.cy, return_z_mm=True,
    )
    return voxel_downsample(pts, params.downsample_leaf_size, z_mm=z_mm)
