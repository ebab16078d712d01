"""PCL VoxelGrid over a masked, deprojected frame, in plain torch and float64.

The plain reference of the step's preprocessing (its exact route): the
reference's HSV mask AND the occlusion mask, the pinhole deprojection of
every masked pixel and PCL's VoxelGrid (trackdlo_node.cpp:155-243), as
:mod:`trackdlo_tpu_torch.oracle.preprocess` computes them in NumPy, written
in torch so that it also runs on the card. Masked pixels with no depth
return deproject to the origin and stay in the cloud, as upstream (the EM's
0.1 m prune drops them, trackdlo.cpp:177-195).

- The HSV conversion is OpenCV's, re-derived in float32 and rounded to u8
  (the NumPy fallback of ``oracle.preprocess.hsv_from_rgb``), then
  ``cv2.inRange`` on the u8 values.
- PCL keeps its clouds in float32: the points are rounded to float32
  before they are binned; x and y bin as floor(p / leaf) in float64, z in
  the integer-millimetre domain where the leaf is a whole number of
  millimetres (``oracle.preprocess.voxel_downsample``).
- Each occupied voxel emits the float64 mean of its points, in ascending
  (x, y, z) voxel order.

Imports no kernel of the port. Float32 products on a card would run in TF32
where allowed; nothing here multiplies matrices, and both switches are off.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_MULTI_COLOR_BANDS = (
    ((90, 90, 60), (130, 255, 255)),
    ((130, 60, 50), (255, 255, 255)),
    ((0, 60, 50), (10, 255, 255)),
    ((15, 100, 80), (40, 255, 255)),
)


def hsv_from_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """OpenCV-convention HSV (H in [0, 180)) as u8 from u8 RGB (..., 3)."""
    rgbf = rgb.to(torch.float32) / 255.0
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    v = rgbf.amax(dim=-1)
    mn = rgbf.amin(dim=-1)
    delta = v - mn
    s = torch.where(v > 0, delta / torch.clamp_min(v, 1e-12), 0.0)
    nz = delta > 0
    rmax = nz & (v == r)
    gmax = nz & (v == g) & ~rmax
    bmax = nz & ~rmax & ~gmax
    safe = torch.where(nz, delta, 1.0)
    h = torch.zeros_like(v)
    h = torch.where(rmax, 60.0 * ((g - b) / safe), h)
    h = torch.where(gmax, 60.0 * ((b - r) / safe) + 120.0, h)
    h = torch.where(bmax, 60.0 * ((r - g) / safe) + 240.0, h)
    h = torch.where(h < 0, h + 360.0, h)
    out = torch.stack([h / 2.0, s * 255.0, v * 255.0], dim=-1)
    return torch.round(out).to(torch.uint8)


def segment_mask(rgb, hsv_lower, hsv_upper, multi_color_dlo: bool = False) -> torch.Tensor:
    """The DLO mask (trackdlo_node.cpp:161-167): u8 HSV within a band, any
    of the four hardcoded bands with ``multi_color_dlo``."""
    hsv = hsv_from_rgb(rgb).to(torch.int32)
    bands = _MULTI_COLOR_BANDS if multi_color_dlo else ((hsv_lower, hsv_upper),)
    mask = torch.zeros(hsv.shape[:-1], dtype=torch.bool, device=hsv.device)
    for lo, hi in bands:
        lo = torch.tensor(lo, dtype=torch.int32, device=hsv.device)
        hi = torch.tensor(hi, dtype=torch.int32, device=hsv.device)
        mask |= ((hsv >= lo) & (hsv <= hi)).all(dim=-1)
    return mask


def deproject(mask, depth, fx, fy, cx, cy):
    """(points (N, 3) float64, z in millimetres (N,) int64) of the masked
    pixels in raster order (trackdlo_node.cpp:195-233); no depth gives the
    origin."""
    vs, us = torch.nonzero(mask, as_tuple=True)
    z_mm = depth.to(torch.int64)[vs, us] & 0xFFFF
    z = z_mm.to(torch.float64) / 1000.0
    x = (us.to(torch.float64) - cx) * z / fx
    y = (vs.to(torch.float64) - cy) * z / fy
    return torch.stack([x, y, z], dim=1), z_mm


def voxel_grid(points: torch.Tensor, leaf: float, z_mm: torch.Tensor | None = None):
    """PCL VoxelGrid: the float64 centroid of each occupied voxel, in
    ascending voxel order (points rounded to float32 first; z binned on
    integer millimetres where ``z_mm`` is given and the leaf is whole)."""
    if len(points) == 0:
        return points.reshape(0, 3)
    pts = points.to(torch.float32).to(torch.float64)
    keys = torch.floor(pts / leaf).to(torch.int64)
    leaf_mm = round(leaf * 1000.0)
    if z_mm is not None and leaf_mm > 0 and abs(leaf * 1000.0 - leaf_mm) < 1e-6:
        keys[:, 2] = z_mm // leaf_mm
    uniq, group = torch.unique(keys, dim=0, return_inverse=True)
    sums = torch.zeros((len(uniq), 3), dtype=torch.float64, device=pts.device)
    sums.index_add_(0, group, pts)
    counts = torch.zeros(len(uniq), dtype=torch.float64, device=pts.device)
    counts.index_add_(0, group, torch.ones(len(pts), dtype=torch.float64, device=pts.device))
    return sums / counts[:, None]


def preprocess_frame(rgb, depth, occlusion_mask, fx, fy, cx, cy, hsv_lower, hsv_upper,
                     multi_color_dlo: bool, leaf: float) -> torch.Tensor:
    """The masked frame's VoxelGrid cloud (N, 3) float64: ``rgb`` (H, W, 3)
    u8, ``depth`` (H, W) u16 millimetres (or their int16 bits),
    ``occlusion_mask`` (H, W), nonzero keeps a pixel (None keeps all)."""
    mask = segment_mask(rgb, hsv_lower, hsv_upper, multi_color_dlo)
    if occlusion_mask is not None:
        mask &= occlusion_mask != 0
    pts, z_mm = deproject(mask, depth, fx, fy, cx, cy)
    return voxel_grid(pts, leaf, z_mm)
