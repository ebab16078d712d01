"""Pseudo-real depth reconstruction from a single photograph.

No real RGB-D recording exists in this environment — the reference's rosbags
are external DOI downloads (reference docs/RUN.md:90-115) and no depth sample
ships with any installed package — so this module builds the best available
stand-in for a real sensor's depth map, explicitly labeled second-best
evidence (VERDICT r4 item 7, RESULTS.md "Real data"):

- GEOMETRY FROM THE REAL PHOTO: the rope cross-section profile comes from
  the segmentation mask's distance transform (a cylinder chord), and fine
  surface relief comes from the photograph's actual shading (high-passed
  luminance, shape-from-shading style) — so real photon statistics enter
  the depth channel, not just the RGB channel.
- AN EXPLICIT SENSOR ARTIFACT MODEL, shaped after the RealSense D435 the
  reference records from (trackdlo_node.cpp consumes uint16 mm frames on
  /camera/aligned_depth_to_color/image_raw):
    * millimetre quantization (uint16 z16 format),
    * Gaussian z-noise (~1-2 mm RMS at the 0.5-0.7 m working range),
    * mixed ("flying") pixels on silhouette edges — depth blends between
      foreground and background where the correlation window straddles both,
    * a one-sided stereo occlusion shadow (invalid band on the background
      immediately right of the foreground edge, from the IR-projector /
      right-imager baseline),
    * speckle dropout holes (correlation failures), and
    * the sensor's invalid left-edge band.
  Invalid pixels are 0, the z16 convention the pipeline already excludes
  (ops/preprocess.preprocess_frame masks z > 0, matching the reference's
  zero-depth deproject-to-origin behavior).

What this can NOT stand in for (the remaining real-depth risk, named in
RESULTS.md): texture-dependent correlation holes (real dropout correlates
with IMAGE content, ours is spatially random), RGB-depth extrinsic
misalignment after imperfect alignment, temporal flicker correlation, and
multi-path/IR interference. Those need a real recording.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def pseudo_surface_mm(
    rgb: np.ndarray,
    mask: np.ndarray,
    *,
    plane_z_mm: float = 650.0,
    tilt_mm_per_px: tuple[float, float] = (0.03, 0.10),
    rope_radius_mm: float = 6.0,
    shading_mm: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Clean (pre-sensor) scene depth in float mm.

    Returns ``(surface, plane)``: the scene with the rope proud of the desk,
    and the bare desk plane (needed by the mixed-pixel model).

    - The desk is a TILTED plane (real tripod shots never view a desk
      fronto-parallel; the tilt makes voxel z-boundaries sweep across the
      image the way recorded data does).
    - The rope bump is a cylinder chord: height = R*sqrt(1-(1-t)^2) with t
      the normalized distance-transform depth into the mask.
    - High-passed luminance of the REAL photo adds +-``shading_mm`` of
      surface relief inside the mask (strands, sheen — real texture).
    """
    h, w = mask.shape
    vs, us = np.mgrid[0:h, 0:w].astype(np.float64)
    plane = (
        plane_z_mm
        + tilt_mm_per_px[0] * (us - w / 2.0)
        + tilt_mm_per_px[1] * (vs - h / 2.0)
    )
    dt = ndimage.distance_transform_edt(mask)
    halfw = float(np.quantile(dt[mask], 0.98)) if mask.any() else 1.0
    t = np.clip(dt / max(halfw, 1e-6), 0.0, 1.0)
    bump = rope_radius_mm * np.sqrt(np.clip(1.0 - (1.0 - t) ** 2, 0.0, 1.0))

    gray = rgb.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
    relief = gray - ndimage.uniform_filter(gray, size=9)
    sd = float(relief[mask].std()) if mask.any() else 0.0
    if sd > 0:
        relief = relief * (shading_mm / sd)
    surface = plane - (bump + np.where(mask, relief, 0.0)) * mask
    return surface, plane


def apply_sensor_model(
    surface_mm: np.ndarray,
    plane_mm: np.ndarray,
    mask: np.ndarray,
    rng: np.random.Generator,
    *,
    noise_mm: float = 1.2,
    mixed_px: int = 1,
    shadow_px: int = 3,
    speckle_frac: float = 0.003,
    left_band_px: int = 16,
) -> np.ndarray:
    """One sensor readout of the clean scene → uint16 mm with artifacts.

    Call once per frame with a fresh ``rng`` stream to emulate a live feed
    (the noise, flying pixels, and holes all re-roll per frame, as they do
    on a real stereo sensor)."""
    d = surface_mm + rng.normal(0.0, noise_mm, surface_mm.shape)

    # Mixed/flying pixels: the correlation window straddles rope + desk on
    # the silhouette → depth lands anywhere between the two.
    er = ndimage.binary_erosion(mask, iterations=mixed_px) if mixed_px else mask
    edge = mask & ~er
    alpha = rng.uniform(0.0, 1.0, surface_mm.shape)
    d = np.where(edge, alpha * d + (1.0 - alpha) * plane_mm, d)

    # Stereo occlusion shadow: background just right of a foreground edge is
    # invisible to the second imager → invalid.
    shadow = np.zeros_like(mask)
    for k in range(1, shadow_px + 1):
        shifted = np.zeros_like(mask)
        shifted[:, k:] = mask[:, :-k]
        shadow |= shifted
    shadow &= ~mask

    # Speckle holes: spatially random correlation failures, slightly dilated
    # (real holes are blobs, not salt).
    speckle = rng.uniform(size=surface_mm.shape) < speckle_frac
    speckle = ndimage.binary_dilation(speckle, iterations=1)

    out = np.round(np.clip(d, 0.0, 65535.0)).astype(np.uint16)
    out[shadow | speckle] = 0
    if left_band_px:
        out[:, :left_band_px] = 0
    return out


def pseudo_depth_from_photo(
    rgb: np.ndarray,
    mask: np.ndarray,
    seed: int = 0,
    **kwargs,
) -> np.ndarray:
    """Convenience: clean surface + one sensor readout (uint16 mm)."""
    surf_keys = {"plane_z_mm", "tilt_mm_per_px", "rope_radius_mm", "shading_mm"}
    surf_kw = {k: v for k, v in kwargs.items() if k in surf_keys}
    sens_kw = {k: v for k, v in kwargs.items() if k not in surf_keys}
    surface, plane = pseudo_surface_mm(rgb, mask, **surf_kw)
    return apply_sensor_model(
        surface, plane, mask, np.random.default_rng(seed), **sens_kw
    )
