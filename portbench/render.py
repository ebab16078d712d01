"""The benchmark's traffic renderer: a synthetic rope in front of a D435.

A copy of the port's ``io/sequence.py`` renderer (``SyntheticRope``,
``render_frame``) and of the occlusion boxes of its
``evaluation/occlusion.py`` (``gt_bbox_rect``, ``rect_mask``, the upstream's
run_evaluation.cpp:113-232 and simulate_occlusion_eval.py), kept here so
that a change to the program cannot change the frames it is measured on.
``intrinsics`` is any object with ``fx``, ``fy``, ``cx``, ``cy``, ``width``
and ``height`` (:class:`portbench.reference.pipeline.Camera`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# A blue that lands inside the reference's live HSV band (H 90-130, S>=90,
# V>=30 under OpenCV conventions): pure-ish blue with a slight green tint.
_ROPE_RGB = np.array([30, 60, 200], dtype=np.uint8)
_BG_RGB = np.array([120, 120, 120], dtype=np.uint8)
# Tape-marker colours for the evaluation rope (the reference's ground truth
# comes from red/yellow tape blobs, evaluator.cpp:153-231).
_MARKER_RED = np.array([220, 30, 30], dtype=np.uint8)
_MARKER_YELLOW = np.array([230, 200, 40], dtype=np.uint8)
# Dark green inside the reference tip-tape band (H 58-90, S>=130, V 50-89,
# initialize.py:33-36).
_TIP_GREEN = np.array([30, 85, 30], dtype=np.uint8)


@dataclasses.dataclass
class SyntheticRope:
    """A parametric rope: a 3-D curve wiggling over time.

    The curve lives at z ≈ ``depth`` metres in front of the camera, spanning
    ``length`` metres horizontally, with sinusoidal lateral/vertical motion.
    """

    # Node spacing in pixels must exceed dlo_pixel_width/2 for the painter's
    # visibility check to behave as on the reference's real ropes (see
    # trackdlo_node.cpp:306-343): 0.8 m / 44 segments at 0.65 m depth gives
    # ~26 px spacing, and the full rope stays inside the 1280 px FOV vs the 20 px half-width.
    length: float = 0.8
    depth: float = 0.65
    amp_y: float = 0.08
    amp_z: float = 0.03
    waves: float = 1.5
    speed: float = 0.15
    n_curve_samples: int = 400

    def curve(self, t: float) -> np.ndarray:
        """Ground-truth curve points (n_curve_samples, 3) at time ``t``."""
        s = np.linspace(0.0, 1.0, self.n_curve_samples)
        phase = 2 * np.pi * (self.waves * s + self.speed * t)
        x = (s - 0.5) * self.length
        y = self.amp_y * np.sin(phase) * (0.4 + 0.6 * np.sin(np.pi * s))
        z = self.depth + self.amp_z * np.sin(phase * 0.7 + 1.0) * np.sin(np.pi * s)
        return np.stack([x, y, z], axis=1)

    def nodes(self, t: float, m: int) -> np.ndarray:
        """M nodes uniformly spaced in arc length along the curve."""
        return resample_nodes(self.curve(t), m)


def resample_nodes(curve_pts: np.ndarray, m: int) -> np.ndarray:
    """M points uniformly spaced in arc length along a sampled curve."""
    seg = np.linalg.norm(np.diff(curve_pts, axis=0), axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    targets = np.linspace(0.0, arc[-1], m)
    out = np.empty((m, 3))
    for d in range(3):
        out[:, d] = np.interp(targets, arc, curve_pts[:, d])
    return out


def render_frame(
    rope: SyntheticRope,
    t: float,
    intrinsics,
    rope_pixel_radius: int = 9,
    depth_noise_mm: float = 0.0,
    seed: int = 0,
    markers: int = 0,
    green_tip: bool = False,
    dropout_frac: float = 0.0,
    clutter_blobs: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Render an aligned RGB-D frame of the rope.

    Returns (rgb uint8 HxWx3, depth uint16 HxW millimetres). Background depth
    is 0 (no return), like unmatched RealSense pixels. With ``markers`` > 0,
    that many alternating red/yellow tape bands are painted at uniform arc
    length (the evaluation rope of the reference, evaluator.cpp:153-231).

    Degraded-input knobs modeling real D435 streams (the reference's
    verification medium is noisy recorded bags, docs/RUN.md:90-115):

    - ``depth_noise_mm``: i.i.d. Gaussian depth noise on rope pixels,
      mm-quantized like the sensor;
    - ``dropout_frac``: fraction of rope pixels losing their depth return
      (specular holes / unmatched stereo) — depth 0, RGB intact;
    - ``clutter_blobs``: rope-colored discs at other depths in the
      background (segmentation false positives the HSV mask passes and the
      prune/EM must reject).
    """
    intr = intrinsics
    h, w = intr.height, intr.width
    rgb = np.empty((h, w, 3), dtype=np.uint8)
    rgb[:] = _BG_RGB
    depth = np.zeros((h, w), dtype=np.uint16)

    pts = rope.curve(t)
    us = pts[:, 0] / pts[:, 2] * intr.fx + intr.cx
    vs = pts[:, 1] / pts[:, 2] * intr.fy + intr.cy

    colors = np.broadcast_to(_ROPE_RGB, (len(pts), 3)).copy()
    if green_tip:
        seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        arc = np.concatenate([[0.0], np.cumsum(seg)])
        colors[arc <= 0.025] = _TIP_GREEN  # 25 mm tip band at the head
    if markers:
        seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        arc = np.concatenate([[0.0], np.cumsum(seg)])
        band_centers = np.linspace(0.0, arc[-1], markers + 2)[1:-1]
        band_halfwidth = 0.008  # 8 mm tape bands
        for k, center in enumerate(band_centers):
            sel = np.abs(arc - center) <= band_halfwidth
            colors[sel] = _MARKER_RED if k % 2 == 0 else _MARKER_YELLOW

    # Rasterize the curve as overlapping discs (nearest-depth wins).
    zbuf = np.full((h, w), np.inf)
    r = rope_pixel_radius
    dyx = np.mgrid[-r : r + 1, -r : r + 1]
    disc = (dyx[0] ** 2 + dyx[1] ** 2) <= r * r
    dv, du = dyx[0][disc], dyx[1][disc]
    for k in range(len(pts)):
        u0, v0, z = int(round(us[k])), int(round(vs[k])), pts[k, 2]
        uu = u0 + du
        vv = v0 + dv
        ok = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        uu, vv = uu[ok], vv[ok]
        closer = z < zbuf[vv, uu]
        uu, vv = uu[closer], vv[closer]
        zbuf[vv, uu] = z
        rgb[vv, uu] = colors[k]
        depth[vv, uu] = np.uint16(round(z * 1000.0))

    rng = None
    if depth_noise_mm > 0 or dropout_frac > 0 or clutter_blobs > 0:
        rng = np.random.default_rng(seed)

    if clutter_blobs > 0:
        # Rope-colored discs at depths in front of / behind the rope plane:
        # pass the HSV mask, must be rejected by the 0.1 m node prune
        # (trackdlo.cpp:177-195) or absorbed as EM outliers.
        zs = pts[:, 2]
        for _ in range(clutter_blobs):
            cu = int(rng.integers(r, w - r))
            cv = int(rng.integers(r, h - r))
            cz = float(rng.uniform(zs.min() - 0.4, zs.max() + 0.4))
            if cz <= 0.05:
                continue
            uu = cu + du
            vv = cv + dv
            keep = depth[vv, uu] == 0  # don't overwrite the rope
            rgb[vv[keep], uu[keep]] = _ROPE_RGB
            depth[vv[keep], uu[keep]] = np.uint16(round(cz * 1000.0))

    if depth_noise_mm > 0:
        on = depth > 0
        noise = rng.normal(0.0, depth_noise_mm, size=int(on.sum()))
        depth_f = depth.astype(np.int64)
        depth_f[on] += np.round(noise).astype(np.int64)
        depth = np.clip(depth_f, 0, 65535).astype(np.uint16)

    if dropout_frac > 0:
        on = np.argwhere(depth > 0)
        k = int(len(on) * dropout_frac)
        if k:
            sel = on[rng.choice(len(on), size=k, replace=False)]
            depth[sel[:, 0], sel[:, 1]] = 0

    return rgb, depth


def rect_mask(height: int, width: int, rect) -> np.ndarray:
    """Boolean keep-mask with the rectangle blacked out (the
    /mask_with_occlusion equivalent, simulate_occlusion_eval.py)."""
    x1, y1, x2, y2 = rect
    mask = np.ones((height, width), bool)
    x1 = max(int(x1), 0)
    y1 = max(int(y1), 0)
    x2 = min(int(x2), width - 1)
    y2 = min(int(y2), height - 1)
    if x2 >= x1 and y2 >= y1:
        mask[y1 : y2 + 1, x1 : x2 + 1] = False
    return mask


def gt_bbox_rect(
    y_true: np.ndarray,
    pct_occlusion: float,
    proj_matrix: np.ndarray,
    height: int,
    width: int,
    extra_border: int = 30,
):
    """Occlude the first pct% of ground-truth nodes: 3-D bbox of those nodes
    projected to pixels + border (run_evaluation.cpp:113-232).

    Returns the rectangle or None when pct rounds to zero nodes.
    """
    n_occ = int(len(y_true) * pct_occlusion / 100.0)
    if n_occ == 0:
        return None
    sel = y_true[:n_occ]
    corners = np.stack([sel.min(axis=0), sel.max(axis=0)])
    h = np.hstack([corners, np.ones((2, 1))])
    img = (proj_matrix @ h.T).T
    px = (img[:, 0] / img[:, 2]).astype(int)
    py = (img[:, 1] / img[:, 2]).astype(int)
    x1, x2 = sorted((px[0], px[1]))
    y1, y2 = sorted((py[0], py[1]))
    return (
        max(x1 - extra_border, 0),
        max(y1 - extra_border, 0),
        min(x2 + extra_border, width - 1),
        min(y2 + extra_border, height - 1),
    )
