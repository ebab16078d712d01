"""Recorded/synthetic RGB-D sequences.

The reference verifies on recorded rosbags of a blue rope in front of a
RealSense D435 (docs/RUN.md:90-115); those bags are external data. This module
provides the stand-in: a deterministic synthetic rope renderer producing
aligned RGB-D frames with known ground-truth node positions, plus .npz
sequence save/load. Synthetic sequences drive the integration tests, the
occlusion evaluation harness, and the benchmark.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from trackdlo_tpu_torch.config import CameraIntrinsics

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
    intrinsics: CameraIntrinsics | None = None,
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
    intr = intrinsics or CameraIntrinsics()
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


def synthetic_sequence(
    n_frames: int,
    rope: SyntheticRope | None = None,
    intrinsics: CameraIntrinsics | None = None,
    dt: float = 1.0 / 15.0,
    m_nodes: int = 45,
    **render_kwargs,
):
    """Generate a full sequence: frames + per-frame ground-truth nodes."""
    rope = rope or SyntheticRope()
    intr = intrinsics or CameraIntrinsics()
    frames = []
    gt = []
    for i in range(n_frames):
        t = i * dt
        rgb, depth = render_frame(rope, t, intr, **render_kwargs)
        frames.append((rgb, depth))
        gt.append(rope.nodes(t, m_nodes))
    return frames, np.array(gt)


def save_sequence(path: str, frames, gt_nodes: np.ndarray) -> None:
    rgbs = np.stack([f[0] for f in frames])
    depths = np.stack([f[1] for f in frames])
    np.savez_compressed(path, rgbs=rgbs, depths=depths, gt_nodes=gt_nodes)


def load_sequence(path: str):
    data = np.load(path)
    frames = [(data["rgbs"][i], data["depths"][i]) for i in range(len(data["rgbs"]))]
    return frames, data["gt_nodes"]


@dataclasses.dataclass
class CrossingRope:
    """A rope crossing over itself: near strand, end arc, far strand back.

    The projection of the two strands intersects mid-image with distinct
    depths — the self-occlusion scenario of the reference's evaluation
    (launch/evaluation.launch self_occlusion bag). Same interface as
    SyntheticRope.
    """

    half_span: float = 0.3
    slope: float = 0.11
    z_near: float = 0.62
    z_far: float = 0.66
    arc_radius: float = 0.06
    sway: float = 0.02
    n_curve_samples: int = 402

    def curve(self, t: float) -> np.ndarray:
        n_str = self.n_curve_samples // 3
        n_arc = self.n_curve_samples - 2 * n_str
        dy = self.sway * np.sin(2 * np.pi * 0.3 * t)

        # Near strand: lower-left -> upper-right.
        sa = np.linspace(0.0, 1.0, n_str, endpoint=False)
        ax = -self.half_span + 2 * self.half_span * sa
        ay = -self.slope + 2 * self.slope * sa + dy
        az = np.full(n_str, self.z_near)

        # Right-side arc connecting the strand ends: a half-sine bulge in x
        # at fixed y, with depth blending linearly z_near -> z_far so the turn
        # smoothly joins (half_span, slope+dy, z_near) to the far strand's
        # start (half_span, slope-dy ~ slope+dy, z_far).
        arc_s = np.linspace(0.0, 1.0, n_arc, endpoint=False)
        cx = self.half_span + self.arc_radius * np.sin(np.pi * arc_s)
        cy = np.full(n_arc, self.slope + dy)
        cz = self.z_near + (self.z_far - self.z_near) * arc_s

        # Far strand: upper-right -> lower-left (crosses the near strand).
        sb = np.linspace(0.0, 1.0, n_str)
        bx = self.half_span - 2 * self.half_span * sb
        by = self.slope - 2 * self.slope * sb - dy
        bz = np.full(n_str, self.z_far)

        x = np.concatenate([ax, cx, bx])
        y = np.concatenate([ay, cy, by])
        z = np.concatenate([az, cz, bz])
        return np.stack([x, y, z], axis=1)

    def nodes(self, t: float, m: int) -> np.ndarray:
        c = self.curve(t)
        seg = np.linalg.norm(np.diff(c, axis=0), axis=1)
        arc = np.concatenate([[0.0], np.cumsum(seg)])
        targets = np.linspace(0.0, arc[-1], m)
        out = np.empty((m, 3))
        for d in range(3):
            out[:, d] = np.interp(targets, arc, c[:, d])
        return out


@dataclasses.dataclass
class MovingRope:
    """Rigid sinusoidal translation of a base rope.

    The perpendicular_motion / parallel_motion evaluation scenarios
    (launch/evaluation.launch:15-16): a robot arm sweeps the rope across
    (perpendicular to) or along (parallel to) its own axis while a fixed
    occlusion rectangle hides whatever part of the rope passes through it
    (run_evaluation.cpp:235-258). Same interface as SyntheticRope.
    """

    base: SyntheticRope = dataclasses.field(default_factory=SyntheticRope)
    axis: tuple = (0.0, 1.0, 0.0)
    amplitude: float = 0.10
    period: float = 8.0
    offset: tuple = (0.0, 0.0, 0.0)
    # Fraction of the base rope's own wiggle speed retained during the sweep
    # (pure rigid translation when 0).
    base_motion: float = 0.25

    def curve(self, t: float) -> np.ndarray:
        shift = self.amplitude * np.sin(2 * np.pi * t / self.period)
        off = np.asarray(self.offset) + shift * np.asarray(self.axis, float)
        return self.base.curve(t * self.base_motion) + off

    def nodes(self, t: float, m: int) -> np.ndarray:
        return resample_nodes(self.curve(t), m)


@dataclasses.dataclass
class FoldingRope:
    """A rope folding in half over time (short_rope_folding analog,
    launch/evaluation.launch:18).

    Parametrized by heading angle along arc length: the heading turns by
    ``pi - alpha(t)`` through a smooth bend at the midpoint, so alpha = pi is
    a straight rope and alpha -> alpha_min a closed hairpin. The second arm
    ramps ``z_sep`` behind the first so the fold stays resolvable in depth
    (as a real rope folds onto the table next to itself). Same interface as
    SyntheticRope.
    """

    length: float = 0.38
    depth: float = 0.655
    alpha_min: float = 0.30
    fold_start: float = 0.5
    fold_duration: float = 6.0
    unfold: bool = False  # fold back out after fold_duration
    bend_sharpness: float = 10.0  # heading-turn concentration at the midpoint
    z_sep: float = 0.012
    sway: float = 0.01
    center: tuple = (-0.04, 0.0)
    n_curve_samples: int = 400

    def _alpha(self, t: float) -> float:
        u = (t - self.fold_start) / self.fold_duration
        if self.unfold:
            u = 1.0 - abs(1.0 - 2.0 * np.clip(u, 0.0, 1.0))
        u = np.clip(u, 0.0, 1.0)
        # Smoothstep fold progression.
        u = u * u * (3 - 2 * u)
        return np.pi + (self.alpha_min - np.pi) * u

    def curve(self, t: float) -> np.ndarray:
        n = self.n_curve_samples
        s = np.linspace(0.0, 1.0, n)
        turn = np.pi - self._alpha(t)
        # Heading turns by `turn` through a tanh-smoothed bend at s=0.5.
        phi = turn * 0.5 * (1.0 + np.tanh(self.bend_sharpness * (s - 0.5)))
        ds = self.length / (n - 1)
        x = np.concatenate([[0.0], np.cumsum(np.cos(phi[:-1]) * ds)])
        y = np.concatenate([[0.0], np.cumsum(np.sin(phi[:-1]) * ds)])
        # Depth separation ramps over the bend region.
        z = self.depth + self.z_sep * 0.5 * (1.0 + np.tanh(
            self.bend_sharpness * (s - 0.5)
        ))
        y = y + self.sway * np.sin(2 * np.pi * 0.25 * t) * np.sin(np.pi * s)
        pts = np.stack([x, y, z], axis=1)
        # Keep the folding rope centred in the frame.
        pts[:, 0] += self.center[0] - pts[:, 0].mean()
        pts[:, 1] += self.center[1] - pts[:, 1].mean()
        return pts

    def nodes(self, t: float, m: int) -> np.ndarray:
        return resample_nodes(self.curve(t), m)
