"""RealSense-style camera preset ingestion (L8 config analog).

The reference ships config/preset_decimation_4.0_depth_step_100.json and
loads it into the D435 *firmware* via realsense-ros
(launch/realsense_node.launch:4, docs/RUN.md:80). The tracking node never
reads the file — it only sees its consequences on the depth stream:

- depth quantized to ``param-zunits`` sensor units (100 µm in the shipped
  preset — the "depth_step_100" in the filename),
- depth clamped to [``param-depthclampmin``, ``param-depthclampmax``] units,
- a 1280x720 stream (``viewer.stream-*``),
- a decimation filter (the "decimation_4.0" filename convention of the
  realsense-ros pipeline the preset is documented to run under).

On TPU there is no firmware, so this module re-creates those consequences as
explicit host-side frame transforms: recorded or synthetic streams can be
pushed through ``sensor_depth_mm`` / ``decimate_depth`` to reproduce the
reference's exact sensor regime (quantization step included — it decides
which depth values sit on voxel knife edges).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, replace

import numpy as np

from trackdlo_tpu_torch.config import CameraIntrinsics


@dataclass(frozen=True)
class CameraPreset:
    """Parsed firmware preset (schema of the RealSense json export)."""

    name: str = "Intel RealSense D435"
    fw_version: str = ""
    depth_units_um: float = 100.0  # param-zunits: micrometres per unit
    depth_clamp_units: tuple[int, int] = (0, 65536)  # param-depthclamp{min,max}
    stream_width: int = 1280
    stream_height: int = 720
    stream_fps: int = 30
    decimation: int = 4  # filename convention "preset_decimation_<f>_..."

    @property
    def depth_scale_mm(self) -> float:
        """Millimetres per sensor unit (0.1 mm for the shipped preset)."""
        return self.depth_units_um / 1000.0

    @property
    def depth_clamp_mm(self) -> tuple[float, float]:
        lo, hi = self.depth_clamp_units
        return lo * self.depth_scale_mm, hi * self.depth_scale_mm


def load_preset(path: str, decimation: int | None = None) -> CameraPreset:
    """Parse a RealSense firmware-preset json export.

    ``decimation`` overrides the factor otherwise recovered from the
    ``preset_decimation_<f>_...`` filename convention (the json itself has no
    decimation field — the filter runs in the realsense-ros pipeline, not
    the firmware)."""
    with open(path) as f:
        data = json.load(f)
    dev = data.get("device", {})
    par = data.get("parameters", {})
    view = data.get("viewer", {})
    if decimation is None:
        m = re.search(r"decimation[_-]?([0-9]+(?:\.[0-9]+)?)", path)
        decimation = int(float(m.group(1))) if m else 1
    return CameraPreset(
        name=dev.get("name", ""),
        fw_version=dev.get("fw version", ""),
        depth_units_um=float(par.get("param-zunits", 1000)),
        depth_clamp_units=(
            int(float(par.get("param-depthclampmin", 0))),
            int(float(par.get("param-depthclampmax", 65536))),
        ),
        stream_width=int(view.get("stream-width", 1280)),
        stream_height=int(view.get("stream-height", 720)),
        stream_fps=int(view.get("stream-fps", 30)),
        decimation=decimation,
    )


def sensor_depth_mm(depth_mm: np.ndarray, preset: CameraPreset) -> np.ndarray:
    """Apply the preset's sensor model to float depth (mm → mm).

    Quantizes to the preset's depth units and clamps to the firmware depth
    clamp, returning float mm (callers round to their topic's integer mm
    afterwards, as realsense-ros does for aligned_depth_to_color). With the
    shipped 100 µm units this changes values by <0.05 mm but moves exactly
    the knife-edge depths that flip voxel-boundary floor() results."""
    step = preset.depth_scale_mm
    lo, hi = preset.depth_clamp_mm
    units = np.round(np.asarray(depth_mm, np.float64) / step)
    return np.clip(units * step, lo, hi).astype(np.float32)


def decimate_depth(depth: np.ndarray, preset: CameraPreset) -> np.ndarray:
    """Decimation filter: factor×factor blocks → mean of NON-ZERO pixels.

    librealsense's decimation_filter reduces resolution and fills each
    output pixel from the valid (non-zero) pixels of its block; zero stays
    zero (no depth). Host-side numpy — this is an io-path op, never the hot
    path."""
    f = int(preset.decimation)
    if f <= 1:
        return depth
    h, w = depth.shape
    hh, ww = h // f * f, w // f * f
    blocks = depth[:hh, :ww].reshape(hh // f, f, ww // f, f).astype(np.float64)
    nz = (blocks > 0).sum(axis=(1, 3))
    s = blocks.sum(axis=(1, 3))
    out = np.where(nz > 0, s / np.maximum(nz, 1), 0.0)
    return np.round(out).astype(depth.dtype)


def decimated_intrinsics(
    intr: CameraIntrinsics, preset: CameraPreset
) -> CameraIntrinsics:
    """Intrinsics of the decimated stream (focal lengths and principal point
    scale with resolution; the realsense pipeline republishes camera_info
    this way after its decimation filter)."""
    f = int(preset.decimation)
    if f <= 1:
        return intr
    return replace(
        intr,
        width=intr.width // f,
        height=intr.height // f,
        fx=intr.fx / f,
        fy=intr.fy / f,
        cx=intr.cx / f,
        cy=intr.cy / f,
    )
