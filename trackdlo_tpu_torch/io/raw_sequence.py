"""Raw binary sequence format (.tdlo) for the native frame feeder.

Layout: u32 magic 'TDLO' | u32 version | u32 n_frames | u32 height |
u32 width, then per frame rgb u8[h*w*3] + depth u16[h*w], little-endian.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x4F4C4454  # 'TDLO'
VERSION = 1


def write_raw_sequence(path: str, frames) -> str:
    rgb0, depth0 = frames[0]
    h, w = depth0.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<5I", MAGIC, VERSION, len(frames), h, w))
        for rgb, depth in frames:
            assert rgb.shape == (h, w, 3) and depth.shape == (h, w)
            f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())
            f.write(np.ascontiguousarray(depth, "<u2").tobytes())
    return path


def read_raw_sequence(path: str):
    """Pure-Python reader (the native FrameFeeder is the fast path)."""
    with open(path, "rb") as f:
        magic, version, n, h, w = struct.unpack("<5I", f.read(20))
        if magic != MAGIC:
            raise IOError(f"bad magic in {path}")
        frames = []
        for _ in range(n):
            rgb = np.frombuffer(f.read(h * w * 3), np.uint8).reshape(h, w, 3)
            depth = np.frombuffer(f.read(h * w * 2), "<u2").reshape(h, w)
            frames.append((rgb, depth))
    return frames
