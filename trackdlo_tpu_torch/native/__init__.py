"""The native (C++) host runtime of the port, bound with ctypes.

Counterpart of trackdlo_tpu/native: ``preprocess.cpp`` is the JAX package's
source byte for byte (host-side HSV mask → deprojection → voxel
downsample at native speed, and a threaded double-buffered reader of
``.tdlo`` raw sequences). The library is built with ``g++`` at first use into
``build/trackdlo_tpu_torch_native/`` beside the package (never beside the
source), named by a hash of the source and the flags, under a file lock so
that parallel processes build it once and none loads a half-written file. A
failed build raises with the compiler's message; :func:`available` is False
only where there is no ``g++``.

- :func:`preprocess_frame`: an (N, 3) float64 cloud, which
  ``Tracker.step_from_points`` takes (its CUDA graph on the card);
- :class:`FrameFeeder`: the frames of a raw sequence, which ``Tracker.step``
  takes.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "trackdlo_tpu_torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None


def _gxx() -> str | None:
    return shutil.which("g++")


def available() -> bool:
    """Whether the library can be built here (``g++`` is on the PATH)."""
    return _gxx() is not None


def build() -> Path:
    """Compile the library for the current source and flags if it is
    missing (a few seconds); returns its path. Raises with the compiler's
    output if the build fails."""
    gxx = _gxx()
    if gxx is None:
        raise RuntimeError("g++ not found: the native library cannot be built")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libtrackdlo_native_{digest}.so"
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([gxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tdlo_hsv_mask.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_void_p,
            ]
            lib.tdlo_preprocess_frame.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
                ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.tdlo_preprocess_frame.restype = ctypes.c_int
            lib.tdlo_feeder_open.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.tdlo_feeder_open.restype = ctypes.c_void_p
            lib.tdlo_feeder_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.tdlo_feeder_next.restype = ctypes.c_int
            lib.tdlo_feeder_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def hsv_mask(rgb: np.ndarray, lower, upper, multi_color: bool = False) -> np.ndarray:
    """The (H, W) u8 HSV mask of an (H, W, 3) u8 frame (255 = kept)."""
    lib = _load()
    h, w = rgb.shape[:2]
    rgb = np.ascontiguousarray(rgb, np.uint8)
    out = np.empty((h, w), np.uint8)
    lo = (ctypes.c_int * 3)(*lower)
    hi = (ctypes.c_int * 3)(*upper)
    lib.tdlo_hsv_mask(rgb.ctypes.data, h, w, lo, hi, int(multi_color), out.ctypes.data)
    return out


def preprocess_frame(rgb: np.ndarray, depth: np.ndarray, params, intrinsics,
                     occlusion_mask: np.ndarray | None = None,
                     max_points: int = 8192) -> np.ndarray:
    """The fused mask → deprojection → voxel downsample of one frame on the
    host: an (N, 3) float64 cloud, at most ``max_points`` rows."""
    lib = _load()
    h, w = depth.shape
    rgb = np.ascontiguousarray(rgb, np.uint8)
    depth = np.ascontiguousarray(depth, np.uint16)
    occ_ptr = None
    if occlusion_mask is not None:
        occ = np.ascontiguousarray((occlusion_mask != 0).astype(np.uint8))
        if occ.ndim == 3:
            occ = occ.max(axis=-1)
        occ_ptr = occ.ctypes.data
    out = np.empty((max_points, 3), np.float64)
    lo = (ctypes.c_int * 3)(*params.hsv_lower)
    hi = (ctypes.c_int * 3)(*params.hsv_upper)
    n = lib.tdlo_preprocess_frame(
        rgb.ctypes.data, depth.ctypes.data, occ_ptr, h, w, lo, hi,
        int(params.multi_color_dlo),
        intrinsics.fx, intrinsics.fy, intrinsics.cx, intrinsics.cy,
        params.downsample_leaf_size, out.ctypes.data, max_points,
    )
    return out[:n].copy()


class FrameFeeder:
    """Threaded double-buffered reader of ``.tdlo`` raw sequences: iterate
    for (rgb (H, W, 3) u8, depth (H, W) u16) frames; close it (or use it as
    a context manager) to stop its thread."""

    def __init__(self, path: str, n_slots: int = 4):
        lib = _load()
        nf = ctypes.c_uint32()
        hh = ctypes.c_uint32()
        ww = ctypes.c_uint32()
        self._handle = lib.tdlo_feeder_open(
            path.encode(), n_slots, ctypes.byref(nf), ctypes.byref(hh), ctypes.byref(ww)
        )
        if not self._handle:
            raise IOError(f"cannot open raw sequence {path}")
        self._lib = lib
        self.n_frames = nf.value
        self.height = hh.value
        self.width = ww.value

    def __iter__(self):
        while True:
            rgb = np.empty((self.height, self.width, 3), np.uint8)
            depth = np.empty((self.height, self.width), np.uint16)
            idx = self._lib.tdlo_feeder_next(self._handle, rgb.ctypes.data, depth.ctypes.data)
            if idx < 0:
                break
            yield rgb, depth

    def close(self):
        if self._handle:
            self._lib.tdlo_feeder_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
