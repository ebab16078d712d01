"""Build and load the port's CUDA kernels, and count their launches.

Each source under ``csrc/`` compiles with its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so the build takes seconds). The library lands in ``build/trackdlo_tpu_torch/``
beside the package and is rebuilt only when a hash of the sources and flags
changes. ``--use_fast_math`` is never passed: the voxel parity floors are
bit-pinned to the plain version's IEEE float32 chain, and ``-fmad=false``
keeps ``a*b+c`` from contracting into an FMA where the plain version rounds
twice (kernels that want an FMA call ``fmaf`` explicitly).

Every C entry point returns the ``cudaError_t`` of its launch; :func:`check`
raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "trackdlo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_ulonglong

# C entry points and their argument types (pointers and the stream last as
# c_void_p, so ctypes never truncates a 64-bit address).
SIGNATURES = {
    "trackdlo_em_loop": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # dyn..x_mask
        _I, _I,  # m, n
        _F, _F, _F, _F, _F, _F, _F, _I,  # muf k_vis tau lam lle alpha tol max_iter
        _P, _P,  # y_out, stats
        _P,  # stream
    ],
    "trackdlo_visibility": [
        _P, _P, _P, _P, _P,  # y, x, x_mask, proj, coord
        _I, _I, _I, _I, _I,  # n_streams, m, n, img_rows, img_cols
        _F, _F, _F,  # tau_vis, w_half, d_vis
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # outputs
        _P,
    ],
    "trackdlo_walks": [
        _P, _P, _P,  # guides, seglens, ints
        _I, _I, _F,  # n_walks, m, eps
        _P, _P,  # pos, valid
        _P,
    ],
    "trackdlo_cell_sums": [
        _P, _P, _P,  # rgb, depth, occ
        _I, _I, _I, _I,  # n_streams, h, w, cell_px
        _P, _I,  # hsv bands, n_bands
        _F, _F, _F, _F,  # fx fy cx cy
        _F, _F, _F, _F, _I,  # kx ky k_zq kz z_from_mm
        _I,  # mode: 0 parity, 1 one channel, 2 one channel with the floor votes
        _P,  # out
        _P,
    ],
    "trackdlo_compact": [
        _P, _P, _P, _P, _P,  # xs, ys, zs, counts, kept (null: derived from the counts)
        _I, _I, _I, _I,  # n_channels, n_per, cap_per, divide
        _P, _P, _P,  # pts, cnt, valid
        _P,
    ],
    "trackdlo_estep": [
        _P, _P, _P, _P, _P, _P, _P,  # scal, y, coord, nm, pv, x, x_mask
        _I, _I, _I, _I,  # n_streams, m, n, two_phase
        _P, _P, _P, _P,  # p1, px, stats, short_sq
        _P,
    ],
    "trackdlo_gj_solve": [
        _P, _P,  # a, b
        _I, _I,  # n_systems, m
        _P,  # w
        _P,
    ],
    "trackdlo_gj_solve_update": [
        _P, _P, _P, _P,  # a, b, g, y0
        _I, _I,  # n_systems, m
        _P, _P,  # w, t
        _P,
    ],
    "trackdlo_em_iter": [
        _P, _I, _P, _P,  # sigma2, its stride, dyn, c's (null: from dyn)
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # y, y0, coord, nm, g, hg, hy0, jg, pd, x, x_mask
        _I, _I, _I,  # n_streams, m, n
        _F, _F, _F, _F, _F, _F,  # muf, k_vis, tau_vis, lam, coef_lle, alpha
        _P, _P,  # t, stats
        _P,
    ],
    "trackdlo_nearest": [
        _P, _P, _P, _P,  # y, node_mask, x, x_mask
        _I, _I, _I,  # n_streams, m, n
        _I, _I,  # node_mask and x_mask one byte a value (bool), else float32
        _P,  # out
        _P,
    ],
    # The unbounded builds (past 128 nodes; W and N dispatch inside their
    # entry points): the bounded entry points' arguments and a global
    # workspace before the stream; each kernel's workspace in bytes for B
    # streams of m nodes and n rows (0 where m takes a bounded build).
    "trackdlo_em_loop_ub": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _I,
        _P, _P,
        _P,  # workspace
        _P,
    ],
    "trackdlo_estep_ub": [
        _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I,
        _P, _P, _P, _P,
        _P,  # workspace
        _P,
    ],
    "trackdlo_gj_solve_ub": [
        _P, _P, _P, _P,  # a, b, g, y0 (g, y0 null: the solve alone)
        _I, _I,
        _P, _P,  # w, t (null with g)
        _P,  # workspace
        _P,
    ],
    "trackdlo_em_iter_ub": [
        _P, _I, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I,
        _F, _F, _F, _F, _F, _F,
        _P, _P,
        _P,  # workspace
        _P,
    ],
    "trackdlo_visibility_ub": [
        _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I,
        _F, _F, _F,
        _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P,  # workspace
        _P,
    ],
    **{f"trackdlo_{k}_workspace": [_I, _I, _I, _P]
       for k in ("em_loop", "estep", "gj_solve", "em_iter", "visibility")},
    # Kernels E, S and F launch as thread-block clusters: for n rows and m
    # nodes, the cluster size, the rows per CTA, how many clusters the card
    # holds and a CTA's shared memory.
    "trackdlo_em_loop_cluster_info": [_I, _I, _P],
    "trackdlo_estep_cluster_info": [_I, _I, _P],
    "trackdlo_em_iter_cluster_info": [_I, _I, _P],
    # Kernel L and the conditional WHILE node of the EM loop in a CUDA graph
    # (csrc/loop_flag.cu).
    "trackdlo_loop_flag": [
        _P, _P,  # done, it
        _I, _I,  # n_streams, max_iter
        _U, _I,  # conditional handle, set it
        _P, _P, _I,  # flag out, trips counter, opening launch
        _P,
    ],
    "trackdlo_while_handle": [_P, _P],  # stream, handle out
    "trackdlo_while_open": [_P, _U, _P],  # stream, handle, body stream
    "trackdlo_while_close": [_P],  # body stream
    # The span recorder's device stamps (csrc/stamp.cu; utils/profiling.py):
    # not counted in launch_counts.
    "trackdlo_stamp": [_P, _P, _P, _I, _I, _P],  # header, times, tags, capacity, tag, stream
    "trackdlo_timer_step": [_P, _I, _P],  # out, changes, stream
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None

# Launch counters: each kernel wrapper adds one where it launches its kernel.
launch_counts = {
    "cell_sums": 0, "compact": 0, "visibility": 0, "walks": 0, "em_loop": 0,
    "estep": 0, "estep_batch": 0, "gj_solve": 0,
    "cell_sums_votes": 0, "cell_sums_cells": 0, "em_iteration": 0, "nearest": 0,
    "loop_flag": 0,
}


# Launches that only the card can count: the trips of an EM loop inside a
# CUDA graph (ops/graph_loop.py). Each counter has a ``settle()`` that reads
# its device tally (a host synchronisation), zeroes it and returns the
# launches since its last call.
_device_counters: weakref.WeakSet = weakref.WeakSet()


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def register_device_counter(counter) -> None:
    _device_counters.add(counter)


def settle_counts() -> dict:
    """Add the launches the card counted since the last call (the replayed
    graphs' loop trips) to ``launch_counts`` and return ``launch_counts``.
    Reads the card: call it outside timed or replayed work."""
    for counter in list(_device_counters):
        add_counts(counter.settle())
    return launch_counts


def reset_launch_counts() -> None:
    for counter in list(_device_counters):
        counter.settle()
    for k in launch_counts:
        launch_counts[k] = 0


def add_counts(delta: dict) -> None:
    """Add a difference of two copies of ``launch_counts`` to the counters
    (a CUDA graph's replay adds the launches its capture recorded)."""
    for k, v in delta.items():
        launch_counts[k] += v


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from trackdlo_tpu_torch.device import nvcc_path

    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _run_all(cmds: list[list[str]], verbose: bool) -> None:
    """Run the commands side by side; raise with the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if verbose or proc.returncode != 0:
            print(out, end="")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library for the current sources is
    missing; returns its path."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libtrackdlo_{_source_hash()}.so"
    if out.exists():
        return out
    obj_dir = BUILD_DIR / f"obj_{out.stem}.{os.getpid()}"
    obj_dir.mkdir(exist_ok=True)
    nvcc = _nvcc()
    ptxas = ["-Xptxas=-v"] if verbose else []
    objs = [obj_dir / f"{p.stem}.o" for p in _sources()]
    compiles = [[nvcc, *ptxas, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", str(p), "-o", str(o)]
                for p, o in zip(_sources(), objs)]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        _run_all(compiles, verbose)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]], verbose)
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def require_cuda(name: str, tensors: dict, dtypes: dict | None = None):
    """The one CUDA device of ``tensors``; raises unless each is a contiguous
    CUDA tensor of its dtype (``dtypes[key]``, float32 by default)."""
    import torch

    dev = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} must be a CUDA tensor, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        dev = t.device
        want = (dtypes or {}).get(key, torch.float32)
        if t.dtype != want:
            raise ValueError(f"{name}: {key} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return dev


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
