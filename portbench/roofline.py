"""Peaks of one H100 and the least work of the port's kernels.

Copied from the port's chip check (``chip_smoke.py``: ``PEAK_*``, ``OPS_*``,
``gj_solve_ops``, ``em_mstep_ops``, ``onehot_mstep_ops``, ``bound`` and the
byte counts of ``kernel_bounds``). A kernel's least time is the larger of
its bytes (each input read once, each output written once) over the
memory's peak and its operations over float32's peak outside the tensor
cores (adds, multiplies, compares, exp and sqrt each one operation), at the
shapes and trip counts of the call it bounds.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet), at a 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Operation counts per unit of work, read off the kernels' code.
OPS_PER_PIXEL = 45         # kernel P: HSV test, deprojection, floors, sums
OPS_PER_PIXEL_CELLS = 33   # kernel P without a leaf: no floors
OPS_SWEEP_PAIR = 9         # squared distance and min, per (node, point)
OPS_ESTEP_PAIR = 30        # both E-step passes and the P1/PX sums, per (node, point)


def gj_solve_ops(m: int) -> int:
    """The least work of kernel G's function for one system: the LU
    factorisation and the inverse (2 m^3), the solve for three right-hand
    sides (2 m^2 3) and three refinement steps (each the residual's m x m x 3
    product as the nine products of bfloat16 pieces, and the correction's
    one product)."""
    return 2 * m ** 3 + 2 * m * m * 3 + 3 * (9 + 1) * 2 * m * m * 3


def em_mstep_ops(m: int) -> int:
    """Kernel E's M-step per iteration: the solve, then T = Y0 + G W as nine
    piece products."""
    return gj_solve_ops(m) + 9 * 2 * m * m * 3


def onehot_mstep_ops(m: int) -> int:
    """Kernel F's M-step: a Gauss-Jordan solve with three right-hand sides
    and no inverse, equilibration or refinement, then T = Y0 + G W."""
    return 2 * m ** 3 // 3 + 2 * m * m * 3 + 2 * m * m * 3


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, what bounds it: "bytes" or "operations")."""
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def grid_cells(h: int, w: int, cell_px: int) -> int:
    """Cells of kernel P's grid for an (h, w) frame: ceil(h / c) ceil(w / c)."""
    return -(-h // cell_px) * -(-w // cell_px)


def cell_sums_bound(frames: int, h: int, w: int, n_cells: int, mode: str = "parity"):
    """Kernel P over ``frames`` (h, w) frames: rgb, depth and mask read (6
    bytes a pixel), the sums written (parity: four arrays of 8 channels;
    votes: seven arrays of one; cells: four of one)."""
    out_words = {"parity": 4 * 8, "votes": 7, "cells": 4}[mode]
    per_px = OPS_PER_PIXEL_CELLS if mode == "cells" else OPS_PER_PIXEL
    return bound(frames * (h * w * 6 + out_words * n_cells * 4), frames * h * w * per_px)


def em_loop_bound(n_rows: int, m: int, n_valid: int, iterations: int):
    """Kernel E's launch: ``iterations`` EM iterations of m nodes over
    ``n_valid`` points (the sweep, both E-step passes and the M-step each
    iteration); the n-row cloud and the node system read, the nodes and
    statistics written."""
    return bound(n_rows * 16 + 3 * m * m * 4 + 6 * m * 12 + 16 + m * 12 + 16,
                 iterations * ((OPS_SWEEP_PAIR + OPS_ESTEP_PAIR) * m * n_valid + em_mstep_ops(m)))
