"""The benchmark's plain reference: the tracker in float64 NumPy.

A frozen copy of the port's oracle (``trackdlo_tpu_torch/oracle``), which
bit-follows the upstream C++ tracker (trackdlo/src/*.cpp) including its
well-defined quirks. It imports nothing of the program, so that a change to
the program cannot move the yardstick. Two edits from the copied code: the
HSV conversion and the edge rasterisation are the NumPy versions on every
machine (the program's kernels follow the capsule rasterisation), and every
matrix product of the EM goes through an ``mm`` argument, ``np.matmul`` by
default, so that the control can lower it to TF32
(:func:`~portbench.reference.pipeline.tf32_matmul`).
"""

from portbench.reference.geometry import (
    line_sphere_intersection,
    pt2pt_dis,
    pt2pt_dis_sq,
    sort_pts,
)
from portbench.reference.lle import calc_lle_weights
from portbench.reference.cpd_lle import cpd_lle, register_cold_start
from portbench.reference.traverse import traverse_euclidean
from portbench.reference.tracking import tracking_step

__all__ = [
    "pt2pt_dis",
    "pt2pt_dis_sq",
    "sort_pts",
    "line_sphere_intersection",
    "calc_lle_weights",
    "cpd_lle",
    "register_cold_start",
    "traverse_euclidean",
    "tracking_step",
]
